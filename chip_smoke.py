#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-H detection paths once on one CUDA card:
serving and the training step, and the two MSDA labs (`tools/`).

    python3 chip_smoke.py [--profile]

Phases (each prints its lines and raises on failure, so the exit code is
nonzero):
  1. device: the card's name and power limit (nvidia-smi), the build of
     the kernel libraries from `uninext_tpu_torch/csrc/` (one nvcc each,
     all started together) and ptxas's registers and spills of the
     tensor-core routes of kernels A and A-bwd and of MSDA and MSDA-bwd;
  2. kernels: each forward kernel (A, MSDA, NMS) against its plain PyTorch
     version on the card at the slice's shapes, in fp32 and bf16 (kernel A:
     bf16 on the tensor cores, fp32 on the CUDA cores), with both times
     (CUDA events), the least time the card could take (bound) and, where
     one exists, one PyTorch library call's time. MSDA on two location
     sets (uniform, and shaped like the model's), also over CUDA graph
     replays, with the L2 volume it moves;
  3. backward kernels: A-bwd and MSDA-bwd against autograd through the
     plain versions at the training shapes, fp32 and bf16 (A-bwd: bf16 on
     the tensor cores, fp32 on the CUDA cores), timed the same way; A-bwd's
     wrapper and its kernels alone also over CUDA graph replays, beside
     the backward of SDPA with a float bias mask at both shapes; MSDA-bwd
     on both location sets and with every sample on level 0 or on level 3
     (whether same-address reductions set its pace);
  3b. labs: the labs' kernels in `csrc/gather_fold.cu` (the fold, TPU
     kernel B of `tools/msda_v6_lab.py`, and the gather probes C0-C2) and
     `csrc/dma_gather.cu` (the DMA probes C3, C4) against their plain
     versions at the tools' shapes, fp32 and bf16, timed over CUDA graph
     replays; then the lab path with its launches counted:
     `tools/msda_v6_lab.py` (parity, and v6 against the port's MSDA kernel
     at the encoder shape in fp32 and bf16), the three probes of
     `tools/gather_probe.py` and the three of `tools/dma_probe.py`;
  4. correctness: a small model with the same weights on the card (kernels)
     and on the CPU (plain versions), fp32: the serving outputs, then one
     train step's losses and every gradient, with its launches counted as
     path "reference" (the path of the fp32 routes of kernels A and A-bwd);
  5. serving: `image_joint_vit_huge()` at full width with random weights
     from a seed, the 80-class COCO prompt encoded once, and 4 requests at
     800x1216 through forward and `postprocess_detection`, with the kernel
     launches of each request counted (kernel A on the tensor-core route
     only);
  6. training: the same config, bs=2 at 800x1216 (one image valid on
     800x1088), synthetic targets, 1 warm-up and 3 timed steps of
     `engine/train.py:train_step` (forward, losses, backward, clip, AdamW),
     with losses, grad norm, step time, peak memory and per-step launches.
     `--profile` adds one profiled request and one profiled step and prints
     their device time by kernel and the device's idle share.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Exits nonzero and prints no
result without a CUDA device or outside a checkout of the repository.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGE_HW = (800, 1216)
N_REQUESTS = 4
TRAIN_BATCH = 2
TRAIN_STEPS = 3
# NVIDIA H100 SXM data sheet, dense, at 700 W: the bound of a kernel is the
# larger of its bytes over HBM_BPS and its operations over the peak of
# their type (bf16 tensor cores for the attention products, fp32 CUDA
# cores for MSDA's and NMS's arithmetic)
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


def _timed(fn, iters, warmup=2):
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    from uninext_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()              # one nvcc per source, all at once
    for name in _build.KERNELS:
        _build.library(name)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {len(_build.KERNELS)} kernel libraries "
          f"built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("rel_pos_flash_attn_mma", "rel_pos_flash_attn_bwd_mma", "ms_deform_attn"):
        _print_ptxas(_build.build_log(name))
    return smi.stdout.strip().splitlines()[0]


def _print_ptxas(log):
    """One line per kernel that ptxas -v reported: its stack frame, spills,
    registers and static shared memory (the log is empty when the library
    was built by an earlier run without its log)."""
    entry, spill = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            print(f"[ptxas] {entry}: {spill}; {line.split(':', 1)[1].strip()}")
            entry = None


def _check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def _check_rel(name, got, want, tol):
    """max |got - want| <= tol x max |want|. Returns (absolute error, the
    error over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-6)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs error {err} > {tol} x {scale}")
    return err, err / scale


def _bound(nbytes, ops, kind):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the peak of their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_inputs(dev, g, B, h, w, nh=16, hd=80):
    """qkv (B, S, 3, nh, hd) and rel-pos tables Rh, Rw, fp32."""
    import torch
    base = torch.randn(B, h * w, 3, nh, hd, device=dev, generator=g)
    rh = 0.1 * torch.randn(h, h, hd, device=dev, generator=g)
    rw = 0.1 * torch.randn(w, w, hd, device=dev, generator=g)
    return base, rh, rw


def _sdpa_args(q5, k, v, rh, rw):
    """SDPA's layout of the same attention: q, k, v (B, nh, S, hd) and the
    rel-pos bias as a float mask (B, nh, S, S), built outside the call."""
    import torch
    B, H, W, nh, hd = q5.shape
    S = H * W
    qf = q5.float()
    bh = torch.einsum("byxhd,yid->bhyxi", qf, rh.float())
    bw = torch.einsum("byxhd,xjd->bhyxj", qf, rw.float())
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(B, nh, S, S).to(q5.dtype)
    t = lambda x: x.reshape(B, S, nh, hd).transpose(1, 2)
    return t(q5), t(k), t(v), bias


def _msda_shapes():
    shapes = tuple((IMAGE_HW[0] // s, IMAGE_HW[1] // s) for s in (8, 16, 32))
    return shapes + (((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2),)


def _msda_model_set(g, B, Lq, shapes, M, P, encoder):
    """Locations and weights shaped like the model's: reference points at
    the pixel centres of every level (encoder; the decoder's are uniform in
    (0, 1)), plus the init offsets of `models/layers.py:sampling_offsets_bias`
    over each level's size, plus N(0, 0.5 px) noise; softmaxed weights."""
    import torch
    from uninext_tpu_torch.models.layers import sampling_offsets_bias
    dev = g.device
    L = len(shapes)
    if encoder:
        ref = []
        for h, w in shapes:
            ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                    indexing="ij")
            ref.append(torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1).reshape(-1, 2))
        ref = torch.cat(ref)[None].expand(B, Lq, 2)
    else:
        ref = torch.rand(B, Lq, 2, device=dev, generator=g)
    size = torch.tensor([[w, h] for h, w in shapes], device=dev, dtype=torch.float32)
    off = sampling_offsets_bias(M, L, P).to(dev).reshape(M, L, P, 2)
    noise = 0.5 * torch.randn(B, Lq, M, L, P, 2, device=dev, generator=g)
    loc = ref[:, :, None, None, None] + (off + noise) / size[:, None]
    att = torch.randn(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
    return loc.contiguous(), att.reshape(B, Lq, M, L, P)


def _off_centres(loc, shapes, margin=1e-3):
    """`loc` moved at least `margin` pixels off every pixel centre, the kink
    of bilinear sampling where the gradient w.r.t. the location depends on
    rounding (grid_sample rescales through [-1, 1], the kernels do not)."""
    import torch
    out = loc.clone()
    for lvl, (h, w) in enumerate(shapes):
        size = torch.tensor([w, h], device=loc.device, dtype=torch.float64)
        px = loc[:, :, :, lvl].double() * size - 0.5
        frac = px - px.floor()
        px = torch.where(frac < margin, px + margin,
                         torch.where(frac > 1 - margin, px - margin, px))
        out[:, :, :, lvl] = ((px + 0.5) / size).float()
    return out


def _msda_corner_rows(shapes, loc):
    """In-frame bilinear corners of these locations: the value rows the
    forward gathers and the backward gathers and reduces into, with each
    sample's `in_range` as in the kernels."""
    import torch
    rows = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0].double() * w - 0.5
        y = loc[:, :, :, lvl, :, 1].double() * h - 0.5
        x0, y0 = x.floor(), y.floor()
        inr = (x >= -1) & (x < w) & (y >= -1) & (y < h)
        for cx in (x0, x0 + 1):
            for cy in (y0, y0 + 1):
                rows += int((inr & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).sum())
    return rows


def phase_kernels():
    """Each forward kernel vs its plain version at the slice's shapes.
    Returns the per-kernel record (bf16 = the compute dtype) for the JSON
    line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda, nms
    from uninext_tpu_torch.tools import event_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # fp32: only the order of fp32 sums differs. bf16: both read the same
    # bf16 inputs and compute in fp32; outputs may differ by one bf16
    # rounding (1 ulp at |x| < 8 is 3.1e-2).
    tol = {torch.float32: 5e-5, torch.bfloat16: 3.2e-2}
    rec = {}

    # kernel A: global blocks (1, 50x76 grid) and windowed blocks (24 windows
    # of 14x14); bf16 on the tensor cores ("rel_pos_flash_attn"), fp32 on the
    # CUDA cores ("rel_pos_flash_attn_fp32"). Each dtype must take its own
    # route. The tensor-core kernel also rounds P to bf16 before P.V (2^-9
    # of each term of a weighted mean), far below the output's rounding.
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    routes = {torch.bfloat16: ("rel_pos_flash_attn", vit.rel_pos_flash_attn_mma),
              torch.float32: ("rel_pos_flash_attn_fp32", vit.rel_pos_flash_attn_fp32)}
    for label, (B, h, w) in (("global", (1, H, W)), ("window", (24, 14, 14))):
        nh, hd = 16, 80
        S = h * w
        base, rh, rw = _attention_inputs(dev, g, B, h, w, nh, hd)
        for dt in (torch.float32, torch.bfloat16):
            name, route = routes[dt]
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(B, h, w, nh, hd)
            args = (q5, k, v, rh.to(dt), rw.to(dt), hd ** -0.5)
            before = {n: r.launches for n, r in routes.values()}
            got = vit.flash_rel_pos_attention(*args)
            moved = {n: r.launches - before[n] for n, r in routes.values()}
            if moved != {n: int(n == name) for n in moved}:
                raise AssertionError(f"kernel A {label} {dt}: launches by route {moved}")
            want = vit.rel_pos_attention_plain(*args)
            err = _check(f"{name} {label} {dt}", got, want, tol[dt])
            ms = _timed(lambda: vit.flash_rel_pos_attention(*args),
                        20 if dt == torch.bfloat16 else 5)
            pms = _timed(lambda: vit.rel_pos_attention_plain(*args), 3)
            del got, want
            e = 2 if dt == torch.bfloat16 else 4
            b_ms, b_by = _bound(
                e * (4 * B * S * nh * hd + h * h * hd + w * w * hd),
                B * nh * (4 * S * S * hd + 2 * S * (h + w) * hd),
                "bf16" if dt == torch.bfloat16 else "fp32")
            sq, sk, sv, bias = _sdpa_args(q5, k, v, rh.to(dt), rw.to(dt))
            lib = _timed(lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias),
                         20 if dt == torch.bfloat16 else 5)
            del sq, sk, sv, bias
            if dt == torch.bfloat16:
                # the wrapper's library part alone, over CUDA graph replays
                bias_ms = event_ms(lambda: vit.rel_pos_bias(q5, rh.to(dt), rw.to(dt)))
                print(f"[kernel A] {name} {label}: of the wrapper, the bias products "
                      f"bh = q.Rh, bw = q.Rw (rel_pos_bias, CUDA graph replays) "
                      f"{bias_ms:.4f} ms")
            print(f"[kernel A] {name} {label} B={B} {h}x{w} nh={nh} hd={hd} "
                  f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) wrapper "
                  f"(bias products and kernel) {ms:.4f} ms ({100 * b_ms / ms:.1f}% of "
                  f"its bound {b_ms:.4f} ms, "
                  f"{b_by}), plain {pms:.3f} ms; library scaled_dot_product_attention "
                  f"with a float bias mask built outside the timing: {lib:.4f} ms")
            r = rec.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label == "global":
                r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         shape=f"global B={B} {h}x{w} {str(dt)[6:]}")
            else:
                r.update(window_ms=ms, window_library_ms=lib, window_bound_ms=b_ms)
            torch.cuda.empty_cache()
    a = rec["rel_pos_flash_attn"]
    print(f"[kernel A] tensor-core route, global block: {a['ms']:.4f} ms against SDPA's "
          f"{a['library_ms']:.4f} ms in this run")

    # MSDA: encoder (Lq = S = 20197) and decoder (Lq = 900) calls, on two
    # location sets: uniform in [-0.1, 1.1] (the set of the first timings) and
    # shaped like the model's (`_msda_model_set`, its own generator)
    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    value32 = torch.randn(1, S, M, D, device=dev, generator=g)
    gm = torch.Generator(device=dev).manual_seed(10)
    r = rec["ms_deform_attn_fwd"] = {"max_abs_err": 0.0}
    for label, Lq in (("encoder", S), ("decoder", 900)):
        loc = torch.rand(1, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att = torch.rand(1, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att = att.reshape(1, Lq, M, L, P)
        sets = {"uniform": (loc, att),
                "model": _msda_model_set(gm, 1, Lq, shapes, M, P, label == "encoder")}
        for set_name, (loc, att) in sets.items():
            for dt in (torch.float32, torch.bfloat16):
                args = (value32.to(dt), shapes, loc, att)
                got = msda.ms_deform_attn(*args)
                want = msda.ms_deform_attn_plain(*args)
                err = _check(f"ms_deform_attn {label} {set_name} {dt}", got, want, tol[dt])
                ms = _timed(lambda: msda.ms_deform_attn(*args), 20)
                gms = event_ms(lambda: msda.ms_deform_attn(*args), 20)
                pms = _timed(lambda: msda.ms_deform_attn_plain(*args), 5)
                rows = _msda_corner_rows(shapes, loc)
                vol = rows * D * value32.new_empty((), dtype=dt).element_size()
                print(f"[MSDA] ms_deform_attn {label} {set_name} Lq={Lq} S={S} M={M} D={D} "
                      f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) kernel "
                      f"{ms:.4f} ms (CUDA graph replays {gms:.4f} ms), plain {pms:.3f} ms; "
                      f"L2 volume {rows} corner rows x {vol // rows} B = {vol / 1e6:.1f} MB, "
                      f"{vol / gms / 1e9:.2f} TB/s")
                if dt != torch.bfloat16:
                    continue
                r["max_abs_err"] = max(r["max_abs_err"], err)
                key = {"encoder": "", "decoder": "decoder_"}[label] + (
                    "" if set_name == "uniform" else "model_")
                r.update({key + "ms": ms, key + "graph_ms": gms, key + "plain_ms": pms})
                if label == "encoder" and set_name == "uniform":
                    n = Lq * M * L * P
                    b_ms, b_by = _bound(2 * S * M * D + 4 * 3 * n + 2 * Lq * M * D,
                                        n * 10 * D, "fp32")
                    r.update(plain_ms=pms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"encoder B=1 Lq={Lq} bf16, uniform locations")
                    print(f"[MSDA] bound {b_ms:.4f} ms ({b_by}); no single PyTorch call "
                          f"computes MSDA")
    torch.cuda.empty_cache()

    # NMS: 900 boxes in 4 classes around 40 centres (many overlaps), exact
    N = 900
    centers = torch.rand(1, 40, 2, device=dev, generator=g) * 0.6 + 0.2
    pick = torch.randint(0, 40, (1, N), device=dev, generator=g)
    cxcy = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    cxcy = cxcy + 0.01 * torch.randn(1, N, 2, device=dev, generator=g)
    wh = torch.rand(1, N, 2, device=dev, generator=g) * 0.1 + 0.1
    boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], -1)
    scores = torch.rand(1, N, device=dev, generator=g)
    classes = torch.randint(0, 4, (1, N), device=dev, generator=g)
    args = (boxes, scores, classes, 0.7)
    got = nms.batched_nms(*args)
    want = nms.batched_nms_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError("batched_nms: keep mask differs from the plain version")
    kept = int(got.sum())
    ms = _timed(lambda: nms.batched_nms(*args), 20)
    pms = _timed(lambda: nms.batched_nms_plain(*args), 2, warmup=1)
    counts = torch.bincount(classes[0], minlength=4).double()
    pairs = float((counts * (counts - 1) / 2).sum())    # same-class pairs
    b_ms, b_by = _bound(N * (16 + 4 + 8 + 1), pairs * 12, "fp32")
    print(f"[NMS] batched_nms N={N}: keep masks identical ({kept} kept), "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"no PyTorch call computes NMS (torchvision is absent)")
    rec["nms"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms, "library_ms": None,
                  "bound_ms": b_ms, "bound_by": b_by, "shape": f"N={N}"}
    return rec


def _bwd_kernels_alone(q5, k, v, rh, rw, scale, out, lse, cot):
    """A closure that launches A-bwd's kernels of q5's dtype alone, on
    inputs prepared once as the wrapper prepares them (the bias tables, dO
    rows, Dq, the outputs), so that its timing holds no bias products, Dq
    or chain rule."""
    import torch
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import _build
    B, H, W, nh, hd = q5.shape
    S = H * W
    bf16 = q5.dtype == torch.bfloat16
    name = "rel_pos_flash_attn_bwd_mma" if bf16 else "rel_pos_flash_attn_bwd"
    q3 = q5.reshape(B, S, nh, hd)
    bh, bw = vit.rel_pos_bias(q5, rh, rw)
    dout4, dsum = vit._bwd_inputs(q5, out, cot)
    dq = torch.empty(B, S, nh, hd, dtype=torch.float32, device=q5.device)
    dk = torch.empty(B, S, nh, hd, dtype=q5.dtype, device=q5.device)
    dv = torch.empty(B, S, nh, hd, dtype=q5.dtype, device=q5.device)
    dbh, dbw = vit._bias_grad_buffers(bh, bw)
    tensors = (q3, k, v, dout4, lse, dsum, bh, bw, dq, dk, dv, dbh, dbw)
    args = (*(t.data_ptr() for t in tensors), B, H, W, nh, hd, *q3.stride()[:3],
            *(dout4.stride()[:3] if bf16 else ()), vit._strides(bh), vit._strides(bw),
            float(scale))
    fn, lib = vit._entry(name), _build.library(name)

    def run():
        _build.check(lib, fn(*args, _build.stream_of(q5)), name)
    run.tensors = tensors          # alive as long as the closure
    return run


def phase_backward_kernels():
    """A-bwd and MSDA-bwd vs autograd through the plain versions at the
    training shapes (bs=2). Returns their records for the JSON line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda
    from uninext_tpu_torch.tools import event_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # relative to each gradient's largest entry. fp32: summation order (MSDA-
    # bwd adds dvalue with fp32 atomics, in an order that changes between runs).
    # bf16: each side rounds its gradients to bf16 once (2^-8 = 3.9e-3 of
    # the value) after fp32 sums of other orders; A-bwd's tensor-core
    # kernels also round P and dS to bf16 before the products that read
    # them, as the Pallas backward does.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
    rec = {}
    B = TRAIN_BATCH
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    nh, hd = 16, 80
    windows = B * (-(-H // 14)) * (-(-W // 14))
    # A-bwd: bf16 on the tensor cores ("rel_pos_flash_attn_bwd"), fp32 on
    # the CUDA cores ("rel_pos_flash_attn_bwd_fp32"); each dtype must take
    # its own route
    routes = {torch.bfloat16: ("rel_pos_flash_attn_bwd", vit.rel_pos_flash_attn_bwd_mma),
              torch.float32: ("rel_pos_flash_attn_bwd_fp32", vit.rel_pos_flash_attn_bwd_fp32)}
    for label, (Bw, h, w) in (("global", (B, H, W)), ("window", (windows, 14, 14))):
        base, rh0, rw0 = _attention_inputs(dev, g, Bw, h, w, nh, hd)
        S = h * w
        for dt in (torch.float32, torch.bfloat16):
            name, _ = routes[dt]
            bf16 = dt == torch.bfloat16
            cot = torch.randn(Bw, h, w, nh * hd, device=dev, generator=g).to(dt)
            grads, graphs = [], []
            for fn in (vit.flash_rel_pos_attention, vit.rel_pos_attention_plain):
                qkv = base.to(dt).requires_grad_()
                rh, rw = rh0.to(dt).requires_grad_(), rw0.to(dt).requires_grad_()
                q, k, v = qkv.unbind(2)
                out = fn(q.reshape(Bw, h, w, nh, hd), k, v, rh, rw, hd ** -0.5)
                before = {n: r.launches for n, r in routes.values()}
                grads.append(torch.autograd.grad(out, (qkv, rh, rw), cot,
                                                 retain_graph=True))
                moved = {n: r.launches - before[n] for n, r in routes.values()}
                if fn is vit.flash_rel_pos_attention and moved != {
                        n: int(n == name) for n in moved}:
                    raise AssertionError(f"kernel A-bwd {label} {dt}: launches by route {moved}")
                graphs.append((out, (qkv, rh, rw)))
            errs, rels = zip(*(
                _check_rel(f"{name} {label} {dt} {n}", a, b, tol[dt])
                for n, a, b in zip(("dqkv", "dRh", "dRw"), *grads)))
            # the kernel's function: the saved forward (out, lse) -> gradients;
            # the wrapper and the kernels alone over CUDA graph replays
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(Bw, h, w, nh, hd)
            fargs = (q5, k, v, rh0.to(dt), rw0.to(dt), hd ** -0.5)
            out, lse = vit.rel_pos_flash_attn_fwd(*fargs, with_lse=True)
            iters = 10 if bf16 else 2
            ms = event_ms(lambda: vit.rel_pos_flash_attn_bwd(*fargs, out, lse, cot), iters,
                          warmup=1)
            kms = event_ms(_bwd_kernels_alone(*fargs, out, lse, cot), iters, warmup=1)
            pout, pin = graphs[1]
            pms = _timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True),
                         3, warmup=1)
            del graphs, grads, pout, pin
            # library: the backward of SDPA with the bias as a float mask
            # (dq, dk, dv, dbias), the mask built outside the timing
            sq, sk, sv, bias = _sdpa_args(q5, k, v, rh0.to(dt), rw0.to(dt))
            leaves = [x.detach().requires_grad_() for x in (sq, sk, sv, bias)]
            lout = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
            lcot = cot.reshape(Bw, S, nh, hd).transpose(1, 2)
            lib = _timed(lambda: torch.autograd.grad(lout, leaves, lcot, retain_graph=True),
                         10 if bf16 else 3)
            del lout, leaves, bias, sq, sk, sv
            e = 2 if bf16 else 4
            b_ms, b_by = _bound(
                e * 8 * Bw * S * nh * hd + 4 * Bw * nh * S
                + 2 * e * (h * h * hd + w * w * hd),
                Bw * nh * (10 * S * S * hd + 6 * S * (h + w) * hd),
                "bf16" if bf16 else "fp32")
            print(f"[kernel A-bwd] {name} {label} B={Bw} {h}x{w} nh={nh} hd={hd} "
                  f"{str(dt)[6:]}: max_abs_err dqkv/dRh/dRw = "
                  + "/".join(f"{e:.3g}" for e in errs) + ", / max |grad| = "
                  + "/".join(f"{e:.3g}" for e in rels)
                  + f" (tol {tol[dt]}); CUDA graph replays: wrapper (bias products, Dq, "
                  f"kernels, chain rule) {ms:.4f} ms, kernels alone {kms:.4f} ms "
                  f"({100 * b_ms / kms:.1f}% of the bound {b_ms:.4f} ms, {b_by}); plain "
                  f"backward {pms:.3f} ms; library: backward of scaled_dot_product_attention "
                  f"with a float bias mask (dq, dk, dv, dbias) {lib:.4f} ms")
            r = rec.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            r["max_rel_err"] = max(r["max_rel_err"], *rels)
            if label == "global":
                r.update(ms=ms, kernel_ms=kms, plain_ms=pms, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, shape=f"global B={Bw} {h}x{w} {str(dt)[6:]}")
            else:
                r.update(window_ms=ms, window_kernel_ms=kms, window_plain_ms=pms,
                         window_library_ms=lib, window_bound_ms=b_ms)
            torch.cuda.empty_cache()
    a = rec["rel_pos_flash_attn_bwd"]
    print(f"[kernel A-bwd] tensor-core route at bs={B}: global block wrapper {a['ms']:.4f} "
          f"ms, kernels {a['kernel_ms']:.4f} ms against SDPA's backward "
          f"{a['library_ms']:.4f} ms; window blocks wrapper {a['window_ms']:.4f} ms, kernels "
          f"{a['window_kernel_ms']:.4f} ms against {a['window_library_ms']:.4f} ms, in this run")

    # MSDA-bwd on the two location sets of phase_kernels, then the
    # contention diagnostic: every sample on one level of 15200 or 247 pixels
    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    gm = torch.Generator(device=dev).manual_seed(11)
    r = rec["ms_deform_attn_bwd"] = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, Lq in (("encoder", S), ("decoder", 900)):
        value0 = torch.randn(B, S, M, D, device=dev, generator=g)
        loc0 = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att0 = torch.rand(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att0 = att0.reshape(B, Lq, M, L, P)
        cots = {dt: torch.randn(B, Lq, M * D, device=dev, generator=g).to(dt)
                for dt in (torch.float32, torch.bfloat16)}
        sets = {"uniform": (loc0, att0),
                "model": _msda_model_set(gm, B, Lq, shapes, M, P, label == "encoder")}
        for set_name, (loc0, att0) in sets.items():
            for dt in (torch.float32, torch.bfloat16):
                cot = cots[dt]
                errs, rels, pms = _msda_bwd_check(
                    f"{label} {set_name} {dt}", value0.to(dt), shapes, loc0, att0, cot, tol[dt])
                fargs = (value0.to(dt), shapes, loc0, att0)
                ms = _timed(lambda: msda.ms_deform_attn_bwd(*fargs, cot), 10)
                gms = event_ms(lambda: msda.ms_deform_attn_bwd(*fargs, cot), 10)
                rows = _msda_corner_rows(shapes, loc0)
                e = value0.new_empty((), dtype=dt).element_size()
                vol = rows * D * (e + 4)
                print(f"[MSDA-bwd] ms_deform_attn_bwd {label} {set_name} B={B} Lq={Lq} "
                      f"S={S} {str(dt)[6:]}: max_abs_err dvalue/dloc/datt = "
                      + "/".join(f"{x:.3g}" for x in errs) + ", / max |grad| = "
                      + "/".join(f"{x:.3g}" for x in rels)
                      + f" (tol {tol[dt]}) kernel {ms:.4f} ms (CUDA graph replays "
                      f"{gms:.4f} ms), plain backward {pms:.3f} ms; L2 volume {rows} "
                      f"corner rows x ({D * e} B read + {D * 4} B reduced) = "
                      f"{vol / 1e6:.1f} MB, {vol / gms / 1e9:.2f} TB/s")
                if dt != torch.bfloat16:
                    continue
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                r["max_rel_err"] = max(r["max_rel_err"], *rels)
                key = {"encoder": "", "decoder": "decoder_"}[label] + (
                    "" if set_name == "uniform" else "model_")
                r.update({key + "ms": ms, key + "graph_ms": gms, key + "plain_ms": pms})
                if label == "encoder" and set_name == "uniform":
                    n = B * Lq * M * L * P
                    # value read + dvalue written (bf16), loc/att read and
                    # dloc/datt written (fp32), dout read once (bf16)
                    b_ms, b_by = _bound(2 * 2 * B * S * M * D + 2 * 4 * 3 * n
                                        + 2 * B * Lq * M * D, n * (16 * D + 20), "fp32")
                    r.update(plain_ms=pms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"encoder B={B} Lq={Lq} bf16, uniform locations")
                    print(f"[MSDA-bwd] bound {b_ms:.4f} ms ({b_by}); no single PyTorch "
                          f"call computes MSDA's gradients")
        torch.cuda.empty_cache()
    # diagnostic: the encoder's work (B x 20197 queries x 8 heads x 16
    # samples, bf16), every sample on one level: level 0 (100 x 152) spreads
    # the dvalue reductions over 15200 pixels, level 3 (13 x 19) stacks them
    # on 247, about 1300 on each address at bs=2
    for lvl in (0, 3):
        h, w = shapes[lvl]
        one = ((h, w),)
        value = torch.randn(B, h * w, M, D, device=dev, generator=gm).to(torch.bfloat16)
        loc = _off_centres(torch.rand(B, S, M, 1, L * P, 2, device=dev, generator=gm), one)
        att = torch.rand(B, S, M, 1, L * P, device=dev, generator=gm).softmax(-1)
        cot = torch.randn(B, S, M * D, device=dev, generator=gm).to(torch.bfloat16)
        errs, rels, _ = _msda_bwd_check(f"level {lvl} only bf16", value, one, loc, att, cot,
                                           tol[torch.bfloat16], plain_ms=False)
        fms = event_ms(lambda: msda.ms_deform_attn(value, one, loc, att), 10)
        gms = event_ms(lambda: msda.ms_deform_attn_bwd(value, one, loc, att, cot), 10)
        r[f"level{lvl}_graph_ms"] = gms
        print(f"[MSDA-bwd] diagnostic, every sample on level {lvl} ({h}x{w}, {h * w} px), "
              f"B={B} Lq={S} bf16: backward {gms:.4f} ms, forward {fms:.4f} ms (CUDA graph "
              f"replays); max_abs_err dvalue/dloc/datt = "
              + "/".join(f"{x:.3g}" for x in errs) + ", / max |grad| = "
              + "/".join(f"{x:.3g}" for x in rels))
    return rec


def _msda_bwd_check(what, value0, shapes, loc0, att0, cot, tol, plain_ms=True):
    """MSDA-bwd against autograd through the plain version. Returns the
    absolute and relative errors of (dvalue, dloc, datt) and the plain
    backward's ms (None unless `plain_ms`)."""
    import torch
    from uninext_tpu_torch.ops import msda
    grads, graphs = [], []
    for fn in (msda.ms_deform_attn, msda.ms_deform_attn_plain):
        value = value0.detach().requires_grad_()
        loc, att = loc0.clone().requires_grad_(), att0.clone().requires_grad_()
        out = fn(value, shapes, loc, att)
        grads.append(torch.autograd.grad(out, (value, loc, att), cot, retain_graph=True))
        graphs.append((out, (value, loc, att)))
    errs, rels = zip(*(_check_rel(f"ms_deform_attn_bwd {what} {n}", a, b, tol)
                       for n, a, b in zip(("dvalue", "dloc", "datt"), *grads)))
    pout, pin = graphs[1]
    pms = (_timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True), 3)
           if plain_ms else None)
    return errs, rels, pms


def _bag_index(rows, S, device):
    """embedding_bag's index of the same sum over a table viewed as
    (rows * 4, D): bag i holds rows[i, s] * 4 + c for s < S, c < 4."""
    import torch
    c = torch.arange(4, device=device)
    return (rows.long()[..., None] * 4 + c).reshape(-1, S * 4)


def _library_bag(table, bags, weights):
    """ms of one `F.embedding_bag(mode="sum")` over `table` (rows of D),
    with per-sample weights (cast to the table's dtype) where given."""
    import torch.nn.functional as F
    from uninext_tpu_torch.tools import event_ms
    if weights is not None:
        weights = weights.to(table.dtype)
    return event_ms(lambda: F.embedding_bag(bags, table, per_sample_weights=weights,
                                            mode="sum"), 20)


def phase_labs():
    """The labs' kernels vs their plain versions at the tools' shapes (fp32
    and bf16), then the lab path with its launches counted. Returns the
    kernels' records (bf16 times) and the lab path's launches. Times are
    CUDA graph replays (`tools.event_ms`): the probes' kernels run for less
    time than the host takes to launch them."""
    import torch
    from uninext_tpu_torch.ops import gather_fold as gf
    from uninext_tpu_torch.tools import dma_probe, event_ms, gather_probe, msda_v6_lab as lab
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    # both versions return fp32 from the same inputs: only the order of fp32
    # sums (and fused multiply-adds) of at most 64 terms below 10 differs
    tol = 5e-5
    rec = {}

    # kernel B at the lab's encoder shape: L*P = 16 rows of 4D per column,
    # B*M*Lq_pad = 163840 columns
    S_lp, D = lab.L * lab.P, lab.D
    N = lab.pad_q_fused(lab.B, lab.M, lab.LQ)[2]
    rows32 = torch.randn(S_lp, N, 4 * D, device=dev, generator=g)
    w32 = torch.rand(S_lp, N, 4, device=dev, generator=g)
    r = rec["msda_fold"] = {"max_abs_err": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        rows, w = rows32.to(dt), w32.to(dt)
        err = _check(f"msda_fold {dt}", gf.msda_fold(rows, w), gf.msda_fold_plain(rows, w), tol)
        ms = event_ms(lambda: gf.msda_fold(rows, w), 20)
        pms = event_ms(lambda: gf.msda_fold_plain(rows, w), 5)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        print(f"[lab B] msda_fold S={S_lp} N={N} D={D} {str(dt)[6:]}: max_abs_err="
              f"{err:.3g} (tol {tol}) kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # rows and w are bf16 here, as msda_v6 makes them
    n_idx = (torch.arange(S_lp, device=dev)[None] * N
             + torch.arange(N, device=dev)[:, None])             # (N, S): row s*N + n
    bags = _bag_index(n_idx, S_lp, dev)
    lib = _library_bag(rows.view(-1, D), bags, w.permute(1, 0, 2).reshape(N, S_lp * 4))
    del n_idx, bags
    b_ms, b_by = _bound(rows.numel() * 2 + w.numel() * 2 + N * D * 4,
                        2 * S_lp * 4 * D * N, "fp32")
    r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
             shape=f"S={S_lp} N={N} D={D} bf16")
    print(f"[lab B] bound {b_ms:.4f} ms ({b_by}); library embedding_bag(sum, "
          f"per_sample_weights) in bf16: {lib:.4f} ms")
    del rows32, w32, rows, w
    torch.cuda.empty_cache()

    # kernels C0-C2 at the probes' shapes (bf16 tables, as the probes)
    probes = (("gather_rowsum_scalar", "C0", gf.gather_rowsum_scalar, gather_probe.R),
              ("gather_rowsum_vec", "C1", gf.gather_rowsum_vec, gather_probe.R),
              ("gather_weighted", "C2", gf.gather_weighted, gather_probe.R_ONEHOT))
    for name, tag, fn, R in probes:
        weighted = fn is gf.gather_weighted
        buf16, idx, *w = gather_probe.probe_inputs(r=R, weighted=weighted, device=dev)
        plain = gf.gather_weighted_plain if weighted else gf.gather_rowsum_plain
        r = rec[name] = {"max_abs_err": 0.0}
        M, TQ, SAMP = idx.shape
        for dt in (torch.float32, torch.bfloat16):
            args = (buf16.to(dt), idx, *w)
            err = _check(f"{name} {dt}", fn(*args), plain(*args), tol)
            ms = event_ms(lambda: fn(*args), 50)
            pms = event_ms(lambda: plain(*args), 10)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            print(f"[lab {tag}] {name} R={R} M={M} TQ={TQ} SAMP={SAMP} D={D} "
                  f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol}) kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms")
        bags = _bag_index(idx.view(M * TQ, SAMP), SAMP, dev)
        lib = _library_bag(buf16.view(-1, D), bags,
                           w[0].view(M * TQ, SAMP * 4) if weighted else None)
        nbytes = (buf16.numel() * 2 + idx.numel() * 4 + M * TQ * D * 4
                  + (w[0].numel() * 4 if weighted else 0))
        b_ms, b_by = _bound(nbytes, (2 if weighted else 1) * idx.numel() * 4 * D, "fp32")
        r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=f"R={R} M={M} TQ={TQ} SAMP={SAMP} D={D} bf16")
        print(f"[lab {tag}] bound {b_ms:.5f} ms ({b_by}); library embedding_bag(sum"
              f"{', per_sample_weights' if weighted else ''}) in bf16: {lib:.4f} ms")

    # kernels C3 and C4 at the DMA probe's shapes (bf16 tables, as the probes)
    _check_dma_kernels(rec, dev, tol)

    # the lab path: the three tools as a user runs them, launches counted
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    lab.parity()
    v6 = {dt: lab.bench(dt) for dt in (torch.float32, torch.bfloat16)}
    outs = {k: f()[0] for k, f in gather_probe.PROBES.items()}
    dma = {k: f() for k, f in dma_probe.PROBES.items()}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for k, o in outs.items():
        if o.shape != (gather_probe.M_STEPS, gather_probe.TQ, D) or not torch.isfinite(o).all():
            raise AssertionError(f"probe {k}: {tuple(o.shape)} or non-finite values")
    n_idx = dma_probe.TILES * dma_probe.K
    for k, (o, _) in dma.items():
        rows = n_idx * 8 if k == "3" else dma_probe.TILES * 8
        if o.shape != (rows, dma_probe.D4) or not torch.isfinite(o).all():
            raise AssertionError(f"dma probe {k}: {tuple(o.shape)} or non-finite values")
    print(f"[lab] dma probes: probe 1 (C3) {dma['1'][1]:.4f} ms, "
          f"{n_idx / dma['1'][1] / 1e3:.0f} rows/us; probe 2 (C3, L2 evict_last) "
          f"{dma['2'][1]:.4f} ms, {n_idx / dma['2'][1] / 1e3:.0f} rows/us; probe 3 (C4) "
          f"{dma['3'][1]:.4f} ms, {n_idx / dma['3'][1] / 1e3:.0f} blocks/us")
    del dma
    # fp32: the lab's tolerance. bf16: v6 rounds the corner weights to bf16
    # (2^-9 of each term) and both round their outputs to bf16 (|out| < 8:
    # 3.2e-2)
    for dt, t in ((torch.float32, 1e-4), (torch.bfloat16, 6.3e-2)):
        if not v6[dt]["max_abs_err"] <= t:
            raise AssertionError(f"msda_v6 vs MSDA kernel {dt}: {v6[dt]['max_abs_err']} > {t}")
    print(f"[lab] msda_v6 (index_select + kernel B) vs the port's MSDA kernel at the "
          f"encoder shape: fp32 max_abs_err {v6[torch.float32]['max_abs_err']:.3g} "
          f"(tol 1e-4), MSDA {v6[torch.float32]['msda_ms']:.3f} ms, v6 "
          f"{v6[torch.float32]['v6_ms']:.3f} ms; bf16 max_abs_err "
          f"{v6[torch.bfloat16]['max_abs_err']:.3g} (tol 6.3e-2), MSDA "
          f"{v6[torch.bfloat16]['msda_ms']:.3f} ms, v6 {v6[torch.bfloat16]['v6_ms']:.3f} ms")
    print(f"[lab] kernel launches on the lab path: {launches}")
    torch.cuda.empty_cache()
    return rec, launches


def _check_dma_kernels(rec, dev, tol):
    """C3 (both cache policies) and C4 vs their plain versions at the DMA
    probe's shapes, fp32 and bf16 tables, with their times (CUDA graph
    replays), bounds and library calls, into `rec`."""
    import functools

    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.ops import dma_gather as dg
    from uninext_tpu_torch.tools import dma_probe, event_ms
    K, D4 = dma_probe.K, dma_probe.D4
    # C3: fp32 sums of 32 terms below 5 in two orders; C4 copies exactly
    cases = (("dma_gather_rowsum", "C3", False, tol, dg.dma_gather_rowsum_plain,
              {"": dg.dma_gather_rowsum,
               " evict_last": functools.partial(dg.dma_gather_rowsum, l2_resident=True)}),
             ("dma_block_gather", "C4", True, 0.0, dg.dma_block_gather_plain,
              {"": dg.dma_block_gather}))
    for name, tag, blocks, t, plain, variants in cases:
        buf16, idx = dma_probe.probe_inputs(blocks=blocks, device=dev)
        r = rec[name] = {"max_abs_err": 0.0}
        for dt in (torch.float32, torch.bfloat16):
            buf = buf16.to(dt)
            want = plain(buf, idx)
            for label, fn in variants.items():
                err = _check(f"{name}{label} {dt}", fn(buf, idx), want, t)
                r["max_abs_err"] = max(r["max_abs_err"], err)
                ms = event_ms(lambda: fn(buf, idx), 10)
                print(f"[lab {tag}] {name}{label} R={buf.shape[0]} D4={D4} "
                      f"{idx.numel()} indices {str(dt)[6:]}: max_abs_err={err:.3g} "
                      f"(tol {t}) kernel {ms:.4f} ms")
                if not label:
                    kernel_ms = ms
            del want
            pms = event_ms(lambda: plain(buf, idx), 5)
            print(f"[lab {tag}] {name} plain {str(dt)[6:]}: {pms:.4f} ms")
        out_numel = (idx.numel() * 8 if blocks else idx.numel() // K * 8) * D4
        b_ms, b_by = _bound(buf16.numel() * 2 + idx.numel() * 4 + out_numel * 4,
                            out_numel if blocks else idx.numel() * D4, "fp32")
        if blocks:
            # the table as 1963 blocks of 8 rows, cast to fp32 once (untimed)
            table = buf16[:8 * (buf16.shape[0] // 8)].reshape(-1, 8 * D4).float()
            lib = event_ms(lambda: F.embedding(idx, table), 10)
            lib_what = "embedding(idx, table as (1963, 1024) fp32, cast outside the timing)"
            del table
        else:
            bags = idx.view(-1, K).long()
            lib = event_ms(lambda: F.embedding_bag(bags, buf16, mode="sum"), 10)
            lib_what = "embedding_bag(sum) over bags of 32, bf16, one row per tile (not 8)"
        r.update(ms=kernel_ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=f"R={buf16.shape[0]} D4={D4} {idx.numel()} indices bf16")
        print(f"[lab {tag}] bound {b_ms:.5f} ms ({b_by}); library {lib_what}: {lib:.4f} ms")
        del buf16, idx
        torch.cuda.empty_cache()


def _tiny_vit_config():
    import dataclasses
    from uninext_tpu_torch.config import BackboneConfig, tiny_test_config
    return dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=64, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(32, 64, 64),
        vit_drop_path_rate=0.0))


def phase_small_reference():
    """A small model, same weights: kernels on the card vs plain on the CPU,
    in serving and in one train step, fp32. Returns the kernel launches of
    this path (kernel A's fp32 route is the path's own)."""
    import copy

    import numpy as np
    import torch
    from uninext_tpu_torch.models.detr import build_model
    cfg = _tiny_vit_config()
    cpu = build_model(cfg, "cpu", seed=1)
    # off the initial sampling-offset ring: at init every MSDA sample sits on
    # a pixel centre, where bilinear sampling has a kink and the gradient
    # (compared below) depends on which side rounding puts it
    with torch.no_grad():
        g = torch.Generator().manual_seed(11)
        for p in cpu.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    gpu = copy.deepcopy(cpu).to("cuda")
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 128, 160, 3).astype(np.float32))
    mask = torch.zeros(2, 128, 160, dtype=torch.bool)
    mask[0, 96:] = True
    sizes = torch.tensor([[96, 160], [128, 160]])
    ids = torch.from_numpy(rng.randint(0, 1000, (2, 16)))
    tmask = torch.ones(2, 16, dtype=torch.int32)
    with torch.inference_mode():
        want = cpu(images, mask, sizes, ids, tmask)
        got = gpu(*(t.to("cuda") for t in (images, mask, sizes, ids, tmask)))
    errs = {k: _check(f"small slice {k}", got[k].cpu(), want[k], 1e-4)
            for k in ("pred_logits", "pred_boxes", "pred_boxious")}
    print("[reference] small ViT slice, fp32, card (kernels) vs CPU (plain): "
          + ", ".join(f"{k} max_abs_err={v:.3g}" for k, v in errs.items())
          + " (tol 1e-4)")

    # one train step: losses and every gradient
    from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
    G, T = cfg.data.max_insts, 16
    boxes = torch.zeros(2, G, 4)
    valid = torch.zeros(2, G, dtype=torch.bool)
    pmap = torch.zeros(2, G, T, dtype=torch.bool)
    for b in range(2):
        n = 4 + 3 * b
        boxes[b, :n, :2] = torch.from_numpy(rng.uniform(0.25, 0.75, (n, 2)))
        boxes[b, :n, 2:] = torch.from_numpy(rng.uniform(0.05, 0.4, (n, 2)))
        valid[b, :n] = True
        pmap[b, torch.arange(n), torch.from_numpy(rng.randint(1, 12, n))] = True
    batch = {"images": images, "img_mask": mask, "image_sizes": sizes,
             "text_ids": ids.long(), "text_mask": tmask,
             "targets": {"boxes": boxes, "valid": valid, "positive_map": pmap}}
    gen = torch.Generator().manual_seed(0)
    shape = (2, 5, 2, min(20, G), 4)
    noise = (torch.randint(0, 2, shape, generator=gen).float() * 2 - 1,
             torch.rand(shape, generator=gen))

    def to(x, dev):
        return {k: to(v, dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    res = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        _, losses = loss_and_grads(model, to(batch, dev), loss_weights(cfg),
                                   dn_noise=tuple(t.to(dev) for t in noise))
        res.append((losses, dict(model.named_parameters())))
    (cl, cp), (gl, gp) = res
    if set(cl) != set(gl):
        raise AssertionError(f"loss keys differ: {sorted(set(cl) ^ set(gl))}")
    loss_err = max(_check_rel(f"small step {k}", gl[k].cpu(), cl[k], 1e-4)[1] for k in cl)
    grad_err = 0.0
    for n, p in cp.items():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        got = gp[n].grad.cpu() if gp[n].grad is not None else torch.zeros_like(p)
        scale = max(want.abs().max().item(), 1e-2)
        err = (got - want).abs().max().item()
        # 1e-3 of the leaf's largest gradient, at least 1e-5 (leaves whose
        # exact gradient is 0 hold only rounding noise)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"small step gradient {n}: {err} > 1e-3 x {scale}")
        grad_err = max(grad_err, err / scale)
    print(f"[reference] small ViT train step, fp32, card (A, A-bwd, MSDA, MSDA-bwd) vs "
          f"CPU (plain): {len(cl)} losses, max rel err {loss_err:.3g} (tol 1e-4); "
          f"{len(cp)} gradients, max err / leaf max {grad_err:.3g} (tol 1e-3)")
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[reference] kernel launches on the small reference path: {launches}")
    for fp32 in ("rel_pos_flash_attn_fp32", "rel_pos_flash_attn_bwd_fp32"):
        bf16 = fp32.removesuffix("_fp32")
        if launches[bf16] or not launches[fp32]:
            raise AssertionError(f"the fp32 reference path must take {fp32} only, "
                                 f"not {bf16}")
    return launches


def _counters():
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import dma_gather, gather_fold, msda, nms
    return {"rel_pos_flash_attn": vit.rel_pos_flash_attn_mma,
            "rel_pos_flash_attn_fp32": vit.rel_pos_flash_attn_fp32,
            "rel_pos_flash_attn_bwd": vit.rel_pos_flash_attn_bwd_mma,
            "rel_pos_flash_attn_bwd_fp32": vit.rel_pos_flash_attn_bwd_fp32,
            "ms_deform_attn_fwd": msda.ms_deform_attn,
            "ms_deform_attn_bwd": msda.ms_deform_attn_bwd,
            "nms": nms.batched_nms,
            "msda_fold": gather_fold.msda_fold,
            "gather_rowsum_scalar": gather_fold.gather_rowsum_scalar,
            "gather_rowsum_vec": gather_fold.gather_rowsum_vec,
            "gather_weighted": gather_fold.gather_weighted,
            "dma_gather_rowsum": dma_gather.dma_gather_rowsum,
            "dma_block_gather": dma_gather.dma_block_gather}


def _prompt(cfg):
    from uninext_tpu_torch.data.coco_categories import COCO_CATEGORIES
    from uninext_tpu_torch.data.prompts import create_label_token_map
    from uninext_tpu_torch.data.tokenizer import BertTokenizer
    return create_label_token_map(COCO_CATEGORIES, BertTokenizer(), cfg.language.max_len)


def phase_serving(profile: bool):
    """The slice at full width: 4 requests through forward + postprocess
    (with `profile`, one more under the profiler). Returns the launch counts
    of the 4 requests."""
    import torch
    from uninext_tpu_torch.config import image_joint_vit_huge
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import postprocess_detection
    dev = torch.device("cuda")
    cfg = image_joint_vit_huge()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] image_joint_vit_huge: {n_params / 1e6:.2f}M parameters "
          f"(detection path), compute dtype {cfg.compute_dtype}, random weights "
          f"from seed 0, built in {time.perf_counter() - t0:.1f} s")
    ids, tmask, cmap = _prompt(cfg)
    with torch.inference_mode():
        lang = model.encode_text(torch.from_numpy(ids).long()[None].to(dev),
                                 torch.from_numpy(tmask)[None].to(dev))
        cmap_t = torch.from_numpy(cmap).to(dev)
        g = torch.Generator(device=dev).manual_seed(1)
        Hh, Ww = IMAGE_HW
        requests = []
        for r in range(N_REQUESTS):
            img = torch.randn(1, Hh, Ww, 3, device=dev, generator=g)
            pad = torch.zeros(1, Hh, Ww, dtype=torch.bool, device=dev)
            if r == N_REQUESTS - 1:        # a narrower image padded to the bucket
                pad[:, :, 1088:] = True
                img[:, :, 1088:] = 0
            sizes = torch.tensor([[Hh, 1088 if r == N_REQUESTS - 1 else Ww]])
            requests.append((img, pad, sizes.to(dev)))
        torch.cuda.synchronize()
        counters = _counters()
        expect = {**dict.fromkeys(counters, 0),
                  "rel_pos_flash_attn": cfg.backbone.vit_depth,
                  "rel_pos_flash_attn_bwd": 0,
                  "ms_deform_attn_fwd": (cfg.transformer.enc_layers
                                         + cfg.transformer.dec_layers),
                  "ms_deform_attn_bwd": 0, "nms": 1}
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        latencies, per_request = [], []
        for img, pad, sizes in requests:
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            out = model(img, pad, sizes, None, lang["masks"], lang_dict=lang)
            post = postprocess_detection(out, cmap_t)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
            per_request.append({k: c.launches - before[k] for k, c in counters.items()})
            _check_outputs(out, post, cfg)
        launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("[serving] per-request latency ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in latencies)
          + f"; peak device memory {peak:.2f} GiB")
    print(f"[serving] kernel launches per request: {per_request}")
    for counts in per_request:
        if counts != expect:
            raise AssertionError(f"launches per request {counts} != {expect}")
    if profile:
        img, pad, sizes = requests[1]
        with torch.inference_mode():
            _profile(lambda: postprocess_detection(
                model(img, pad, sizes, None, lang["masks"], lang_dict=lang), cmap_t),
                "one serving request")
    del model, lang, requests, out, post
    torch.cuda.empty_cache()
    return launches


def _check_outputs(out, post, cfg):
    import torch
    Q = cfg.transformer.num_queries
    for k in ("pred_logits", "pred_boxes", "pred_boxious"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k} has non-finite values")
    if out["pred_logits"].shape != (1, Q, cfg.language.max_len):
        raise AssertionError(f"pred_logits shape {tuple(out['pred_logits'].shape)}")
    if post["boxes"].shape != (1, 100, 4) or not torch.isfinite(post["boxes"]).all():
        raise AssertionError(f"boxes {tuple(post['boxes'].shape)} not 100 finite boxes")
    sel = torch.gather(out["pred_boxes"], 1, post["query_idx"][..., None].expand(-1, -1, 4))
    if not ((sel >= 0) & (sel <= 1)).all():
        raise AssertionError("selected boxes (cx, cy, w, h) outside [0, 1]")
    s = post["scores"]
    if not ((s >= 0) & (s <= 1)).all():
        raise AssertionError("scores outside [0, 1]")
    if not (post["classes"] < 80).all():
        raise AssertionError("class index outside the 80 COCO classes")


def _train_batch(cfg, dev):
    """bs=2 at 800x1216; image 1 valid on 800x1088. The 80-class COCO prompt
    for both; 5-20 boxes per image (of max_insts) with random classes, whose
    positive maps are the class's prompt tokens."""
    import numpy as np
    import torch
    ids, tmask, cmap = _prompt(cfg)
    rng = np.random.RandomState(7)
    B, (Hh, Ww), G = TRAIN_BATCH, IMAGE_HW, cfg.data.max_insts
    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(B, Hh, Ww, 3, device=dev, generator=g)
    img_mask = torch.zeros(B, Hh, Ww, dtype=torch.bool, device=dev)
    img_mask[1, :, 1088:] = True
    images[1, :, 1088:] = 0
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    pmap = np.zeros((B, G, cmap.shape[1]), bool)
    for b in range(B):
        n = rng.randint(5, 21)
        boxes[b, :n, :2] = rng.uniform(0.15, 0.85, (n, 2))
        boxes[b, :n, 2:] = rng.uniform(0.03, 0.3, (n, 2))
        valid[b, :n] = True
        pmap[b, :n] = cmap[rng.randint(0, len(cmap), n)]
    T = len(ids)
    return {"images": images, "img_mask": img_mask,
            "image_sizes": torch.tensor([[Hh, Ww], [Hh, 1088]], device=dev),
            "text_ids": torch.from_numpy(ids).long()[None].expand(B, T).to(dev),
            "text_mask": torch.from_numpy(tmask)[None].expand(B, T).to(dev),
            "targets": {"boxes": torch.from_numpy(boxes).to(dev),
                        "valid": torch.from_numpy(valid).to(dev),
                        "positive_map": torch.from_numpy(pmap).to(dev)}}


def phase_training(profile: bool):
    """The training step at full width: 1 warm-up and TRAIN_STEPS timed
    steps. Returns the launch counts of the timed steps."""
    import torch
    from uninext_tpu_torch.config import image_joint_vit_huge
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    dev = torch.device("cuda")
    cfg = image_joint_vit_huge()
    t0 = time.perf_counter()
    state = build_train_state(cfg, seed=0)
    batch = _train_batch(cfg, dev)
    torch.cuda.synchronize()
    n_valid = batch["targets"]["valid"].sum(1).tolist()
    print(f"[training] image_joint_vit_huge, bs={TRAIN_BATCH} at {IMAGE_HW[0]}x"
          f"{IMAGE_HW[1]} (image 1 valid on 800x1088), {n_valid} gt boxes, fp32 "
          f"parameters and AdamW state, {cfg.compute_dtype} compute, ViT drop-path "
          f"{cfg.backbone.vit_drop_path_rate} and per-block checkpointing "
          f"{cfg.backbone.vit_use_checkpoint}, encoder checkpointing "
          f"{cfg.remat_encoder}; set up in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_step(state, batch)
    torch.cuda.synchronize()
    print(f"[training] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")

    counters = _counters()
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda
    recompute = {"rel_pos_flash_attn": vit.flash_rel_pos_attention,
                 "ms_deform_attn_fwd": msda.ms_deform_attn}
    t = cfg.transformer
    n_remat_msda = t.enc_layers if cfg.remat_encoder else 0
    n_remat_vit = cfg.backbone.vit_depth if cfg.backbone.vit_use_checkpoint else 0
    # every block (24 global, 8 windowed in ViT-H) launches A once, again
    # in its recompute, and A-bwd once: all on the tensor-core routes, none
    # on the fp32 routes
    expect = {**dict.fromkeys(counters, 0),
              "rel_pos_flash_attn": cfg.backbone.vit_depth + n_remat_vit,
              "rel_pos_flash_attn_bwd": cfg.backbone.vit_depth,
              "ms_deform_attn_fwd": t.enc_layers + t.dec_layers + n_remat_msda,
              "ms_deform_attn_bwd": t.enc_layers + t.dec_layers, "nms": 0}
    expect_recompute = {"rel_pos_flash_attn": n_remat_vit,
                        "ms_deform_attn_fwd": n_remat_msda}
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    for c in recompute.values():
        c.recompute_launches = 0
    step_ms, metrics, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = {k: c.launches for k, c in counters.items()}
        before_r = {k: c.recompute_launches for k, c in recompute.items()}
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(({k: c.launches - before[k] for k, c in counters.items()},
                         {k: c.recompute_launches - before_r[k]
                          for k, c in recompute.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(metrics):
        print(f"[training] step {i + 1}: total_loss {m['total_loss']:.6g}, grad norm "
              f"before the clip {m['grad_norm']:.6g}, {step_ms[i]:.1f} ms; losses "
              + json.dumps({k: round(v, 6) for k, v in m.items()
                            if k not in ("total_loss", "grad_norm")}))
    print("[training] step ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak device memory {peak:.2f} GiB (max_memory_allocated)")
    print(f"[training] kernel launches per step: {per_step[0][0]}, of them "
          f"recomputes under checkpointing {per_step[0][1]}; expected {expect}, "
          f"recomputes {expect_recompute}")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite {bad}")
        if i and m["total_loss"] == metrics[i - 1]["total_loss"]:
            raise AssertionError(f"step {i + 1}: total loss did not change")
    same = [k for k in metrics[0] if metrics[0][k] == metrics[-1][k]]
    if same:
        raise AssertionError(f"losses unchanged from step 1 to {TRAIN_STEPS}: {same}")
    for counts, rcounts in per_step:
        if counts != expect or rcounts != expect_recompute:
            raise AssertionError(f"launches per step {counts} (recomputes {rcounts}) "
                                 f"!= {expect} ({expect_recompute})")
    if profile:
        _profile(lambda: train_step(state, batch), "one train step")
    del state, batch
    torch.cuda.empty_cache()
    return launches


def _profile(fn, label):
    """`fn` once more under torch.profiler: its host time, the device's
    busy time and idle share over the span of its kernels (union of kernel
    intervals), and the device time of its 25 largest kernels by name and
    of the port's kernels below them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    start0 = spans[0][0] if spans else 0
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (end - start0) / 1e3 if spans else 0.0
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start) / 1e3
    total = sum(by_name.values())
    print(f"[profile] {label}: host {host_ms:.1f} ms, device span {span:.1f} ms, "
          f"kernel time {total:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"(idle share {100 * (1 - busy / 1e3 / span) if span else 0:.1f}%)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in ranked[:25]:
        print(f"[profile] {ms:10.3f} ms  {name[:160]}")
    # the port's own kernels (anonymous namespaces of csrc/) below the 25
    for name, ms in ranked[25:]:
        if name.startswith("void (anonymous namespace)::"):
            print(f"[profile] {ms:10.3f} ms  {name[:160]} (the port's kernel)")


SOURCES = {
    "rel_pos_flash_attn": ("uninext_tpu_torch/csrc/rel_pos_flash_attn_mma.cu",
                           "uninext_tpu/models/vit.py:131"),
    "rel_pos_flash_attn_fp32": ("uninext_tpu_torch/csrc/rel_pos_flash_attn.cu",
                                "uninext_tpu/models/vit.py:131 (fp32 inputs)"),
    "rel_pos_flash_attn_bwd": (
        "uninext_tpu_torch/csrc/rel_pos_flash_attn_bwd_mma.cu",
        "uninext_tpu/models/vit.py:131 under jax.grad: jax/experimental/pallas/ops/"
        "tpu/flash_attention.py:941 _flash_attention_bwd_dkv, :1287 "
        "_flash_attention_bwd_dq"),
    "rel_pos_flash_attn_bwd_fp32": (
        "uninext_tpu_torch/csrc/rel_pos_flash_attn_bwd.cu",
        "uninext_tpu/models/vit.py:131 under jax.grad (fp32 inputs): flash_attention.py"
        ":941, :1287"),
    "ms_deform_attn_fwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:136"),
    "ms_deform_attn_bwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:234"),
    "nms": ("uninext_tpu_torch/csrc/nms.cu", "uninext_tpu/ops/nms.py:25"),
    "msda_fold": ("uninext_tpu_torch/csrc/gather_fold.cu",
                  "tools/msda_v6_lab.py:87 _fold_pallas (_fold_kernel :68)"),
    "gather_rowsum_scalar": ("uninext_tpu_torch/csrc/gather_fold.cu",
                             "tools/pallas_gather_probe.py:57 probe_scalar_loop"),
    "gather_rowsum_vec": ("uninext_tpu_torch/csrc/gather_fold.cu",
                          "tools/pallas_gather_probe.py:88 probe_vector_gather"),
    "gather_weighted": ("uninext_tpu_torch/csrc/gather_fold.cu",
                        "tools/pallas_gather_probe.py:123 probe_onehot"),
    "dma_gather_rowsum": ("uninext_tpu_torch/csrc/dma_gather.cu",
                          "tools/pallas_dma_probe.py:101 probe_dma (dma_kernel :84)"),
    "dma_block_gather": ("uninext_tpu_torch/csrc/dma_gather.cu",
                         "tools/pallas_dma_probe.py:129 probe_index_map (imap_kernel :125)"),
}


def main():
    if not os.path.isdir(os.path.join(HERE, "uninext_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(uninext_tpu_torch/ not found beside this script)")
    sys.path.insert(0, HERE)
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    card = phase_device()
    rec = phase_kernels()
    rec.update(phase_backward_kernels())
    lab_rec, lab = phase_labs()
    rec.update(lab_rec)
    reference = phase_small_reference()
    serving = phase_serving(profile)
    training = phase_training(profile)
    import torch
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        by_path = {"serving": serving[name], "training": training[name],
                   "lab": lab[name], "reference": reference[name]}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"kernel {name} was never launched by its path")
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "shape")},
                        "bound_share": r["bound_ms"] / r["ms"],
                        **{k: r[k] for k in ("max_rel_err", "kernel_ms", "window_ms",
                                             "window_kernel_ms", "window_plain_ms",
                                             "window_library_ms", "window_bound_ms",
                                             "graph_ms", "model_ms", "model_graph_ms",
                                             "decoder_ms", "decoder_model_ms", "level0_graph_ms",
                                             "level3_graph_ms")
                           if k in r}})
        k = kernels[-1]
        if "kernel_ms" in k:
            k["kernel_bound_share"] = k["bound_ms"] / k["kernel_ms"]
        if "window_bound_ms" in k:
            k["window_bound_share"] = k["window_bound_ms"] / k["window_ms"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
