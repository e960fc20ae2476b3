#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-H detection paths once on one CUDA card:
serving, and the training step.

    python3 chip_smoke.py [--profile]

Phases (each prints its lines and raises on failure, so the exit code is
nonzero):
  1. device: the card's name and power limit (nvidia-smi) and the build of
     the kernel libraries from `uninext_tpu_torch/csrc/` (one nvcc each,
     all started together);
  2. kernels: each forward kernel (A, B, C) against its plain PyTorch
     version on the card at the slice's shapes, in fp32 and bf16, with both
     times (CUDA events), the least time the card could take (bound) and,
     where one exists, one PyTorch library call's time;
  3. backward kernels: A-bwd and B-bwd against autograd through the plain
     versions at the training shapes, fp32 and bf16, timed the same way;
  4. correctness: a small model with the same weights on the card (kernels)
     and on the CPU (plain versions): the serving outputs, then one train
     step's losses and every gradient;
  5. serving: `image_joint_vit_huge()` at full width with random weights
     from a seed, the 80-class COCO prompt encoded once, and 4 requests at
     800x1216 through forward and `postprocess_detection`, with the kernel
     launches of each request counted;
  6. training: the same config, bs=2 at 800x1216 (one image valid on
     800x1088), synthetic targets, 1 warm-up and 3 timed steps of
     `engine/train.py:train_step` (forward, losses, backward, clip, AdamW),
     with losses, grad norm, step time, peak memory and per-step launches.
     `--profile` adds one profiled step and prints its time by kernel.

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
    return smi.stdout.strip().splitlines()[0]


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


def phase_kernels():
    """Each forward kernel vs its plain version at the slice's shapes.
    Returns the per-kernel record (bf16 = the compute dtype) for the JSON
    line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda, nms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # fp32: only the order of fp32 sums differs. bf16: both read the same
    # bf16 inputs and compute in fp32; outputs may differ by one bf16
    # rounding (1 ulp at |x| < 8 is 3.1e-2).
    tol = {torch.float32: 5e-5, torch.bfloat16: 3.2e-2}
    rec = {}

    # kernel A: global blocks (1, 50x76 grid) and windowed blocks (24 windows of 14x14)
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    for label, (B, h, w) in (("global", (1, H, W)), ("window", (24, 14, 14))):
        nh, hd = 16, 80
        base, rh, rw = _attention_inputs(dev, g, B, h, w, nh, hd)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(B, h, w, nh, hd)
            args = (q5, k, v, rh.to(dt), rw.to(dt), hd ** -0.5)
            got = vit.flash_rel_pos_attention(*args)
            want = vit.rel_pos_attention_plain(*args)
            err = _check(f"rel_pos_flash_attn {label} {dt}", got, want, tol[dt])
            ms = _timed(lambda: vit.flash_rel_pos_attention(*args), 5)
            pms = _timed(lambda: vit.rel_pos_attention_plain(*args), 3)
            print(f"[kernel A] rel_pos_flash_attn {label} B={B} {h}x{w} nh={nh} "
                  f"hd={hd} {str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if dt == torch.bfloat16:
                r = rec.setdefault("rel_pos_flash_attn", {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if label == "global":
                    S = h * w
                    sq, sk, sv, bias = _sdpa_args(q5, k, v, rh.to(dt), rw.to(dt))
                    lib = _timed(lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=bias), 5)
                    del bias
                    b_ms, b_by = _bound(
                        2 * (4 * B * S * nh * hd + h * h * hd + w * w * hd),
                        B * nh * (4 * S * S * hd + 2 * S * (h + w) * hd), "bf16")
                    r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by, shape=f"global B={B} {h}x{w} bf16")
                    print(f"[kernel A] bound {b_ms:.4f} ms ({b_by}); library "
                          f"scaled_dot_product_attention with a float bias mask: "
                          f"{lib:.3f} ms")

    # kernel B: encoder (Lq = S = 20197) and decoder (Lq = 900) calls
    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    value32 = torch.randn(1, S, M, D, device=dev, generator=g)
    for label, Lq in (("encoder", S), ("decoder", 900)):
        loc = torch.rand(1, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att = torch.rand(1, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att = att.reshape(1, Lq, M, L, P)
        for dt in (torch.float32, torch.bfloat16):
            args = (value32.to(dt), shapes, loc, att)
            got = msda.ms_deform_attn(*args)
            want = msda.ms_deform_attn_plain(*args)
            err = _check(f"ms_deform_attn {label} {dt}", got, want, tol[dt])
            ms = _timed(lambda: msda.ms_deform_attn(*args), 20)
            pms = _timed(lambda: msda.ms_deform_attn_plain(*args), 5)
            print(f"[kernel B] ms_deform_attn {label} Lq={Lq} S={S} M={M} D={D} "
                  f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if dt == torch.bfloat16:
                r = rec.setdefault("ms_deform_attn_fwd", {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if label == "encoder":
                    n = Lq * M * L * P
                    b_ms, b_by = _bound(2 * S * M * D + 4 * 3 * n + 2 * Lq * M * D,
                                        n * 10 * D, "fp32")
                    r.update(ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by, shape=f"encoder B=1 Lq={Lq} bf16")
                    print(f"[kernel B] bound {b_ms:.4f} ms ({b_by}); no single "
                          f"PyTorch call computes MSDA")

    # kernel C: 900 boxes in 4 classes around 40 centres (many overlaps), exact
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
    print(f"[kernel C] batched_nms N={N}: keep masks identical ({kept} kept), "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"no PyTorch call computes NMS (torchvision is absent)")
    rec["nms"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms, "library_ms": None,
                  "bound_ms": b_ms, "bound_by": b_by, "shape": f"N={N}"}
    return rec


def phase_backward_kernels():
    """A-bwd and B-bwd vs autograd through the plain versions at the
    training shapes (bs=2). Returns their records for the JSON line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # relative to each gradient's largest entry. fp32: summation order (B-bwd
    # adds dvalue with fp32 atomics, in an order that changes between runs).
    # bf16: each side rounds its gradients to bf16 once (2^-8 = 3.9e-3 of
    # the value) after fp32 sums of other orders.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
    rec = {}
    B = TRAIN_BATCH
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    nh, hd = 16, 80
    windows = B * (-(-H // 14)) * (-(-W // 14))
    for label, (Bw, h, w) in (("global", (B, H, W)), ("window", (windows, 14, 14))):
        base, rh0, rw0 = _attention_inputs(dev, g, Bw, h, w, nh, hd)
        S = h * w
        for dt in (torch.float32, torch.bfloat16):
            cot = torch.randn(Bw, h, w, nh * hd, device=dev, generator=g).to(dt)
            grads, graphs = [], []
            for fn in (vit.flash_rel_pos_attention, vit.rel_pos_attention_plain):
                qkv = base.to(dt).requires_grad_()
                rh, rw = rh0.to(dt).requires_grad_(), rw0.to(dt).requires_grad_()
                q, k, v = qkv.unbind(2)
                out = fn(q.reshape(Bw, h, w, nh, hd), k, v, rh, rw, hd ** -0.5)
                grads.append(torch.autograd.grad(out, (qkv, rh, rw), cot,
                                                 retain_graph=True))
                graphs.append((out, (qkv, rh, rw)))
            errs, rels = zip(*(
                _check_rel(f"rel_pos_flash_attn_bwd {label} {dt} {n}", a, b, tol[dt])
                for n, a, b in zip(("dqkv", "dRh", "dRw"), *grads)))
            # the kernel's function: the saved forward (out, lse) -> gradients
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(Bw, h, w, nh, hd)
            fargs = (q5, k, v, rh0.to(dt), rw0.to(dt), hd ** -0.5)
            out, lse = vit.rel_pos_flash_attn_fwd(*fargs, with_lse=True)
            ms = _timed(lambda: vit.rel_pos_flash_attn_bwd(*fargs, out, lse, cot), 3,
                        warmup=1)
            pout, pin = graphs[1]
            pms = _timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True),
                         3, warmup=1)
            del graphs, grads, pout, pin
            print(f"[kernel A-bwd] rel_pos_flash_attn_bwd {label} B={Bw} {h}x{w} "
                  f"nh={nh} hd={hd} {str(dt)[6:]}: max_abs_err dqkv/dRh/dRw = "
                  + "/".join(f"{e:.3g}" for e in errs) + ", / max |grad| = "
                  + "/".join(f"{e:.3g}" for e in rels)
                  + f" (tol {tol[dt]}) kernel {ms:.3f} ms, "
                  f"plain backward {pms:.3f} ms")
            if dt == torch.bfloat16:
                r = rec.setdefault("rel_pos_flash_attn_bwd",
                                   {"max_abs_err": 0.0, "max_rel_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                r["max_rel_err"] = max(r["max_rel_err"], *rels)
                if label == "global":
                    sq, sk, sv, bias = _sdpa_args(q5, k, v, rh0.to(dt), rw0.to(dt))
                    leaves = [x.detach().requires_grad_() for x in (sq, sk, sv, bias)]
                    lout = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
                    lcot = cot.reshape(Bw, S, nh, hd).transpose(1, 2)
                    lib = _timed(lambda: torch.autograd.grad(
                        lout, leaves, lcot, retain_graph=True), 3)
                    del lout, leaves, bias
                    e = 2
                    b_ms, b_by = _bound(
                        e * 8 * Bw * S * nh * hd + 4 * Bw * nh * S
                        + 2 * e * (h * h * hd + w * w * hd),
                        Bw * nh * (10 * S * S * hd + 6 * S * (h + w) * hd), "bf16")
                    r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by, shape=f"global B={Bw} {h}x{w} bf16")
                    print(f"[kernel A-bwd] bound {b_ms:.4f} ms ({b_by}); library: "
                          f"backward of scaled_dot_product_attention with a float "
                          f"bias mask (dq, dk, dv, dbias): {lib:.3f} ms")
            torch.cuda.empty_cache()

    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    for label, Lq in (("encoder", S), ("decoder", 900)):
        value0 = torch.randn(B, S, M, D, device=dev, generator=g)
        loc0 = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att0 = torch.rand(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att0 = att0.reshape(B, Lq, M, L, P)
        for dt in (torch.float32, torch.bfloat16):
            cot = torch.randn(B, Lq, M * D, device=dev, generator=g).to(dt)
            grads, graphs = [], []
            for fn in (msda.ms_deform_attn, msda.ms_deform_attn_plain):
                value = value0.to(dt).requires_grad_()
                loc, att = loc0.clone().requires_grad_(), att0.clone().requires_grad_()
                out = fn(value, shapes, loc, att)
                grads.append(torch.autograd.grad(out, (value, loc, att), cot,
                                                 retain_graph=True))
                graphs.append((out, (value, loc, att)))
            errs, rels = zip(*(
                _check_rel(f"ms_deform_attn_bwd {label} {dt} {n}", a, b, tol[dt])
                for n, a, b in zip(("dvalue", "dloc", "datt"), *grads)))
            fargs = (value0.to(dt), shapes, loc0, att0)
            ms = _timed(lambda: msda.ms_deform_attn_bwd(*fargs, cot), 10)
            pout, pin = graphs[1]
            pms = _timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True), 3)
            del graphs, grads, pout, pin
            print(f"[kernel B-bwd] ms_deform_attn_bwd {label} B={B} Lq={Lq} S={S} "
                  f"{str(dt)[6:]}: max_abs_err dvalue/dloc/datt = "
                  + "/".join(f"{e:.3g}" for e in errs) + ", / max |grad| = "
                  + "/".join(f"{e:.3g}" for e in rels)
                  + f" (tol {tol[dt]}) kernel {ms:.3f} ms, "
                  f"plain backward {pms:.3f} ms")
            if dt == torch.bfloat16:
                r = rec.setdefault("ms_deform_attn_bwd",
                                   {"max_abs_err": 0.0, "max_rel_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                r["max_rel_err"] = max(r["max_rel_err"], *rels)
                if label == "encoder":
                    n = B * Lq * M * L * P
                    # value read + dvalue written (bf16), loc/att read and
                    # dloc/datt written (fp32), dout read once (bf16)
                    b_ms, b_by = _bound(2 * 2 * B * S * M * D + 2 * 4 * 3 * n
                                        + 2 * B * Lq * M * D, n * (16 * D + 20),
                                        "fp32")
                    r.update(ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by, shape=f"encoder B={B} Lq={Lq} bf16")
                    print(f"[kernel B-bwd] bound {b_ms:.4f} ms ({b_by}); no single "
                          f"PyTorch call computes MSDA's gradients")
    return rec


def _tiny_vit_config():
    import dataclasses
    from uninext_tpu_torch.config import BackboneConfig, tiny_test_config
    return dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=64, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(32, 64, 64),
        vit_drop_path_rate=0.0))


def phase_small_reference():
    """A small model, same weights: kernels on the card vs plain on the CPU,
    in serving and in one train step."""
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
    print(f"[reference] small ViT train step, fp32, card (A, A-bwd, B, B-bwd) vs "
          f"CPU (plain): {len(cl)} losses, max rel err {loss_err:.3g} (tol 1e-4); "
          f"{len(cp)} gradients, max err / leaf max {grad_err:.3g} (tol 1e-3)")


def _counters():
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda, nms
    return {"rel_pos_flash_attn": vit.flash_rel_pos_attention,
            "rel_pos_flash_attn_bwd": vit.rel_pos_flash_attn_bwd,
            "ms_deform_attn_fwd": msda.ms_deform_attn,
            "ms_deform_attn_bwd": msda.ms_deform_attn_bwd,
            "nms": nms.batched_nms}


def _prompt(cfg):
    from uninext_tpu_torch.data.coco_categories import COCO_CATEGORIES
    from uninext_tpu_torch.data.prompts import create_label_token_map
    from uninext_tpu_torch.data.tokenizer import BertTokenizer
    return create_label_token_map(COCO_CATEGORIES, BertTokenizer(), cfg.language.max_len)


def phase_serving():
    """The slice at full width: 4 requests through forward + postprocess.
    Returns the launch counts of the 4 requests."""
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
        expect = {"rel_pos_flash_attn": cfg.backbone.vit_depth,
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
    expect = {"rel_pos_flash_attn": cfg.backbone.vit_depth + n_remat_vit,
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
        _profile_step(state, batch)
    del state, batch
    torch.cuda.empty_cache()
    return launches


def _profile_step(state, batch):
    """One more step under torch.profiler: device time by kernel and the
    device's idle share over the step (union of kernel intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from uninext_tpu_torch.engine.train import train_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
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
    print(f"[profile] one train step: host {host_ms:.1f} ms, device span {span:.1f} ms, "
          f"kernel time {total:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"(idle share {100 * (1 - busy / 1e3 / span) if span else 0:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[profile] {ms:10.3f} ms  {name[:160]}")


SOURCES = {
    "rel_pos_flash_attn": ("uninext_tpu_torch/csrc/rel_pos_flash_attn.cu",
                           "uninext_tpu/models/vit.py:131"),
    "rel_pos_flash_attn_bwd": (
        "uninext_tpu_torch/csrc/rel_pos_flash_attn_bwd.cu",
        "uninext_tpu/models/vit.py:131 under jax.grad: jax/experimental/pallas/ops/"
        "tpu/flash_attention.py:941 _flash_attention_bwd_dkv, :1287 "
        "_flash_attention_bwd_dq"),
    "ms_deform_attn_fwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:136"),
    "ms_deform_attn_bwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:234"),
    "nms": ("uninext_tpu_torch/csrc/nms.cu", "uninext_tpu/ops/nms.py:25"),
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
    phase_small_reference()
    serving = phase_serving()
    training = phase_training(profile)
    import torch
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        by_path = {"serving": serving[name], "training": training[name]}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"kernel {name} was never launched by the main path")
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "shape")},
                        **({"max_rel_err": r["max_rel_err"]} if "max_rel_err" in r else {})})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
