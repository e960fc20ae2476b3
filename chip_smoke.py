#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-H detection serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines and raises on failure, so the exit code is
nonzero):
  1. device: the card's name and power limit (nvidia-smi) and the build of
     the three kernels from `uninext_tpu_torch/csrc/`;
  2. kernels: each kernel against its plain PyTorch version on the card at
     the slice's shapes, in fp32 and bf16, with both times (CUDA events);
  3. correctness: a small model with the same weights on the card (kernels)
     and on the CPU (plain versions);
  4. serving: `image_joint_vit_huge()` at full width with random weights
     from a seed, the 80-class COCO prompt encoded once, and 4 requests at
     800x1216 through forward and `postprocess_detection`, with the kernel
     launches of each request counted.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Exits nonzero and prints no
result without a CUDA device or outside a checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGE_HW = (800, 1216)
N_REQUESTS = 4


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
    seconds = {}
    for name in _build.KERNELS:
        t0 = time.perf_counter()
        _build.library(name)        # nvcc unless built from these sources before
        seconds[name] = round(time.perf_counter() - t0, 2)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; kernel build + load seconds "
          + json.dumps(seconds))


def _check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def phase_kernels():
    """Each kernel vs its plain version at the slice's shapes. Returns the
    per-kernel record (bf16 = the serving dtype) for the JSON line."""
    import torch
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
        base = torch.randn(B, h * w, 3, nh, hd, device=dev, generator=g)
        rh = 0.1 * torch.randn(h, h, hd, device=dev, generator=g)
        rw = 0.1 * torch.randn(w, w, hd, device=dev, generator=g)
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
                    r.update(ms=ms, plain_ms=pms)

    # kernel B: encoder (Lq = S = 20197) and decoder (Lq = 900) calls
    shapes = tuple((IMAGE_HW[0] // s, IMAGE_HW[1] // s) for s in (8, 16, 32))
    shapes += (((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2),)
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
                    r.update(ms=ms, plain_ms=pms)

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
    print(f"[kernel C] batched_nms N={N}: keep masks identical ({kept} kept), "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    rec["nms"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms}
    return rec


def phase_small_reference():
    """A small model, same weights: kernels on the card vs plain on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from uninext_tpu.config import BackboneConfig, tiny_test_config
    from uninext_tpu_torch.models.detr import build_model
    cfg = dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=64, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(32, 64, 64)))
    cpu = build_model(cfg, "cpu", seed=1)
    gpu = build_model(cfg, "cpu", seed=1).to("cuda")
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


def phase_serving():
    """The slice at full width: 4 requests through forward + postprocess.
    Returns the launch counts of the 4 requests."""
    import torch
    from uninext_tpu.config import image_joint_vit_huge
    from uninext_tpu.data.coco_categories import COCO_CATEGORIES
    from uninext_tpu.data.prompts import create_label_token_map
    from uninext_tpu.data.tokenizer import BertTokenizer
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import postprocess_detection
    from uninext_tpu_torch.ops import msda, nms
    dev = torch.device("cuda")
    cfg = image_joint_vit_huge()
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] image_joint_vit_huge: {n_params / 1e6:.2f}M parameters "
          f"(detection path), compute dtype {cfg.compute_dtype}, random weights "
          f"from seed 0, built in {time.perf_counter() - t0:.1f} s")
    ids, tmask, cmap = create_label_token_map(COCO_CATEGORIES, BertTokenizer(),
                                              cfg.language.max_len)
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
        counters = {"rel_pos_flash_attn": vit.flash_rel_pos_attention,
                    "ms_deform_attn_fwd": msda.ms_deform_attn,
                    "nms": nms.batched_nms}
        expect = {"rel_pos_flash_attn": cfg.backbone.vit_depth,
                  "ms_deform_attn_fwd": (cfg.transformer.enc_layers
                                         + cfg.transformer.dec_layers),
                  "nms": 1}
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


def main():
    if not os.path.isdir(os.path.join(HERE, "uninext_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(uninext_tpu_torch/ not found beside this script)")
    sys.path.insert(0, HERE)
    phase_device()
    rec = phase_kernels()
    phase_small_reference()
    launches = phase_serving()
    import torch
    sources = {"rel_pos_flash_attn": ("uninext_tpu_torch/csrc/rel_pos_flash_attn.cu",
                                      "uninext_tpu/models/vit.py:131"),
               "ms_deform_attn_fwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                                      "uninext_tpu/ops/msda.py:136"),
               "nms": ("uninext_tpu_torch/csrc/nms.cu", "uninext_tpu/ops/nms.py:25")}
    kernels = []
    for name, (src, replaces) in sources.items():
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched by the main path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **{k: rec[name][k] for k in ("max_abs_err", "ms", "plain_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
