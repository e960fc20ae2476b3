"""ConvNeXt end to end on the port: the protocol of `tools/convnext_check.py`.

    python -m uninext_tpu_torch.tools.convnext_check [--steps 400] [--seed 0]
        [--skip-train] [--skip-serve] [--out build/convnext_check/seed0.json]
        [--device cuda]

Two legs:

  train   `tiny_convnext_cfg`: `tiny_test_config` with a ConvNeXt of tiny
          dims and ConvNeXt-L's topology (depths 2/2/4/2, dims
          32/64/96/128, out norms on res3-res5, drop-path 0), trained from
          scratch on the in-repo mini-COCO (data seed 7: 32 train and 12 val
          images; `UniDatasetMapper` at 192-256 px with masks, bs=2, the
          loader seeded with 0 whatever `--seed` is) through `Trainer`, then
          `DetectionEvaluator` (bbox, the C++ COCO matcher, score threshold
          0.05) -> det AP;
  serve   `image_joint_convnext_large` at full width with random weights
          from `--seed`, one 800x1216 image a request (bs=1), the 80-class
          prompt of 256 random ids encoded once, forward and
          `postprocess_detection`: the latency of each request on the host
          clock up to `torch.cuda.synchronize()`, after 3 warm-up requests.

`--seed` seeds the weights and the step's random numbers. The JSON written
to `--out` holds both legs and the device (name and power limit). Runs on
the card unless `--device cpu` (then the serve leg is skipped: a
full-width ConvNeXt-L request is for the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import BackboneConfig, UninextConfig, image_joint_convnext_large, tiny_test_config
from ..data.coco import UniDatasetMapper, load_coco_json
from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_coco
from ..data.prompts import create_label_token_map
from ..data.tokenizer import BertTokenizer
from ..engine.evaluator import DetectionEvaluator
from .ap_check import StepLog, card

REPO = Path(__file__).resolve().parents[2]
SERVE_HW = (800, 1216)
SERVE_REQUESTS = 20


def tiny_convnext_cfg(steps: int) -> UninextConfig:
    """`tools/convnext_check.py:tiny_convnext_cfg`: the train leg's config."""
    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg,
        backbone=BackboneConfig(name="convnext_large", convnext_depths=(2, 2, 4, 2),
                                convnext_dims=(32, 64, 96, 128),
                                out_channels=(64, 96, 128), drop_path_rate=0.0),
        data=dataclasses.replace(cfg.data, max_insts=8, max_text_len=32,
                                 min_size_train=(192,), max_size_train=256,
                                 min_size_test=192, max_size_test=256),
        solver=dataclasses.replace(cfg.solver, base_lr=3e-4, lang_lr=3e-4, vl_lr=3e-4,
                                   backbone_multiplier=1.0, warmup_iters=40, grad_clip=1.0,
                                   max_iter=steps, checkpoint_period=10 ** 9,
                                   steps=(int(steps * 0.8),)))


def leg_train(steps: int, seed: int, device: torch.device, n_train: int = 32,
              n_val: int = 12):
    from ..engine.trainer import Trainer
    cfg = tiny_convnext_cfg(steps)
    with tempfile.TemporaryDirectory(prefix="convnext_coco_") as root:
        paths = make_mini_coco(root, n_train=n_train, n_val=n_val, seed=7)
        train, cats = load_coco_json(paths["train_json"], paths["train_root"])
        val, _ = load_coco_json(paths["val_json"], paths["val_root"])
        tok = BertTokenizer()
        mapper = UniDatasetMapper(cfg.data, cats, tok, is_train=True, with_masks=True)
        loader = iter(MultiDatasetLoader([(train, mapper, 2)], [1.0], seed=0, num_workers=2))
        timer = StepLog()
        trainer = Trainer(cfg, loader, output_dir=os.path.join(root, "run"),
                          task="detection", has_masks=True, device=device, seed=seed,
                          log_period=100, extra_hooks=[timer])
        t0 = time.perf_counter()
        trainer.train()
        secs = time.perf_counter() - t0
        loader.close()              # stops the loader's mapping threads
        eval_mapper = UniDatasetMapper(cfg.data, cats, tok, is_train=False, with_masks=True)
        _, _, cmap = create_label_token_map(cats, tok, cfg.data.max_text_len)
        det = DetectionEvaluator(trainer.model, cfg, cmap, with_masks=False).evaluate(
            val, eval_mapper, score_thr=0.05)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    ms = np.asarray(timer.seconds[1:] or timer.seconds) * 1e3
    print(f"[train] ConvNeXt det AP {det['AP']:.4f} after {steps} steps in {secs:.1f} s "
          f"({n_params / 1e6:.2f}M parameters)", flush=True)
    return {"steps": steps, "train_seconds": secs,
            "det_ap": float(det["AP"]) if np.isfinite(det["AP"]) else None,
            "det_ap50": float(det["AP50"]) if np.isfinite(det["AP50"]) else None,
            "params_m": n_params / 1e6,
            "step_ms": {"median": float(np.median(ms)), "min": float(ms.min()),
                        "max": float(ms.max()), "steps": len(ms)},
            "backbone": "convnext (tiny dims, large topology)"}


def leg_serve(seed: int, device: torch.device):
    """image_joint_convnext_large, one request at a time at SERVE_HW."""
    from ..models.detr import build_model
    from ..models.postprocess import postprocess_detection
    H, W = SERVE_HW
    T = 256
    cfg = image_joint_convnext_large()
    model = build_model(cfg, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32)).to(device)
    pad = torch.zeros(1, H, W, dtype=torch.bool, device=device)
    sizes = torch.tensor([[H, W]], device=device)
    ids = torch.from_numpy(rng.randint(0, 30000, (1, T))).to(device)
    tmask = torch.ones(1, T, dtype=torch.int32, device=device)
    cmap = torch.zeros(80, T, dtype=torch.bool, device=device)
    cmap[torch.arange(80), torch.arange(80) * 2 + 1] = True
    torch.cuda.reset_peak_memory_stats(device)
    ms = []
    with torch.inference_mode():
        lang = model.encode_text(ids, tmask)
        for r in range(3 + SERVE_REQUESTS):
            t0 = time.perf_counter()
            out = model(image * (1 + r * 1e-6), pad, sizes, None, lang["masks"],
                        lang_dict=lang)
            post = postprocess_detection(out, cmap)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.isfinite(post["scores"]).all():
                raise AssertionError("serve: non-finite scores")
    ms = np.asarray(ms[3:])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[serve] image_joint_convnext_large ({n_params / 1e6:.2f}M) {H}x{W} bs=1: "
          f"request ms median {np.median(ms):.2f} ({ms.min():.2f}-{ms.max():.2f}), peak "
          f"{peak:.2f} GiB", flush=True)
    return {"config": "image_joint_convnext_large", "params_m": n_params / 1e6,
            "resolution": f"{H}x{W}", "requests": len(ms),
            "request_ms": {"median": float(np.median(ms)), "min": float(ms.min()),
                           "max": float(ms.max()), "all": ms.tolist()},
            "requests_per_s_at_median": 1e3 / float(np.median(ms)), "peak_gib": peak}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=12)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="default: build/convnext_check/seed<seed>.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("convnext_check: no CUDA device (pass --device cpu for the CPU)")
    out = Path(args.out or REPO / "build" / "convnext_check" / f"seed{args.seed}.json")
    payload = {"device": card(device), "seed": args.seed}
    if not args.skip_train:
        payload["train"] = leg_train(args.steps, args.seed, device, args.n_train, args.n_val)
    if not args.skip_serve and device.type == "cuda":
        payload["serve"] = leg_serve(args.seed, device)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
