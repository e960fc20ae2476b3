"""AP of `image_joint_r50` trained from scratch on the in-repo mini-COCO
fixture: the protocol of `tools/real_ap_check.py --flagship` on the port.

    python -m uninext_tpu_torch.tools.ap_check --flagship [--steps 1500]
        [--seed 0] [--out build/ap_check/flagship_seed0.json] [--device cuda]

(without `--flagship`: `tiny_test_config` with the small run's changes.)

mini-COCO JPEGs and instances json (`data/mini_coco.py`, data seed 0: 32
train and 48 val images) -> `load_coco_json` -> `UniDatasetMapper` (LSJ
into a 224 canvas, scale 0.6-1.4, with masks) -> `MultiDatasetLoader`
(bs=2, 2 threads) -> `Trainer` -> `DetectionEvaluator` (bbox, then segm;
the C++ COCO matcher; score threshold 0.05) -> AP. With `--flagship` the
config is the preset at its full width (R50, 12-layer BERT, 6+6 layers,
900 queries, DN, simOTA, IoU branch, CondInst masks) with the flagship
run's changes: at most 20 instances, 224-352 px images, lr 2e-4 (BERT
2e-5), 50 warm-up updates, a 10x decay at 80% of the steps, no periodic
checkpoint.
`--seed` seeds the weights and the step's random numbers; the loader is
seeded with 0 whatever `--seed` is, as the JAX tool seeds it, so every
seed sees the same batches.

The JSON written to `--out` holds the AP dicts, the device (name and power
limit), the step times (host clock to the end of each step's device work:
median and range over the last 1000 steps, or all when fewer), the peak
device memory of training and the seconds per evaluated image, with and
without the first image of each shape. Runs on the card unless `--device
cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import UninextConfig, image_joint_r50
from ..data.coco import UniDatasetMapper, load_coco_json
from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_coco
from ..data.prompts import create_label_token_map
from ..data.tokenizer import BertTokenizer
from ..engine.evaluator import DetectionEvaluator
from ..engine.hooks import HookBase
from ..engine.trainer import Trainer
from .evidence import build_tiny_cfg

REPO = Path(__file__).resolve().parents[2]
LSJ = dict(lsj=True, lsj_size=224, lsj_min_scale=0.6, lsj_max_scale=1.4)


def build_cfg(steps: int, flagship: bool = True) -> UninextConfig:
    """The fixture run's config (`tools/real_ap_check.py:build_cfg`):
    `image_joint_r50` with the flagship run's changes, or without
    `flagship` the small `tiny_test_config` run's."""
    if flagship:
        cfg = image_joint_r50()
        return dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, max_insts=20, min_size_train=(224,),
                                     max_size_train=352, min_size_test=224,
                                     max_size_test=352),
            solver=dataclasses.replace(cfg.solver, base_lr=2e-4, lang_lr=2e-5,
                                       vl_lr=2e-4, warmup_iters=50, max_iter=steps,
                                       checkpoint_period=10 ** 9,
                                       steps=(int(steps * 0.8),)))
    return build_tiny_cfg(steps, 224, 352)


def fixture(root: str, cfg: UninextConfig, n_train: int, n_val: int):
    """The fixture on disk and what reads it: (loader, val records, eval
    mapper, class-token map). The loader's seed is 0, as in the JAX tool."""
    paths = make_mini_coco(root, n_train=n_train, n_val=n_val)
    train_recs, cats = load_coco_json(paths["train_json"], paths["train_root"])
    val_recs, _ = load_coco_json(paths["val_json"], paths["val_root"])
    tok = BertTokenizer()
    train_mapper = UniDatasetMapper(cfg.data, cats, tok, is_train=True, with_masks=True,
                                    **LSJ)
    loader = MultiDatasetLoader([(train_recs, train_mapper, 2)], [1.0], seed=0,
                                num_workers=2)
    eval_mapper = UniDatasetMapper(cfg.data, cats, tok, is_train=False, with_masks=True)
    _, _, cmap = create_label_token_map(cats, tok, cfg.data.max_text_len)
    return loader, val_recs, eval_mapper, cmap


class StepLog(HookBase):
    """Each micro-step's `time` (seconds) and total loss."""

    def __init__(self):
        self.seconds, self.total_loss = [], []

    def after_step(self, trainer, metrics):
        self.seconds.append(float(metrics["time"]))
        self.total_loss.append(float(metrics["total_loss"]))


def evaluate(model, cfg, cmap, val_recs, mapper, score_thr=0.05):
    """bbox and segm AP dicts, and (bucket, seconds) of every image."""
    results, times = {}, []
    for iou_type, with_masks in (("bbox", False), ("segm", True)):
        ev = DetectionEvaluator(model, cfg, cmap, with_masks=with_masks)
        results[iou_type] = ev.evaluate(val_recs, mapper, score_thr=score_thr)
        times += ev.times
    return results, times


def image_seconds(times):
    """Mean seconds per image, with and without the first of each shape."""
    seen, warm = set(), []
    for bucket, s in times:
        if bucket in seen:
            warm.append(s)
        seen.add(bucket)
    return {"all": float(np.mean([s for _, s in times])),
            "without_first_of_each_shape": float(np.mean(warm)) if warm else None,
            "images": len(times), "shapes": len(seen)}


def card(device: torch.device) -> str:
    if device.type != "cuda":
        return f"cpu ({device})"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flagship", action="store_true",
                    help="image_joint_r50 at full width; else tiny_test_config")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="default: build/ap_check/flagship_seed<seed>.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ap_check: no CUDA device (pass --device cpu for the CPU)")
    name = "flagship" if args.flagship else "tiny"
    out = Path(args.out or REPO / "build" / "ap_check" / f"{name}_seed{args.seed}.json")
    cfg = build_cfg(args.steps, args.flagship)
    with tempfile.TemporaryDirectory(prefix="mini_coco_") as root:
        loader, val_recs, mapper, cmap = fixture(root, cfg, args.n_train, args.n_val)
        timer = StepLog()
        batches = iter(loader)
        trainer = Trainer(cfg, batches, output_dir=os.path.join(root, "run"),
                          task="detection", has_masks=True, device=device,
                          seed=args.seed, log_period=50, extra_hooks=[timer])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        trainer.train()
        train_s = time.perf_counter() - t0
        batches.close()             # stops the loader's mapping threads
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
        print(f"[train] {args.steps} steps in {train_s:.1f} s")
        t0 = time.perf_counter()
        results, times = evaluate(trainer.model, cfg, cmap, val_recs, mapper)
        eval_s = time.perf_counter() - t0
    finite = lambda d: {k: (float(v) if np.isfinite(v) else None) for k, v in d.items()}
    results = {k: finite(v) for k, v in results.items()}
    last = np.asarray(timer.seconds[-1000:]) * 1e3
    payload = {
        "config": ("image_joint_r50 at full width" if args.flagship
                   else "tiny_test_config") + ", trained from scratch",
        "device": card(device), "seed": args.seed, "steps": args.steps,
        "n_train": args.n_train, "n_val": args.n_val,
        "bbox": results["bbox"], "segm": results["segm"],
        "coco_det_ap": results["bbox"]["AP"], "coco_det_ap50": results["bbox"]["AP50"],
        "coco_segm_ap": results["segm"]["AP"],
        "train_seconds": train_s, "eval_seconds": eval_s,
        "step_ms": {"median": float(np.median(last)), "min": float(last.min()),
                    "max": float(last.max()), "steps": len(last),
                    "first_step": timer.seconds[0] * 1e3},
        "train_peak_gib": peak,
        "eval_seconds_per_image": image_seconds(times),
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
