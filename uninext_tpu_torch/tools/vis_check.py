"""Track mAP of a video config trained from scratch on the in-repo
mini-YTVIS fixture: the protocol of `tools/real_vis_check.py` on the port.

    python -m uninext_tpu_torch.tools.vis_check [--seeds 3] [--steps 1000]
        [--flagship] [--out build/vis_check/tiny.json] [--device cuda]

mini-YTVIS JPEG frames and json (`data/mini_coco.py:make_mini_ytvis`, data
seed 0: 32 train and 24 val videos of 6 frames at 192x256) ->
`load_ytvis_json` -> `VideoPairMapper` (frame range 5, masks) ->
`MultiDatasetLoader` (bs=2, 2 threads, seeded with the run's seed) ->
`Trainer(video=True)` -> `VISDriver` (IDOL) on every val video -> ytvis
result json -> `evaluate_ytvis` -> track mAP and AP50.

The config is that of `tools/_evidence_common.py:build_tiny_cfg(steps,
frame_range=5, use_reid=True)`: `tiny_test_config` with the reid head (no
deformable reid layers), at most 8 instances, a 32-token prompt, 192x256
images, lr 3e-4 for every group, 40 warm-up updates, clip 1.0, a 10x decay
at 80% of the steps. With `--flagship` it is `video_joint_r50` at full width
(R50, frozen 12-layer BERT, 6+6 layers, 900 queries, the deformable reid
head) with `tools/real_vis_check.py:flagship_cfg`'s changes. As in the JAX
tool, seed s seeds the loader (the order of the pairs and their
augmentation) and the weights are the same for every seed (seed 0).

The JSON written to `--out` holds, per seed, the ytvis metric dict, the
step times (host clock to the end of each step's device work) and the
seconds of training and evaluation, with the device's name and power
limit. Runs on the card unless `--device cpu`.
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

from ..config import UninextConfig, video_joint_r50
from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_ytvis
from ..data.prompts import create_label_token_map
from ..data.tokenizer import BertTokenizer
from ..data.video import VideoPairMapper, load_ytvis_json
from ..engine.trainer import Trainer
from ..engine.video_inference import VISDriver
from ..evaluation.ytvis_eval import evaluate_ytvis, video_output_to_ytvis
from .ap_check import REPO, StepLog, card
from .evidence import (H, W, build_tiny_cfg, finite, frames_of, peak_gib,
                       remap_result_ids, step_summary)


def build_cfg(steps: int, flagship: bool = False) -> UninextConfig:
    """`tools/_evidence_common.py:build_tiny_cfg(steps, frame_range=5,
    use_reid=True)`, or with `flagship` `tools/real_vis_check.py:
    flagship_cfg(steps)`."""
    if flagship:
        cfg = video_joint_r50()
        return dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, max_insts=8, min_size_train=(H,),
                                     max_size_train=W, min_size_test=H,
                                     max_size_test=W),
            solver=dataclasses.replace(cfg.solver, base_lr=1e-4, vl_lr=1e-4,
                                       warmup_iters=50, max_iter=steps,
                                       checkpoint_period=10 ** 9,
                                       steps=(int(steps * 0.8),)))
    return build_tiny_cfg(steps, frame_range=5, use_reid=True)


def eval_vis(model, cfg, val_recs, val_json, cats, device):
    """Every val video through `VISDriver`, the ytvis result json scored by
    `evaluate_ytvis`. Returns (metric dict, seconds per video)."""
    ids, tmask, cmap = create_label_token_map(cats, BertTokenizer(),
                                              cfg.data.max_text_len)
    drv = VISDriver(model.eval(), cfg, cmap, device=device)
    img_masks = np.zeros((1, H, W), bool)
    sizes = np.array([[H, W]], np.int64)
    results, seconds = [], []
    for rec in val_recs:
        t0 = time.perf_counter()
        out = drv.run_video(frames_of(rec), img_masks, sizes, ids[None], tmask[None],
                            ori_size=(rec["height"], rec["width"]))
        seconds.append(time.perf_counter() - t0)
        results.extend(video_output_to_ytvis(rec["video_id"], out))
    with open(val_json) as f:
        gt = json.load(f)
    return evaluate_ytvis(remap_result_ids(results, gt), gt), seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--flagship", action="store_true",
                    help="video_joint_r50 at full width; else the small config")
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="default: build/vis_check/<flagship|tiny>.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("vis_check: no CUDA device (pass --device cpu for the CPU)")
    name = "flagship" if args.flagship else "tiny"
    out = Path(args.out or REPO / "build" / "vis_check" / f"{name}.json")
    cfg = build_cfg(args.steps, args.flagship)
    per_seed = []
    with tempfile.TemporaryDirectory(prefix="mini_ytvis_") as root:
        paths = make_mini_ytvis(os.path.join(root, "data"), n_train=args.n_train,
                                n_val=args.n_val)
        train_recs, cats = load_ytvis_json(paths["train_json"], paths["train_root"])
        val_recs, _ = load_ytvis_json(paths["val_json"], paths["val_root"])
        mapper = VideoPairMapper(cfg.data, cats, is_train=True, with_masks=True,
                                 sampling_frame_range=5)
        for seed in range(args.seeds):
            loader = MultiDatasetLoader([(train_recs, mapper, 2)], [1.0], seed=seed,
                                        num_workers=2)
            batches = iter(loader)
            timer = StepLog()
            trainer = Trainer(cfg, batches, output_dir=os.path.join(root, f"run{seed}"),
                              task="detection", has_masks=True, device=device, seed=0,
                              video=True, log_period=50, extra_hooks=[timer])
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            trainer.train()
            train_s = time.perf_counter() - t0
            batches.close()             # stops the loader's mapping threads
            peak = peak_gib(device)
            t0 = time.perf_counter()
            res, video_s = eval_vis(trainer.model, cfg, val_recs, paths["val_json"],
                                    cats, device)
            eval_s = time.perf_counter() - t0
            res = finite(res)
            per_seed.append({
                "seed": seed, "vis_map": res["AP"], "vis_ap50": res["AP50"], "ytvis": res,
                "train_seconds": train_s, "eval_seconds": eval_s,
                "eval_seconds_per_video": float(np.mean(video_s)),
                "step_ms": step_summary(timer.seconds),
                "final_total_loss": timer.total_loss[-1], "train_peak_gib": peak})
            print(f"[vis_check] seed {seed}: {args.steps} pair steps in {train_s:.1f} s, "
                  f"track mAP {res['AP']}, AP50 {res['AP50']}", flush=True)
            del trainer
    maps = [r["vis_map"] for r in per_seed if r["vis_map"] is not None]
    payload = {
        "config": ("video_joint_r50 at full width" if args.flagship
                   else "tiny_test_config with the reid head (build_tiny_cfg)")
        + ", trained from scratch",
        "device": card(device), "steps": args.steps,
        "n_train_videos": len(train_recs), "n_val_videos": len(val_recs),
        "pipeline": "jpeg frames->VideoPairMapper->Trainer(video)->VISDriver(IDOL)->"
                    "ytvis json->evaluate_ytvis",
        "per_seed": per_seed,
        "vis_map_min": min(maps, default=None), "vis_map_max": max(maps, default=None)}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
