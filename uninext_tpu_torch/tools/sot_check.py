"""SOT AUC and VOS J&F of a config trained from scratch on the in-repo
single-object mini-YTVIS fixture: the protocol of `tools/real_sot_check.py`
on the port.

    python -m uninext_tpu_torch.tools.sot_check [--seeds 3] [--steps 800]
        [--flagship] [--out build/sot_check/tiny.json] [--device cuda]

mini-YTVIS JPEG frames and json (`data/mini_coco.py:make_mini_ytvis`, data
seed 0, one object a video: 8 train and 4 val videos of 8 frames at
192x256) -> `load_ytvis_json` -> `VideoPairMapper` (frame range 7, masks)
-> `MultiDatasetLoader` (bs=2, 2 threads, the batches routed to the task
"sot", seeded with the run's seed) -> `Trainer(video=True, task="sot")`
(`forward_sot_train`: the ref frame's template crop as the prompt of a
grounding pass on the key frame) -> on every val video, from its first
frame's gt box, `SOTDriver` -> `evaluate_sot` (AUC, P at 20 px), and from
its first frame's gt mask, `VOSDriver` -> `evaluate_davis` (J&F).

The config is that of `tools/_evidence_common.py:build_tiny_cfg(steps,
frame_range=7)`: `tiny_test_config` (R50 at full width, 2+2 layers of width
64, 60 queries; 3-channel templates through the main backbone, each level
resized to 8x8), at most 8 instances, 192x256 images, lr 3e-4 for every
group, 40 warm-up updates, clip 1.0, a 10x decay at 80% of the steps. With
`--flagship` it is `video_joint_r50` at full width (R50, frozen 12-layer
BERT, 6+6 layers, 900 queries, the deformable reid head, the 4-channel
template R50 and the P3-P6 fuser: 1024-token prompts) with the data and
schedule settings of `tools/vis_check.py --flagship` at frame range 7. As
in the JAX tool, seed s seeds the loader and the weights are the same for
every seed (seed 0).

The JSON written to `--out` holds, per seed, AUC, P, Pnorm and J&F with
each val video's, the step times (host clock to the end of each step's
device work), the seconds of training and evaluation and the peak device
memory, with the device's name and power limit. Runs on the card unless
`--device cpu`.
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
from ..data.video import VideoPairMapper, load_ytvis_json
from ..engine.sot_inference import SOTDriver, VOSDriver
from ..engine.trainer import Trainer
from ..evaluation.davis_eval import evaluate_davis
from ..evaluation.sot_eval import evaluate_sot, evaluate_sot_dataset
from .ap_check import REPO, StepLog, card
from .evidence import (H, W, build_tiny_cfg, frames_of, peak_gib, scaled_track_gt,
                       step_summary)

FRAME_RANGE = 7


def build_cfg(steps: int, flagship: bool = False) -> UninextConfig:
    """`tools/_evidence_common.py:build_tiny_cfg(steps, frame_range=7)`, or
    with `flagship` `video_joint_r50` at full width with `tools/vis_check.py
    --flagship`'s data and schedule changes."""
    if flagship:
        cfg = video_joint_r50()
        return dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, max_insts=8, min_size_train=(H,),
                                     max_size_train=W, min_size_test=H, max_size_test=W,
                                     sampling_frame_range=FRAME_RANGE),
            solver=dataclasses.replace(cfg.solver, base_lr=1e-4, vl_lr=1e-4,
                                       warmup_iters=50, max_iter=steps,
                                       checkpoint_period=10 ** 9,
                                       steps=(int(steps * 0.8),)))
    return build_tiny_cfg(steps, frame_range=FRAME_RANGE)


def eval_sot_vos(model, cfg, val_recs, device):
    """Every val video tracked from its first frame's gt box (`SOTDriver`)
    and segmented from its first frame's gt mask (`VOSDriver`). Returns
    ({AUC, P, Pnorm}, mean J&F, per-video records)."""
    img_masks = np.zeros((1, H, W), bool)
    sizes = np.array([[H, W]], np.int64)
    sot = SOTDriver(model, cfg, device=device)
    vos = VOSDriver(model, cfg, device=device)
    per_seq, per_video = {}, []
    for rec in val_recs:
        frames = frames_of(rec)
        gt_xywh, init_xyxy, gt_masks = scaled_track_gt(rec, H, W)
        t0 = time.perf_counter()
        boxes, _ = sot.run_video(frames, img_masks, sizes, init_xyxy)
        sot_s = time.perf_counter() - t0
        name = f"vid{rec['video_id']}"
        pred = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2] - boxes[:, 0],
                         boxes[:, 3] - boxes[:, 1]], 1)
        per_seq[name] = {"pred": pred, "gt": gt_xywh}
        init = {1: {"frame": 0, "mask": gt_masks[0].astype(np.float32),
                    "box_xyxy": init_xyxy}}
        t0 = time.perf_counter()
        labels = vos.run_video(frames, img_masks, sizes, init)
        vos_s = time.perf_counter() - t0
        jf = evaluate_davis({1: [l == 1 for l in labels]}, {1: gt_masks})["J&F"]
        m = evaluate_sot(pred, gt_xywh)
        per_video.append({"video": name, "AUC": m["AUC"], "P": m["P"], "J&F": jf,
                          "sot_seconds": sot_s, "vos_seconds": vos_s})
    return (evaluate_sot_dataset(per_seq), float(np.mean([v["J&F"] for v in per_video])),
            per_video)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--flagship", action="store_true",
                    help="video_joint_r50 at full width; else the small config")
    ap.add_argument("--n-train", type=int, default=8)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="default: build/sot_check/<flagship|tiny>.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sot_check: no CUDA device (pass --device cpu for the CPU)")
    name = "flagship" if args.flagship else "tiny"
    out = Path(args.out or REPO / "build" / "sot_check" / f"{name}.json")
    cfg = build_cfg(args.steps, args.flagship)
    per_seed = []
    with tempfile.TemporaryDirectory(prefix="mini_sot_") as root:
        paths = make_mini_ytvis(os.path.join(root, "data"), n_train=args.n_train,
                                n_val=args.n_val, length=8, max_objects=1)
        train_recs, cats = load_ytvis_json(paths["train_json"], paths["train_root"])
        val_recs, _ = load_ytvis_json(paths["val_json"], paths["val_root"])
        mapper = VideoPairMapper(cfg.data, cats, is_train=True, with_masks=True,
                                 sampling_frame_range=FRAME_RANGE)
        for seed in range(args.seeds):
            loader = MultiDatasetLoader([(train_recs, mapper, 2, "sot")], [1.0], seed=seed,
                                        num_workers=2)
            batches = iter(loader)
            timer = StepLog()
            trainer = Trainer(cfg, batches, output_dir=os.path.join(root, f"run{seed}"),
                              task="sot", has_masks=True, device=device, seed=0,
                              video=True, log_period=50, extra_hooks=[timer])
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            trainer.train()
            train_s = time.perf_counter() - t0
            batches.close()             # stops the loader's mapping threads
            peak = peak_gib(device)
            t0 = time.perf_counter()
            agg, jf, per_video = eval_sot_vos(trainer.model.eval(), cfg, val_recs, device)
            eval_s = time.perf_counter() - t0
            per_seed.append({
                "seed": seed, "sot_auc": agg["AUC"], "sot_precision": agg["P"],
                "sot_pnorm": agg["Pnorm"], "vos_jf": jf, "per_video": per_video,
                "train_seconds": train_s, "eval_seconds": eval_s,
                "step_ms": step_summary(timer.seconds),
                "final_total_loss": timer.total_loss[-1], "train_peak_gib": peak})
            print(f"[sot_check] seed {seed}: {args.steps} sot steps in {train_s:.1f} s, "
                  f"AUC {agg['AUC']:.4f}, P {agg['P']:.4f}, J&F {jf:.4f}", flush=True)
            del trainer
    mean = lambda k: float(np.mean([r[k] for r in per_seed]))
    payload = {
        "config": ("video_joint_r50 at full width (4-channel template R50, fuser)"
                   if args.flagship else "tiny_test_config (build_tiny_cfg, frame range 7)")
        + ", trained from scratch",
        "device": card(device), "steps": args.steps,
        "n_train_videos": len(train_recs), "n_val_videos": len(val_recs),
        "pipeline": "jpeg frames->VideoPairMapper->Trainer(video, sot: forward_sot_train)->"
                    "SOTDriver AUC/P + VOSDriver J&F",
        "per_seed": per_seed,
        "mean": {"sot_auc": mean("sot_auc"), "sot_precision": mean("sot_precision"),
                 "vos_jf": mean("vos_jf")}}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
