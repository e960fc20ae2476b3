"""The R-VOS diagnostic on the port: the protocol of `tools/rvos_diag.py`.
It splits the R-VOS J&F of a grounding-trained model into selection (does
the referring pathway pick the referred object?), mask quality given the
selection, and `RVOSDriver`'s output.

    python -m uninext_tpu_torch.tools.rvos_diag [--steps 500 1500]
        [--train-videos 8] [--temporal-weights 0 0.3] [--seed 0]
        [--out build/rvos_diag/RVOS_DIAG.json] [--merge] [--device cuda]

The fixture is the joint fixture's R-VOS one: `make_mini_ytvis(n_train=
--train-videos, length=6, max_objects=3, seed=37, referring=True)`. Each
video has 2-3 objects of distinct categories, and only the first is
annotated and referred to. The other split is 4 val videos of 6 frames at
192x256. Per `--steps` value, the small config
(`tools/_evidence_common.py:build_tiny_cfg(steps, frame_range=7,
use_reid=True)`) trains on grounding only: `VideoPairMapper` (frame range
5), a `MultiDatasetLoader` at bs 2, and `Trainer(video=True,
task="grounding")` with masks. Then, per `--temporal-weights` value, the
same checkpoint is evaluated: `eval_rvos` (the network-scale J&F) and
`decompose`.

Differences from the JAX tool, by intent:
- `--device` picks cpu or cuda (the card, the default);
- `--out` defaults to build/rvos_diag/RVOS_DIAG.json, so the JAX record
  at the repository's root is never overwritten;
- `--seed` (default 0, the JAX tool's fixed order) seeds the loader's order
  and the model's init; its arms' specs end in `_s<seed>` for a seed
  other than 0, so that `--merge` keeps every seed;
- the JAX tool's `capstone_anchor` (its joint run's J&F) is written as
  `jax_capstone_anchor`: they are the JAX package's numbers, not the
  port's;
- each arm also keeps its per-frame figures (`per_frame`: the selection
  IoU and mask J of every val frame, each video's driver J&F), which say
  which frames a wrong selection hit.
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
from PIL import Image

from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_ytvis
from ..data.tokenizer import BertTokenizer
from ..data.video import VideoPairMapper, load_ytvis_json
from ..engine.mot_inference import RVOSDriver
from ..engine.trainer import Trainer
from ..evaluation.davis_eval import evaluate_davis
from .ap_check import REPO, card
from .cli_common import add_device_arg, device_of
from .evidence import H, W, build_tiny_cfg, eval_rvos, frames_of, scaled_track_gt

# the JAX tool's anchor: the joint run's R-VOS and VOS J&F and its
# grounding steps (JOINTRESULT.json), not numbers of the port
JAX_CAPSTONE_ANCHOR = {"joint_rvos_jf": 0.3087, "joint_vos_jf": 0.9543,
                       "grounding_steps_in_capstone": 475}


def iou_xyxy(a, b):
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    ar_a = (a[2] - a[0]) * (a[3] - a[1])
    ar_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ar_a + ar_b - inter, 1e-9)


def decompose(model, cfg, val_recs, h=H, w=W, device="cuda", per_frame=None):
    """Per-frame selection and mask quality (`tools/rvos_diag.py:
    decompose`): the R-VOS frame step (`make_rvos_frame_step`, through
    `RVOSDriver.run_expression`, the chosen embedding chained from frame
    to frame) on each val video's first expression. A frame's selection is
    the IoU of the chosen box with the referred object's gt box; its mask J
    is the chosen mask logits, resized bilinearly to (h, w) and cut at 0,
    against the gt mask. Then `RVOSDriver` end to end (`run_video`, masks at
    the original size) scored by `evaluate_davis`. Frames are (1, h, w, 3)
    as the fixture wrote them. A list given as `per_frame` gets each
    frame's (video, frame, selection IoU, mask J), and each video's driver
    J&F under frame None."""
    tok = BertTokenizer()
    drv = RVOSDriver(model.eval(), cfg, device=device)
    img_masks = np.zeros((1, h, w), bool)
    sizes = np.array([[h, w]], np.int64)
    sel_iou, j_sel, j_all, jf_all = [], [], [], []
    for rec in val_recs:
        t = tok(rec["expressions"][0], max_length=cfg.data.max_text_len)
        lang = drv.encode_prompt(t["input_ids"][None], t["attention_mask"][None])
        gt_xywh, _, gt_masks = scaled_track_gt(rec, h, w)
        frames = frames_of(rec)
        for fi, r in enumerate(drv.run_expression(frames, img_masks, sizes, lang["hidden"],
                                                  lang["masks"])):
            cx, cy, bw, bh = np.asarray(r["box_cxcywh"][0], np.float32)
            pred = np.array([(cx - bw / 2) * w, (cy - bh / 2) * h,
                             (cx + bw / 2) * w, (cy + bh / 2) * h])
            g = gt_xywh[fi]
            iou = iou_xyxy(pred, np.array([g[0], g[1], g[0] + g[2], g[1] + g[3]]))
            sel_iou.append(iou)
            logit = np.asarray(r["mask_logits"][0], np.float32)
            m = np.asarray(Image.fromarray(logit).resize((w, h), Image.BILINEAR)) > 0
            j = (m & gt_masks[fi]).sum() / max((m | gt_masks[fi]).sum(), 1)
            j_all.append(j)
            if iou >= 0.5:
                j_sel.append(j)
            if per_frame is not None:
                per_frame.append({"video": rec["video_id"], "frame": fi,
                                  "selection_iou": round(float(iou), 4),
                                  "mask_j": round(float(j), 4)})
        pred_masks = drv.run_video(frames, img_masks, sizes, lang["hidden"], lang["masks"],
                                   ori_size=(rec["height"], rec["width"]))
        _, _, gt_ori = scaled_track_gt(rec, rec["height"], rec["width"])
        jf_all.append(evaluate_davis({1: [m.astype(bool) for m in pred_masks]},
                                     {1: gt_ori})["J&F"])
        if per_frame is not None:
            per_frame.append({"video": rec["video_id"], "frame": None,
                              "driver_jf": round(float(jf_all[-1]), 4)})
    return {
        "selection_acc_iou50": round(float(np.mean([i >= 0.5 for i in sel_iou])), 4),
        "mean_selection_iou": round(float(np.mean(sel_iou)), 4),
        "mask_j_all_frames": round(float(np.mean(j_all)), 4),
        "mask_j_when_selected": round(float(np.mean(j_sel)), 4) if j_sel else None,
        "driver_jf": round(float(np.mean(jf_all)), 4),
        "n_frames": len(sel_iou),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", nargs="+", type=int, default=[500, 1500])
    ap.add_argument("--train-videos", type=int, default=8,
                    help="train videos of the fixture (its val split stays 4 videos)")
    ap.add_argument("--temporal-weights", nargs="+", type=float, default=[0.0],
                    help="rvos_temporal_weight values, each evaluated on the same "
                         "checkpoint")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the loader's order and the model's init")
    ap.add_argument("--out", default=str(REPO / "build" / "rvos_diag" / "RVOS_DIAG.json"))
    ap.add_argument("--merge", action="store_true", help="keep arms already recorded in --out")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    payload = {"jax_capstone_anchor": JAX_CAPSTONE_ANCHOR, "device": card(device),
               "arms": []}
    with tempfile.TemporaryDirectory(prefix="rvosdiag_") as root:
        paths = make_mini_ytvis(os.path.join(root, "data"), n_train=args.train_videos,
                                length=6, max_objects=3, seed=37, referring=True)
        train, cats = load_ytvis_json(paths["train_json"], paths["train_root"],
                                      has_expression=True)
        val, _ = load_ytvis_json(paths["val_json"], paths["val_root"], has_expression=True)
        tok = BertTokenizer()
        for steps in args.steps:
            cfg = build_tiny_cfg(steps, frame_range=7, use_reid=True)
            mapper = VideoPairMapper(cfg.data, cats, tok, sampling_frame_range=5)
            batches = iter(MultiDatasetLoader([(train, mapper, 2, "grounding")], [1.0],
                                              seed=args.seed, num_workers=2))
            t0 = time.perf_counter()
            tr = Trainer(cfg, batches, output_dir=os.path.join(root, f"run{steps}"),
                         task="grounding", has_masks=True, device=device, seed=args.seed,
                         video=True, log_period=100)
            tr.train()
            secs = time.perf_counter() - t0
            batches.close()             # stops the loader's mapping threads
            for tw in args.temporal_weights:
                cfg_w = dataclasses.replace(cfg, rvos_temporal_weight=tw)
                jf = eval_rvos(tr.model, cfg_w, val, device)
                frames = []
                dec = decompose(tr.model, cfg_w, val, device=device, per_frame=frames)
                arm = {"spec": f"grounding_single@{steps}"
                       + (f"_tv{args.train_videos}" if args.train_videos != 8 else "")
                       + (f"_tw{tw}" if tw else "")
                       + (f"_s{args.seed}" if args.seed else ""),
                       "train_videos": len(train), "temporal_weight": tw,
                       "seed": args.seed, "train_seconds": round(secs, 1),
                       "rvos_jf_network_scale": round(jf, 4), **dec}
                print(f"[arm] {arm}", flush=True)
                arm["per_frame"] = frames
                payload["arms"].append(arm)
            del tr
    out = Path(args.out)
    if args.merge and out.exists():
        prev = json.loads(out.read_text())
        done = {a["spec"] for a in payload["arms"]}
        payload["arms"] = [a for a in prev.get("arms", [])
                           if a["spec"] not in done] + payload["arms"]
        if "conclusion" in prev:
            payload["r4_conclusion"] = prev["conclusion"]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
