"""What the fixture tools share (`tools/_evidence_common.py`'s port): the
small config (`build_tiny_cfg`), video frames of the mini-YTVIS fixtures at
the network's size (`frames_of`), a track's gt at a frame size
(`scaled_track_gt`), result ids back to the gt json's (`remap_result_ids`),
and two of the evaluation loops, QDTrack's MOT (`eval_mot`) and R-VOS
(`eval_rvos`), and the summaries of a run (`step_summary`, `peak_gib`,
`finite`). The VIS and SOT/VOS loops are `tools/vis_check.py:eval_vis`
and `tools/sot_check.py:eval_sot_vos`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from PIL import Image

from ..config import UninextConfig, tiny_test_config
from ..data.masks import polygons_to_mask
from ..data.prompts import create_label_token_map
from ..data.tokenizer import BertTokenizer
from ..engine.mot_inference import MOTDriver, RVOSDriver
from ..evaluation.davis_eval import evaluate_davis
from ..evaluation.mot_eval import evaluate_mot, pool_mot_metrics

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
H, W = 192, 256                 # the mini-YTVIS fixtures' frame size


def build_tiny_cfg(steps: int, min_size: int = H, max_size: int = W,
                   frame_range=None, use_reid: bool = False) -> UninextConfig:
    """`tools/_evidence_common.py:build_tiny_cfg`: `tiny_test_config` with
    one resolution bucket (`min_size` x at most `max_size`), at most 8
    instances, a 32-token prompt and a short schedule: lr 3e-4 for every
    group, 40 warm-up updates, clip 1.0, `steps` updates with a 10x decay at
    80% of them, no periodic checkpoint."""
    cfg = tiny_test_config()
    data = dataclasses.replace(
        cfg.data, max_insts=8, max_text_len=32, min_size_train=(min_size,),
        max_size_train=max_size, min_size_test=min_size, max_size_test=max_size,
        **({"sampling_frame_range": frame_range} if frame_range else {}))
    return dataclasses.replace(
        cfg, use_reid=use_reid, data=data,
        solver=dataclasses.replace(cfg.solver, base_lr=3e-4, lang_lr=3e-4, vl_lr=3e-4,
                                   backbone_multiplier=1.0, warmup_iters=40,
                                   grad_clip=1.0, max_iter=steps,
                                   checkpoint_period=10 ** 9,
                                   steps=(int(steps * 0.8),)))


def frames_of(rec):
    """A video record's frames, normalised, each (1, H, W, 3) (the fixture
    writes them at the network's size)."""
    return [((np.asarray(Image.open(fp).convert("RGB"), np.float32) - MEAN) / STD)[None]
            for fp in rec["file_names"]]


def remap_result_ids(results, gt):
    """Prediction category ids (contiguous index + 1, video_output_to_ytvis)
    -> the gt json's dataset ids."""
    id_map = {i + 1: c["id"] for i, c in enumerate(
        sorted(gt["categories"], key=lambda c: c["id"]))}
    return [{**r, "category_id": id_map.get(r["category_id"], r["category_id"])}
            for r in results]


def scaled_track_gt(rec, h, w):
    """The first track of a video record at an (h, w) frame size: gt boxes
    xywh (T, 4), the first frame's box xyxy and the per-frame boolean
    masks."""
    track = rec["tracks"][0]
    sx, sy = w / rec["width"], h / rec["height"]
    gt_xywh = np.array([[b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy]
                        for b in track["bboxes"]], np.float32)
    init_xyxy = np.array([gt_xywh[0, 0], gt_xywh[0, 1], gt_xywh[0, 0] + gt_xywh[0, 2],
                          gt_xywh[0, 1] + gt_xywh[0, 3]], np.float32)
    gt_masks = []
    for fi in range(rec["length"]):
        segs = track["segmentations"][fi]
        m = (polygons_to_mask([np.array(s) * np.array([sx, sy] * (len(s) // 2))
                               for s in segs], h, w)
             if segs else np.zeros((h, w), np.uint8))
        gt_masks.append(m.astype(bool))
    return gt_xywh, init_xyxy, gt_masks


def step_summary(seconds):
    """Median, range and first of the steps' host times, in ms."""
    ms = np.asarray(seconds) * 1e3
    return {"median": float(np.median(ms)), "min": float(ms.min()), "max": float(ms.max()),
            "first_step": float(ms[0]), "steps": len(ms)}


def peak_gib(device):
    """The peak device memory since the last reset, GiB (None on the CPU)."""
    return (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)


def finite(d):
    """A metric dict's numbers as floats, None where not finite."""
    return {k: (float(v) if np.isfinite(v) else None) for k, v in d.items()
            if isinstance(v, (int, float, np.floating))}


def _frame_inputs():
    return np.zeros((1, H, W), bool), np.array([[H, W]], np.int64)


def eval_mot(model, cfg, val_recs, cats, device):
    """QDTrack association (`MOTDriver`) over every val video; CLEAR-MOT
    metrics pooled over the sequences (MOTA, IDF1, ...)."""
    ids, tmask, cmap = create_label_token_map(cats, BertTokenizer(), cfg.data.max_text_len)
    drv = MOTDriver(model.eval(), cfg, cmap, device=device)
    img_masks, sizes = _frame_inputs()
    per_seq = []
    for rec in val_recs:
        pred = drv.run_video(frames_of(rec), img_masks, sizes, ids[None], tmask[None],
                             ori_size=(rec["height"], rec["width"]))
        gt_frames, pred_frames = [], []
        for fi in range(rec["length"]):
            gid, boxes = [], []
            for ti, tr in enumerate(rec["tracks"]):
                b = tr["bboxes"][fi] if fi < len(tr["bboxes"]) else None
                if b is not None:
                    gid.append(ti)
                    boxes.append([b[0], b[1], b[0] + b[2], b[1] + b[3]])
            gt_frames.append({"ids": np.array(gid, np.int64),
                              "boxes": np.array(boxes, np.float64).reshape(-1, 4)})
            dets = pred[fi]
            pred_frames.append({
                "ids": np.array([d["id"] for d in dets], np.int64),
                "boxes": np.array([d["box_xyxy"] for d in dets], np.float64).reshape(-1, 4)})
        per_seq.append(evaluate_mot(gt_frames, pred_frames))
    return pool_mot_metrics(per_seq)


def eval_rvos(model, cfg, val_recs, device) -> float:
    """Referring VOS over every val video (records of
    `load_ytvis_json(..., has_expression=True)`): its first expression's
    prompt, the per-frame top-1 mask (`RVOSDriver`), J&F against the
    referred track's gt masks at the original size; the mean J&F."""
    tok = BertTokenizer()
    drv = RVOSDriver(model.eval(), cfg, device=device)
    img_masks, sizes = _frame_inputs()
    jf_all = []
    for rec in val_recs:
        t = tok(rec["expressions"][0], max_length=cfg.data.max_text_len)
        lang = drv.encode_prompt(t["input_ids"][None], t["attention_mask"][None])
        pred = drv.run_video(frames_of(rec), img_masks, sizes, lang["hidden"], lang["masks"],
                             ori_size=(rec["height"], rec["width"]))
        _, _, gt_masks = scaled_track_gt(rec, rec["height"], rec["width"])
        jf_all.append(evaluate_davis({1: [m.astype(bool) for m in pred]},
                                     {1: gt_masks})["J&F"])
    return float(np.mean(jf_all))
