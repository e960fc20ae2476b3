"""A copy of `uninext_tpu/evaluation/sot_eval.py` (the port imports nothing
of the JAX package).

SOT evaluation: success / precision curves + AUC (OPE protocol).

Parity: the reference vendors a ~7.9k-LoC SOT toolkit (external/lib,
SURVEY §2 Aux) whose core metrics are: per-frame IoU between predicted and
gt boxes -> success rate over IoU thresholds [0:0.05:1] (AUC = mean),
center-error precision at 20px, and normalized precision. Re-implemented
vectorized; result txt files keep the reference's one-box-per-line format
so the official analysis scripts remain usable.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def _iou_1to1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) xywh vs (N, 4) xywh -> (N,)."""
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_sot(pred_xywh: np.ndarray, gt_xywh: np.ndarray,
                 visible: np.ndarray | None = None) -> Dict[str, float]:
    """One sequence: (T, 4) boxes in xywh. Returns AUC / P / Pnorm."""
    if visible is None:
        visible = (gt_xywh[:, 2] > 0) & (gt_xywh[:, 3] > 0)
    p = pred_xywh[visible]
    g = gt_xywh[visible]
    if len(g) == 0:
        return {"AUC": float("nan"), "P": float("nan"), "Pnorm": float("nan")}
    ious = _iou_1to1(p, g)
    thr = np.arange(0, 1.05, 0.05)
    success = (ious[:, None] > thr[None]).mean(0)
    pc = p[:, :2] + p[:, 2:] / 2
    gc = g[:, :2] + g[:, 2:] / 2
    err = np.linalg.norm(pc - gc, axis=1)
    norm_err = np.linalg.norm((pc - gc) / np.maximum(g[:, 2:], 1e-9), axis=1)
    prec_thr = np.arange(0, 51, 1)
    nprec_thr = np.arange(0, 0.51, 0.01)
    precision = (err[:, None] <= prec_thr[None]).mean(0)
    nprecision = (norm_err[:, None] <= nprec_thr[None]).mean(0)
    return {"AUC": float(success.mean()),
            "P": float(precision[20]),
            "Pnorm": float(nprecision.mean())}


def evaluate_sot_dataset(per_seq: Dict[str, Dict[str, np.ndarray]]
                         ) -> Dict[str, float]:
    """per_seq: {name: {"pred": (T,4) xywh, "gt": (T,4) xywh}}."""
    metrics = [evaluate_sot(v["pred"], v["gt"],
                            v.get("visible")) for v in per_seq.values()]
    out = {}
    for k in ("AUC", "P", "Pnorm"):
        vals = [m[k] for m in metrics if np.isfinite(m[k])]
        out[k] = float(np.mean(vals)) if vals else float("nan")
    return out


def save_sot_results(output_dir: str, video: str, boxes_xyxy: np.ndarray,
                     times: np.ndarray | None = None) -> None:
    """Reference-format result files: '<vid>.txt' with x,y,w,h per line and
    '<vid>_time.txt' per-frame seconds (uninext_vid.py:545-546)."""
    os.makedirs(output_dir, exist_ok=True)
    xywh = boxes_xyxy.copy()
    xywh[:, 2:] = xywh[:, 2:] - xywh[:, :2]
    np.savetxt(os.path.join(output_dir, f"{video}.txt"), xywh,
               fmt="%.2f", delimiter=",")
    if times is not None:
        np.savetxt(os.path.join(output_dir, f"{video}_time.txt"), times,
                   fmt="%.6f")
