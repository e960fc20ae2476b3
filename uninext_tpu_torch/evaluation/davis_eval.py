"""A copy of `uninext_tpu/evaluation/davis_eval.py` (the port imports
nothing of the JAX package).

DAVIS VOS evaluation: region similarity J and contour accuracy F.

Parity: the reference vendors external/davis2017-evaluation (J&F protocol):
  J = per-frame mask IoU; F = boundary F-measure via bipartite matching of
  dilated contours; J&F = mean of both, averaged over objects and frames
  (first and last annotated frames excluded).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _seg_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return float(inter / union)


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Binary boundary map (4-neighbour difference)."""
    m = mask.astype(bool)
    pad = np.zeros((m.shape[0] + 2, m.shape[1] + 2), bool)
    pad[1:-1, 1:-1] = m
    b = (m & ~(pad[:-2, 1:-1] & pad[2:, 1:-1]
               & pad[1:-1, :-2] & pad[1:-1, 2:]))
    return b


def _dilate(b: np.ndarray, r: int) -> np.ndarray:
    out = b.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = np.zeros_like(b)
            ys = slice(max(dy, 0), b.shape[0] + min(dy, 0))
            yd = slice(max(-dy, 0), b.shape[0] + min(-dy, 0))
            xs = slice(max(dx, 0), b.shape[1] + min(dx, 0))
            xd = slice(max(-dx, 0), b.shape[1] + min(-dx, 0))
            shifted[yd, xd] = b[ys, xs]
            out |= shifted
    return out


def f_measure(pred: np.ndarray, gt: np.ndarray,
              bound_ratio: float = 0.008) -> float:
    """Boundary F-measure (davis2017-evaluation f_boundary semantics)."""
    bp = _boundary(pred)
    bg = _boundary(gt)
    r = max(1, int(round(bound_ratio * np.hypot(*pred.shape))))
    bp_d = _dilate(bp, r)
    bg_d = _dilate(bg, r)
    n_p, n_g = bp.sum(), bg.sum()
    if n_p == 0 and n_g == 0:
        return 1.0
    if n_p == 0 or n_g == 0:
        return 0.0
    precision = (bp & bg_d).sum() / n_p
    recall = (bg & bp_d).sum() / n_g
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_davis(pred_masks: Dict[int, List[np.ndarray]],
                   gt_masks: Dict[int, List[np.ndarray]]) -> Dict[str, float]:
    """pred/gt: {object_id: [per-frame binary mask]}. First/last frames
    excluded per protocol. Returns J, F, J&F."""
    js, fs = [], []
    for oid, gts in gt_masks.items():
        preds = pred_masks.get(oid, [np.zeros_like(g) for g in gts])
        seq_j = [_seg_iou(p, g) for p, g in zip(preds[1:-1], gts[1:-1])]
        seq_f = [f_measure(p, g) for p, g in zip(preds[1:-1], gts[1:-1])]
        if seq_j:
            js.append(np.mean(seq_j))
            fs.append(np.mean(seq_f))
    J = float(np.mean(js)) if js else float("nan")
    F = float(np.mean(fs)) if fs else float("nan")
    return {"J": J, "F": F, "J&F": (J + F) / 2}


def davis_palette() -> np.ndarray:
    """The DAVIS/PASCAL-VOC 256x3 colormap (bit-reversal construction) used
    by the official annotation PNGs and expected of submissions."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def save_davis_png(id_mask: np.ndarray, path: str) -> str:
    """(H, W) uint8 object-id label map -> palette ('P' mode) PNG, the
    format the DAVIS evaluator and eval server read
    (reference uninext_vid.py VOS output path)."""
    import os
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = Image.fromarray(id_mask.astype(np.uint8), mode="P")
    img.putpalette(davis_palette().ravel().tolist())
    img.save(path)
    return path


def load_davis_png(path: str) -> np.ndarray:
    """Palette PNG -> (H, W) uint8 id map (inverse of save_davis_png)."""
    from PIL import Image
    return np.asarray(Image.open(path), np.uint8)
