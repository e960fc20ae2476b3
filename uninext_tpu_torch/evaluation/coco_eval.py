"""A copy of `uninext_tpu/evaluation/coco_eval.py` (the port imports nothing
of the JAX package), whose evaluator also takes the matcher.

COCO mAP evaluation (host-side, self-contained).

Replaces the reference's COCOEvaluator + COCOeval_opt
(detectron2/evaluation/coco_evaluation.py, layers/csrc/cocoeval/ — SURVEY N5)
with the standard COCOeval protocol: greedy score-ordered IoU matching per
(image, category, area-range) with ignored-gt semantics, 10 IoU thresholds
.5:.05:.95, 101-point interpolated PR curves, maxDets=100. The hot matching
loop runs in C++ (evaluation/cocoeval_cpp via fast_eval.coco_match).

Also implements the RefCOCO metrics (P@0.5 / oIoU) from
detectron2/evaluation/coco_evaluation.py:407 `_derive_refcoco_results`.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..data.masks import mask_iou
from .fast_eval import coco_match

IOU_THRS = np.linspace(0.5, 0.95, 10).astype(np.float32)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {"all": (0.0, 1e10), "small": (0.0, 32.0 ** 2),
             "medium": (32.0 ** 2, 96.0 ** 2), "large": (96.0 ** 2, 1e10)}


def box_iou_xyxy(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)), np.float32)
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    return (inter / np.maximum(area_d[:, None] + area_g[None] - inter, 1e-9)
            ).astype(np.float32)


class COCOEvaluator:
    """Accumulates per-image predictions; computes AP/AP50/AP75/APs/m/l.

    add(gt, pred) per image with dict(boxes (N,4) xyxy abs, scores, classes,
    [masks list of (H,W) bool], gt additionally [areas]). `matcher` is the
    greedy matching core: the C++ `coco_match`, or `coco_match_numpy`."""

    def __init__(self, iou_type: str = "bbox", max_dets: int = 100,
                 matcher: Callable = coco_match):
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.matcher = matcher
        self._preds: List[Dict] = []
        self._gts: List[Dict] = []

    def add(self, gt: Dict, pred: Dict):
        self._gts.append(gt)
        self._preds.append(pred)

    def _iou(self, pred, gt):
        if self.iou_type == "bbox":
            return box_iou_xyxy(pred["boxes"], gt["boxes"])
        if len(pred.get("masks", [])) == 0 or len(gt.get("masks", [])) == 0:
            return np.zeros((len(pred["boxes"]), len(gt["boxes"])), np.float32)
        return mask_iou(np.stack(pred["masks"]),
                        np.stack(gt["masks"])).astype(np.float32)

    def evaluate(self) -> Dict[str, float]:
        cats = sorted({int(c) for g in self._gts for c in g["classes"]})
        T, R, K, A = len(IOU_THRS), len(RECALL_THRS), len(cats), len(AREA_RNGS)
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))

        for ki, cat in enumerate(cats):
            per_img = []
            for gt, pred in zip(self._gts, self._preds):
                g_sel = np.asarray(gt["classes"]) == cat
                p_sel = np.asarray(pred["classes"]) == cat
                g_boxes = np.asarray(gt["boxes"], np.float32)[g_sel]
                g_areas = (np.asarray(gt["areas"])[g_sel]
                           if "areas" in gt else
                           (g_boxes[:, 2] - g_boxes[:, 0]) *
                           (g_boxes[:, 3] - g_boxes[:, 1]))
                p_boxes = np.asarray(pred["boxes"], np.float32)[p_sel]
                p_scores = np.asarray(pred["scores"], np.float32)[p_sel]
                order = np.argsort(-p_scores, kind="mergesort")[:self.max_dets]
                entry = {"g_boxes": g_boxes, "g_areas": g_areas,
                         "p_boxes": p_boxes[order],
                         "p_scores": p_scores[order]}
                if self.iou_type == "segm":
                    g_m = [m for m, s in zip(gt.get("masks", []), g_sel) if s]
                    p_m = [m for m, s in zip(pred.get("masks", []), p_sel) if s]
                    entry["g_masks"] = g_m
                    entry["p_masks"] = [p_m[i] for i in order]
                    entry["ious_full"] = self._iou(
                        {"boxes": p_boxes[order], "masks": entry["p_masks"]},
                        {"boxes": g_boxes, "masks": g_m})
                else:
                    entry["ious_full"] = box_iou_xyxy(p_boxes[order], g_boxes)
                per_img.append(entry)

            for ai, (aname, (lo, hi)) in enumerate(AREA_RNGS.items()):
                scores_all, tp_all, ig_all = [], [], []
                n_gt = 0
                for e in per_img:
                    g_ignore = ((e["g_areas"] < lo) | (e["g_areas"] > hi))
                    n_gt += int((~g_ignore).sum())
                    n_det = len(e["p_boxes"])
                    if n_det == 0:
                        continue
                    # order gts ignored-last (protocol requirement)
                    g_order = np.argsort(g_ignore, kind="mergesort")
                    ious = e["ious_full"][:, g_order]
                    gi = g_ignore[g_order].astype(np.uint8)
                    p_area = ((e["p_boxes"][:, 2] - e["p_boxes"][:, 0]) *
                              (e["p_boxes"][:, 3] - e["p_boxes"][:, 1]))
                    d_ig_mask = ((p_area < lo) | (p_area > hi)).astype(np.uint8)
                    det_match, det_ignore = self.matcher(
                        ious, gi, IOU_THRS, d_ig_mask)
                    tp_all.append(det_match >= 0)
                    ig_all.append(det_ignore.astype(bool))
                    scores_all.append(np.tile(e["p_scores"], (T, 1)))
                if n_gt == 0:
                    continue
                if not scores_all:
                    recall[:, ki, ai] = 0
                    precision[:, :, ki, ai] = 0
                    continue
                scores_cat = np.concatenate(scores_all, 1)
                tp_cat = np.concatenate(tp_all, 1)
                ig_cat = np.concatenate(ig_all, 1)
                for ti in range(T):
                    order = np.argsort(-scores_cat[ti], kind="mergesort")
                    tps = tp_cat[ti][order]
                    keep = ~ig_cat[ti][order]
                    tps = tps[keep].astype(np.float64)
                    tp_cum = np.cumsum(tps)
                    fp_cum = np.cumsum(1 - tps)
                    rc = tp_cum / n_gt
                    pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    recall[ti, ki, ai] = rc[-1] if len(rc) else 0
                    idx = np.searchsorted(rc, RECALL_THRS, side="left")
                    prec_at = np.zeros(len(RECALL_THRS))
                    ok = idx < len(pr)
                    prec_at[ok] = pr[idx[ok]]
                    precision[ti, :, ki, ai] = prec_at

        def mean_ap(t=None, area="all"):
            ai = list(AREA_RNGS).index(area)
            p = precision[:, :, :, ai]
            if t is not None:
                p = p[[int(round((t - 0.5) / 0.05))]]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else float("nan")

        return {
            "AP": mean_ap(), "AP50": mean_ap(0.5), "AP75": mean_ap(0.75),
            "APs": mean_ap(area="small"), "APm": mean_ap(area="medium"),
            "APl": mean_ap(area="large"),
        }


PRECISION_THRS = (0.5, 0.6, 0.7, 0.8, 0.9)


def refcoco_metrics(pred_boxes: np.ndarray, gt_boxes: np.ndarray
                    ) -> Dict[str, float]:
    """REC metrics: Precision@{0.5..0.9}, oIoU, mIoU over top-1 predictions.

    Parity: _derive_refcoco_results (coco_evaluation.py:407-445) — the
    reference reports P@{0.5,0.6,0.7,0.8,0.9} for boxes and oIoU/mIoU for
    masks; we report the full sweep for both modalities (strict `>` on the
    threshold, as the reference does)."""
    ious = np.array([box_iou_xyxy(pred_boxes[i:i + 1], gt_boxes[i:i + 1])[0, 0]
                     for i in range(len(gt_boxes))])
    lt = np.maximum(pred_boxes[:, :2], gt_boxes[:, :2])
    rb = np.minimum(pred_boxes[:, 2:], gt_boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = (wh[:, 0] * wh[:, 1]).sum()
    area_p = ((pred_boxes[:, 2] - pred_boxes[:, 0]) *
              (pred_boxes[:, 3] - pred_boxes[:, 1])).sum()
    area_g = ((gt_boxes[:, 2] - gt_boxes[:, 0]) *
              (gt_boxes[:, 3] - gt_boxes[:, 1])).sum()
    out = {f"P@{t}": float((ious > t).mean()) for t in PRECISION_THRS}
    out["oIoU"] = float(inter / max(area_p + area_g - inter, 1e-9))
    out["mIoU"] = float(ious.mean())
    return out


def refcoco_iou_metrics(ious: np.ndarray, inter_sum: float,
                        union_sum: float) -> Dict[str, float]:
    """Shared RES/REC summary from accumulated per-expression IoUs +
    pooled intersection/union areas: P@{0.5..0.9} + oIoU + mIoU
    (refcocoeval.py accumulates `iou_list`, `total_intersection_area`,
    `total_union_area`; coco_evaluation.py:440-446 derives the numbers)."""
    ious = np.asarray(ious, np.float64)
    out = {f"P@{t}": float((ious > t).mean()) for t in PRECISION_THRS}
    out["oIoU"] = float(inter_sum / max(union_sum, 1e-9))
    out["mIoU"] = float(ious.mean())
    return out
