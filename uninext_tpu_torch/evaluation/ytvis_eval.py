"""A copy of `uninext_tpu/evaluation/ytvis_eval.py` (the port imports
nothing of the JAX package).

YouTube-VIS result formatting + offline evaluation helpers.

Parity: reference data/ytvis_eval.py:23 (YTVISEvaluator) and
instances_to_coco_json_video :216 — serializes per-video track predictions
into the YTVIS server json format:
  [{"video_id", "category_id", "score", "segmentations": [rle|null, ...]}]
so the official scorers / eval servers remain directly usable. The BDD100K
MOT/MOTS variants (:262, tools_bin converters) write the scalabel format.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def video_output_to_ytvis(video_id: int, video_output: Dict,
                          category_offset: int = 1) -> List[Dict]:
    """VISDriver output -> list of ytvis result records."""
    out = []
    for score, label, masks in zip(video_output["pred_scores"],
                                   video_output["pred_labels"],
                                   video_output["pred_masks"]):
        out.append({
            "video_id": video_id,
            "category_id": int(label) + category_offset,
            "score": float(score),
            "segmentations": [m if m is not None else None for m in masks],
        })
    return out


def save_ytvis_results(results: List[Dict], output_dir: str,
                       name: str = "results.json") -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    with open(path, "w") as f:
        json.dump(results, f)
    return path


def track_to_bdd_scalabel(video_name: str, frame_names: List[str],
                          per_frame: List[List[Dict]]) -> List[Dict]:
    """Per-frame track records -> BDD100K scalabel frames.

    per_frame[i] = [{"id", "category", "box_xyxy", ["rle"]}].
    Parity: tools_bin BDD100K MOT/MOTS converter output format."""
    frames = []
    for i, (fname, dets) in enumerate(zip(frame_names, per_frame)):
        labels = []
        for d in dets:
            rec = {
                "id": str(int(d["id"])),
                "category": d["category"],
                "box2d": {
                    "x1": float(d["box_xyxy"][0]), "y1": float(d["box_xyxy"][1]),
                    "x2": float(d["box_xyxy"][2]), "y2": float(d["box_xyxy"][3]),
                },
            }
            if "rle" in d:
                rec["rle"] = d["rle"]
            labels.append(rec)
        frames.append({"videoName": video_name, "name": fname,
                       "frameIndex": i, "labels": labels})
    return frames


def _seg_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Per-frame segmentation (polygon list | RLE dict | None) -> (H, W)."""
    from ..data.masks import decode_mask, polygons_to_mask
    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, dict):
        return decode_mask(seg).astype(bool)
    return polygons_to_mask(seg, h, w).astype(bool)


def evaluate_ytvis(results: List[Dict], gt: Dict) -> Dict[str, float]:
    """Offline YouTube-VIS track mAP.

    The reference only FORMATS results for the codalab servers
    (data/ytvis_eval.py:23); this implements the official protocol locally
    so VIS runs terminate in a number without a server: the spatio-temporal
    track IoU (sum of per-frame intersections / sum of per-frame unions,
    absent frames = empty masks) plugs into the standard COCO matching
    machinery by treating each VIDEO as one image and each track's (T, H, W)
    mask volume as its "mask" (evaluation/coco_eval.py reuses unchanged —
    mask_iou flattens trailing dims, which IS the spatio-temporal IoU).

    results: ytvis result records (video_output_to_ytvis format);
    gt: ytvis-schema dict (videos / annotations / categories).
    """
    from .coco_eval import COCOEvaluator

    ev = COCOEvaluator(iou_type="segm")
    anns_by_vid: Dict[int, List[Dict]] = {}
    for a in gt.get("annotations", []):
        anns_by_vid.setdefault(a["video_id"], []).append(a)
    res_by_vid: Dict[int, List[Dict]] = {}
    for r in results:
        res_by_vid.setdefault(r["video_id"], []).append(r)

    def area_box(vol):
        # area-range machinery keys off box area; use the track's mean
        # per-present-frame mask area (the ytvis protocol's area measure)
        present = vol.reshape(vol.shape[0], -1).sum(1)
        a = float(present[present > 0].mean()) if (present > 0).any() else 0.0
        s = float(np.sqrt(a))
        return [0.0, 0.0, s, s]

    for vid in gt["videos"]:
        h, w, T = vid["height"], vid["width"], vid["length"]
        g_vols, g_cls = [], []
        for a in anns_by_vid.get(vid["id"], []):
            segs = a.get("segmentations") or [None] * T
            g_vols.append(np.stack([_seg_to_mask(s, h, w)
                                    for s in segs[:T]]
                                   + [np.zeros((h, w), bool)] *
                                   max(0, T - len(segs))))
            g_cls.append(a["category_id"])
        p_vols, p_cls, p_scores = [], [], []
        for r in res_by_vid.get(vid["id"], []):
            segs = r.get("segmentations") or [None] * T
            p_vols.append(np.stack([_seg_to_mask(s, h, w)
                                    for s in segs[:T]]
                                   + [np.zeros((h, w), bool)] *
                                   max(0, T - len(segs))))
            p_cls.append(r["category_id"])
            p_scores.append(r["score"])
        ev.add(
            {"boxes": np.array([area_box(v) for v in g_vols], np.float32
                               ).reshape(-1, 4),
             "classes": np.asarray(g_cls, np.int64),
             "masks": g_vols},
            {"boxes": np.array([area_box(v) for v in p_vols], np.float32
                               ).reshape(-1, 4),
             "classes": np.asarray(p_cls, np.int64),
             "scores": np.asarray(p_scores, np.float32),
             "masks": p_vols})
    return ev.evaluate()
