"""A copy of `uninext_tpu/evaluation/bdd_submit.py` (the port imports nothing of the JAX package).

BDD100K submission converters (det / ins_seg / box_track / seg_track).

Parity: reference tools_bin/to_bdd100k{.py,/transforms.py,/utils.py} — the
path behind the BDD100K MOT-challenge-winning submissions. Outputs are the
scalabel formats the eval server ingests, written without the scalabel
dependency:

  * det / box_track: json frames
      {"name", ["videoName", "frameIndex"], "labels": [{"id", "score",
       "category", "box2d": {x1,y1,x2,y2}}]}
    with the scalabel box2d convention x2 = right - 1, y2 = bottom - 1
    (scalabel.label.transforms.bbox_to_box2d on an xywh box).
  * ins_seg / seg_track: RGBA bitmask PNGs, one per frame, channels
      [category_id + 1, 0, instance_id >> 8, instance_id & 255]
    painted in ascending score order so higher-scoring instances overwrite
    (to_bdd100k/utils.py:24-39), plus the ins_seg score-index json.

Also: YTVIS eval-server zip packaging (results.json at archive root).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# reference tools_bin/to_bdd100k/transforms.py:20 (index 0 is background)
BDD_CATEGORIES = ("pedestrian", "rider", "car", "truck", "bus", "train",
                  "motorcycle", "bicycle", "traffic light", "traffic sign")


def box2d(xyxy) -> Dict[str, float]:
    """xyxy -> scalabel box2d (inclusive right/bottom: x2-1, y2-1)."""
    return {"x1": float(xyxy[0]), "y1": float(xyxy[1]),
            "x2": float(xyxy[2]) - 1.0, "y2": float(xyxy[3]) - 1.0}


def det_to_bdd(per_image: List[List[Dict]], img_names: Sequence[str],
               categories: Sequence[str] = BDD_CATEGORIES) -> List[Dict]:
    """per_image[i] = [{"category": int, "score", "box_xyxy"}] -> frames."""
    frames = []
    ann_id = 0
    for name, dets in zip(img_names, per_image):
        labels = []
        for d in dets:
            ann_id += 1
            labels.append({"id": str(ann_id), "score": float(d["score"]),
                           "category": categories[int(d["category"])],
                           "box2d": box2d(d["box_xyxy"])})
        frames.append({"name": name, "labels": labels})
    return frames


def box_track_to_bdd(per_frame: List[List[Dict]], img_names: Sequence[str],
                     video_name: str,
                     categories: Sequence[str] = BDD_CATEGORIES
                     ) -> List[Dict]:
    """MOTDriver per-frame records -> scalabel tracking frames."""
    frames = []
    for i, (name, dets) in enumerate(zip(img_names, per_frame)):
        labels = []
        for d in dets:
            labels.append({"id": str(int(d["id"])),
                           "score": float(d["score"]),
                           "category": categories[int(d["category"])],
                           "box2d": box2d(d["box_xyxy"])})
        frames.append({"name": name, "videoName": video_name,
                       "frameIndex": i, "labels": labels})
    return frames


def merge_bitmask(dets: List[Dict], shape: Tuple[int, int]) -> np.ndarray:
    """Overlap-resolved RGBA bitmask (to_bdd100k/utils.py mask_merge):
    paint in ascending score order; channels
    [category_id + 1, 0, id >> 8, id & 255]."""
    bitmask = np.zeros((*shape, 4), np.uint8)
    order = np.argsort([float(d["score"]) for d in dets])
    for idx in order:
        d = dets[idx]
        m = np.asarray(d["mask"], bool)
        iid = int(d["id"])
        color = (int(d["category"]) + 1, 0, iid >> 8, iid & 255)
        for c in range(4):
            bitmask[..., c] = np.where(m, color[c], bitmask[..., c])
    return bitmask


def _write_bitmask(bitmask: np.ndarray, png_path: str):
    from PIL import Image
    os.makedirs(os.path.dirname(png_path), exist_ok=True)
    Image.fromarray(bitmask, mode="RGBA").save(png_path)


def seg_track_to_bdd(per_frame: List[List[Dict]], img_names: Sequence[str],
                     out_dir: str, shape: Tuple[int, int]) -> List[str]:
    """MOTS: one RGBA bitmask PNG per frame under out_dir/<video>/..png.
    per_frame[i] = [{"id", "category", "score", "mask" (H,W) bool}]."""
    paths = []
    for name, dets in zip(img_names, per_frame):
        png = os.path.join(out_dir,
                           name.replace(".jpg", ".png").replace(".jpeg",
                                                                ".png"))
        _write_bitmask(merge_bitmask(dets, shape), png)
        paths.append(png)
    return paths


def ins_seg_to_bdd(per_image: List[List[Dict]], img_names: Sequence[str],
                   out_dir: str, shape: Tuple[int, int]) -> List[Dict]:
    """Instance segmentation: score-index json + bitmask PNGs. Instance ids
    are per-image indices (to_bdd100k/transforms.py:52-89)."""
    frames = []
    ann_id = 0
    for name, dets in zip(img_names, per_image):
        labels = []
        indexed = []
        for index, d in enumerate(dets, start=1):
            ann_id += 1
            labels.append({"id": str(ann_id), "index": index,
                           "score": float(d["score"])})
            indexed.append({**d, "id": index})
        frames.append({"name": name, "labels": labels})
        png = os.path.join(out_dir,
                           name.replace(".jpg", ".png").replace(".jpeg",
                                                                ".png"))
        _write_bitmask(merge_bitmask(indexed, shape), png)
    return frames


def decode_bitmask(bitmask: np.ndarray) -> List[Dict]:
    """Inverse of merge_bitmask (for round-trip validation): visible
    instances as [{"id", "category", "mask"}]."""
    ids = bitmask[..., 2].astype(np.int32) * 256 + bitmask[..., 3]
    out = []
    for iid in np.unique(ids):
        if iid == 0:
            continue
        m = ids == iid
        cat = int(bitmask[..., 0][m][0]) - 1
        out.append({"id": int(iid), "category": cat, "mask": m})
    return out


def save_bdd_json(frames: List[Dict], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(frames, f)
    return path


def package_ytvis_submission(results: List[Dict], zip_path: str) -> str:
    """YTVIS eval server expects a zip with results.json at the root."""
    os.makedirs(os.path.dirname(zip_path) or ".", exist_ok=True)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("results.json", json.dumps(results))
    return zip_path
