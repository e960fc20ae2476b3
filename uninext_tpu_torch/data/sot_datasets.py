"""A copy of `uninext_tpu/data/sot_datasets.py` (the port imports nothing of the JAX package).

SOT dataset loaders: GOT-10k / LaSOT / TrackingNet directory formats.

Parity: reference data/datasets/builtin.py SOT registrations + the dataset
readers in external/lib. All three publish sequences as a frame directory +
a groundtruth.txt of per-frame "x,y,w,h" boxes; LaSOT adds full_occlusion /
out_of_view flags.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np


def _read_boxes(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", dtype=np.float64).reshape(-1, 4)


def load_got10k(root: str, split: str = "val") -> List[Dict]:
    seqs = []
    split_dir = os.path.join(root, split)
    for seq_dir in sorted(glob.glob(os.path.join(split_dir, "GOT-10k_*"))):
        gt_file = os.path.join(seq_dir, "groundtruth.txt")
        if not os.path.exists(gt_file):
            continue
        frames = sorted(glob.glob(os.path.join(seq_dir, "*.jpg")))
        seqs.append({
            "name": os.path.basename(seq_dir),
            "frames": frames,
            "gt_xywh": _read_boxes(gt_file),
            "dataset": "got10k", "task": "sot",
        })
    return seqs


def load_lasot(root: str, split_file: Optional[str] = None) -> List[Dict]:
    seqs = []
    for cls_dir in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(cls_dir):
            continue
        for seq_dir in sorted(glob.glob(os.path.join(cls_dir, "*"))):
            gt_file = os.path.join(seq_dir, "groundtruth.txt")
            if not os.path.exists(gt_file):
                continue
            occ = os.path.join(seq_dir, "full_occlusion.txt")
            oov = os.path.join(seq_dir, "out_of_view.txt")
            visible = None
            if os.path.exists(occ) and os.path.exists(oov):
                o = np.loadtxt(occ, delimiter=",").ravel()
                v = np.loadtxt(oov, delimiter=",").ravel()
                visible = (o == 0) & (v == 0)
            seqs.append({
                "name": os.path.basename(seq_dir),
                "frames": sorted(glob.glob(os.path.join(seq_dir, "img",
                                                        "*.jpg"))),
                "gt_xywh": _read_boxes(gt_file),
                "visible": visible,
                "dataset": "lasot", "task": "sot",
            })
    return seqs


def load_trackingnet(root: str, split: str = "TEST") -> List[Dict]:
    seqs = []
    anno_dir = os.path.join(root, split, "anno")
    frame_root = os.path.join(root, split, "frames")
    for gt_file in sorted(glob.glob(os.path.join(anno_dir, "*.txt"))):
        name = os.path.splitext(os.path.basename(gt_file))[0]
        frame_dir = os.path.join(frame_root, name)
        frames = sorted(glob.glob(os.path.join(frame_dir, "*.jpg")),
                        key=lambda p: int(os.path.splitext(
                            os.path.basename(p))[0]))
        seqs.append({
            "name": name, "frames": frames,
            "gt_xywh": _read_boxes(gt_file),
            "dataset": "trackingnet", "task": "sot",
        })
    return seqs


def load_bdd100k_track(json_file: str, image_root: str) -> List[Dict]:
    """BDD100K box_track / seg_track scalabel jsons -> video dicts
    (parity: data/datasets/bdd100k.py)."""
    import json
    with open(json_file) as f:
        frames = json.load(f)
    videos: Dict[str, List] = {}
    for fr in frames:
        videos.setdefault(fr["videoName"], []).append(fr)
    out = []
    for vname, frs in videos.items():
        frs = sorted(frs, key=lambda f: f["frameIndex"])
        tracks: Dict[str, Dict] = {}
        T = len(frs)
        for ti, fr in enumerate(frs):
            for lab in fr.get("labels", []):
                tid = lab["id"]
                if tid not in tracks:
                    tracks[tid] = {"category": lab["category"],
                                   "bboxes": [None] * T,
                                   "segmentations": [None] * T}
                b = lab.get("box2d")
                if b:
                    tracks[tid]["bboxes"][ti] = [
                        b["x1"], b["y1"], b["x2"] - b["x1"], b["y2"] - b["y1"]]
                if "rle" in lab:
                    tracks[tid]["segmentations"][ti] = lab["rle"]
        out.append({
            "video_id": vname,
            "file_names": [os.path.join(image_root, vname, f["name"])
                           for f in frs],
            "length": T,
            "tracks": list(tracks.values()),
            "dataset": "bdd100k", "task": "detection",
        })
    return out
