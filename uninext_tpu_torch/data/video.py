"""A copy of `uninext_tpu/data/video.py` over the port's `data/coco.py`
(the port imports nothing of the JAX package).

Video dataset loading + 2-frame (key, ref) training mapper.

Parity anchors (reference):
  * load_ytvis_json        — data/datasets/ytvis.py:199-290 (video dicts with
    file_names/length/per-frame annos; instance identity = annotation row)
  * YTVISDatasetMapper / UniVidDatasetMapper — data/dataset_mapper_uni_vid.py
    :90-288 (2-frame sampling within a task range: VIS 10 / MOT 3 / SOT 200;
    per-clip consistent resize+flip; dummy annos for disappeared objects,
    pseudo-videos from still images :284-288)

Static-shape contract: instance slot i is the SAME object in key and ref
frames; per-frame `valid` masks handle appearance/disappearance (the
reference's _get_dummy_anno). Output batch matches
`models/detr.py:UninextDETR.forward_video_train`.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DataConfig
from .coco import UniDatasetMapper, MappedSample


def load_ytvis_json(json_file: str, image_root: str,
                    has_expression: bool = False) -> Tuple[List[Dict], List[str]]:
    """YTVIS-format json -> video dataset dicts + category names; with
    `has_expression` (an R-VOS json) each video's referring expressions
    from the json's `expressions` table and the task "grounding"."""
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data.get("categories", []), key=lambda c: c["id"])
    cat_names = [c["name"] for c in cats]
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    anns_by_vid: Dict[int, List[Dict]] = {}
    for a in data.get("annotations", []):
        anns_by_vid.setdefault(a["video_id"], []).append(a)
    out = []
    for vid in data["videos"]:
        annos = anns_by_vid.get(vid["id"], [])
        out.append({
            "video_id": vid["id"],
            "file_names": [os.path.join(image_root, fn)
                           for fn in vid["file_names"]],
            "length": vid["length"],
            "height": vid["height"], "width": vid["width"],
            # per-object tracks: bboxes[t] may be None (absent in frame t)
            "tracks": [{
                "category_id": id_map.get(a.get("category_id", 1), 0),
                "bboxes": a.get("bboxes", []),
                "segmentations": a.get("segmentations", []),
            } for a in annos],
            "expressions": data.get("expressions", {}).get(str(vid["id"]))
            if has_expression else None,
            "task": "grounding" if has_expression else "detection",
        })
    return out, cat_names


class VideoPairMapper:
    """Video record -> (key, ref) MappedSample pair with aligned slots."""

    def __init__(self, cfg: DataConfig, categories, tokenizer=None,
                 is_train: bool = True, with_masks: bool = True,
                 sampling_frame_range: int = 10):
        self.cfg = cfg
        self.range = sampling_frame_range
        # crop_raw: the video pipeline applies RandomCrop at raw resolution
        # before resize (reference augmentation.py:112-121). The shared-seed
        # mechanism below makes the crop-vs-nocrop choice AND the crop window
        # clip-consistent; the reference re-samples the window per frame
        # (T.RandomCrop in an AugmentationList) — a documented divergence
        # that strictly helps track-slot alignment.
        self.base = UniDatasetMapper(cfg, categories, tokenizer,
                                     is_train, with_masks, crop_raw=True)

    def __call__(self, record: Dict, rng: Optional[random.Random] = None
                 ) -> Tuple[MappedSample, MappedSample]:
        rng = rng or random.Random()
        T = record["length"]
        key_f = rng.randrange(T)
        lo = max(0, key_f - self.range)
        hi = min(T - 1, key_f + self.range)
        ref_f = rng.randint(lo, hi)

        # one record per frame with slot-aligned annotations
        def frame_record(fi):
            annos = []
            for track in record["tracks"]:
                box = (track["bboxes"][fi]
                       if fi < len(track["bboxes"]) else None)
                seg = (track["segmentations"][fi]
                       if fi < len(track.get("segmentations", [])) else None)
                annos.append({
                    "bbox": box if box is not None else [0, 0, 0, 0],
                    "category_id": track["category_id"],
                    "segmentation": seg,
                    "absent": box is None,
                })
            return {
                "file_name": record["file_names"][fi],
                "height": record["height"], "width": record["width"],
                "annotations": annos,
                "expressions": record.get("expressions"),
                "task": record.get("task", "detection"),
            }

        # per-clip consistent geometry (flip_by_clip / choice_by_clip):
        # share one rng state for both frames. Pseudo-videos built from one
        # still image instead use INDEPENDENT augmentation per frame so the
        # pair carries synthetic motion (reference DetrDatasetMapperUniCLIP,
        # coco_dataset_mapper_uni.py:316-344).
        if record.get("pseudo", False):
            key_s = self.base(frame_record(key_f),
                              random.Random(rng.getrandbits(32)))
            ref_s = self.base(frame_record(ref_f),
                              random.Random(rng.getrandbits(32)))
        else:
            seed = rng.getrandbits(32)
            key_s = self.base(frame_record(key_f), random.Random(seed))
            ref_s = self.base(frame_record(ref_f), random.Random(seed))
        # clear validity for absent objects (dummy annos)
        for s, fi in ((key_s, key_f), (ref_s, ref_f)):
            for i, track in enumerate(record["tracks"]):
                absent = (fi >= len(track["bboxes"])
                          or track["bboxes"][fi] is None)
                if i < len(s.valid) and absent:
                    s.valid[i] = False
        return key_s, ref_s


def collate_video(pairs) -> Dict[str, np.ndarray]:
    """List of (key, ref) MappedSamples -> forward_video_train batch."""
    keys = [p[0] for p in pairs]
    refs = [p[1] for p in pairs]

    def targets(samples):
        t = {"boxes": np.stack([s.boxes for s in samples]),
             "valid": np.stack([s.valid for s in samples]),
             "positive_map": np.stack([s.positive_map for s in samples])}
        if samples[0].masks is not None:
            t["masks"] = np.stack([s.masks for s in samples])
        return t

    return {
        "images_key": np.stack([s.image for s in keys]),
        "images_ref": np.stack([s.image for s in refs]),
        "img_mask": np.stack([s.img_mask for s in keys]),
        "image_sizes": np.stack([s.image_size for s in keys]),
        "text_ids": np.stack([s.text_ids for s in keys]),
        "text_mask": np.stack([s.text_mask for s in keys]),
        "targets_key": targets(keys),
        "targets_ref": targets(refs),
    }


def pseudo_video_from_image(record: Dict, length: int = 2) -> Dict:
    """Still image -> pseudo-video (reference dataset_mapper_uni_vid.py:284)."""
    tracks = [{
        "category_id": a["category_id"],
        "bboxes": [a["bbox"]] * length,
        "segmentations": [a.get("segmentation")] * length,
    } for a in record.get("annotations", [])]
    return {
        "video_id": record.get("image_id", 0),
        "file_names": [record["file_name"]] * length,
        "length": length,
        "height": record["height"], "width": record["width"],
        "tracks": tracks,
        "expressions": record.get("expressions"),
        "task": record.get("task", "detection"),
        "pseudo": True,
    }
