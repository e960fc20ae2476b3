"""A copy of `uninext_tpu/data/mini_coco.py`, with its COCO, YTVIS and
RefCOCO fixtures (the port imports nothing of the JAX package).

Mini COCO-format dataset generator: real JPEGs + real instances json.

The end-to-end data-pipeline and AP checks need no download: this
generator it writes genuine COCO
`instances_*.json` files (images / annotations with bbox + polygon
segmentation + area + iscrowd / categories, non-contiguous category ids
like the real thing) and real JPEG files, with visually learnable
categories (colored geometric shapes on textured backgrounds). Everything
downstream — PIL decode, mapper resize/normalize, prompts, training,
COCO evaluation — runs exactly the path real COCO data would.

Reference anchor: datasets/coco layout expected by
detectron2/data/datasets/coco.py:load_coco_json.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image, ImageDraw

CATEGORIES = [
    {"id": 1, "name": "red square", "supercategory": "shape"},
    {"id": 3, "name": "green disk", "supercategory": "shape"},
    {"id": 7, "name": "blue triangle", "supercategory": "shape"},
]


def _polygon(cat: str, cx: float, cy: float, r: float,
             rng: np.random.RandomState) -> List[float]:
    if cat == "red square":
        pts = [(cx - r, cy - r), (cx + r, cy - r),
               (cx + r, cy + r), (cx - r, cy + r)]
    elif cat == "green disk":
        pts = [(cx + r * math.cos(2 * math.pi * k / 16),
                cy + r * math.sin(2 * math.pi * k / 16)) for k in range(16)]
    else:  # blue triangle
        a0 = rng.uniform(0, 2 * math.pi)
        pts = [(cx + r * math.cos(a0 + 2 * math.pi * k / 3),
                cy + r * math.sin(a0 + 2 * math.pi * k / 3))
               for k in range(3)]
    return [float(v) for p in pts for v in p]


_COLORS = {"red square": (210, 40, 35), "green disk": (40, 180, 60),
           "blue triangle": (45, 70, 220)}


def make_mini_coco(root: str, n_train: int = 32, n_val: int = 12,
                   seed: int = 0, img_size: Tuple[int, int] = (280, 360),
                   max_objects: int = 3) -> Dict[str, str]:
    """Writes root/{train,val}/*.jpg + root/instances_{train,val}.json.
    Returns {"train_json": ..., "val_json": ..., "train_root": ...,
    "val_root": ...}."""
    rng = np.random.RandomState(seed)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        aid = 1
        for i in range(n):
            h = int(rng.randint(img_size[0] - 40, img_size[0] + 40))
            w = int(rng.randint(img_size[1] - 40, img_size[1] + 40))
            # textured background (noise + gradient) so nothing is trivially
            # segmentable by a constant-color rule
            yy, xx = np.mgrid[0:h, 0:w]
            bg = (90 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 23.0)
                  + rng.randn(h, w) * 12)
            img = np.stack([bg + rng.randint(-20, 20)] * 3, -1)
            img = np.clip(img, 0, 255).astype(np.uint8)
            pil = Image.fromarray(img)
            draw = ImageDraw.Draw(pil)
            for _ in range(int(rng.randint(1, max_objects + 1))):
                cat = CATEGORIES[rng.randint(len(CATEGORIES))]
                r = float(rng.uniform(22, 55))
                cx = float(rng.uniform(r + 2, w - r - 2))
                cy = float(rng.uniform(r + 2, h - r - 2))
                poly = _polygon(cat["name"], cx, cy, r, rng)
                base = np.array(_COLORS[cat["name"]], np.float32)
                col = tuple(int(c) for c in np.clip(
                    base + rng.randn(3) * 12, 0, 255))
                draw.polygon(list(zip(poly[0::2], poly[1::2])), fill=col)
                xs, ys = poly[0::2], poly[1::2]
                x0, y0 = max(min(xs), 0.0), max(min(ys), 0.0)
                x1, y1 = min(max(xs), w), min(max(ys), h)
                annotations.append({
                    "id": aid, "image_id": i,
                    "category_id": cat["id"],
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "segmentation": [poly],
                    "area": float((x1 - x0) * (y1 - y0)),
                    "iscrowd": 0,
                })
                aid += 1
            fn = f"{i:06d}.jpg"
            pil.save(os.path.join(img_dir, fn), quality=92)
            images.append({"id": i, "file_name": fn,
                           "height": h, "width": w})
        js = {"info": {"description": f"mini-coco {split}"},
              "images": images, "annotations": annotations,
              "categories": CATEGORIES}
        jpath = os.path.join(root, f"instances_{split}.json")
        with open(jpath, "w") as f:
            json.dump(js, f)
        out[f"{split}_json"] = jpath
        out[f"{split}_root"] = img_dir
    return out


def make_mini_ytvis(root: str, n_train: int = 8, n_val: int = 4,
                    seed: int = 0, size: Tuple[int, int] = (192, 256),
                    length: int = 6, max_objects: int = 2,
                    referring: bool = False) -> Dict[str, str]:
    """YTVIS-schema mini dataset: real JPEG frame dirs + {split}.json with
    per-frame bboxes/polygon segmentations and track identity — objects move
    linearly across frames so VIS association is actually exercised.
    Layout: root/{split}/JPEGImages/<vid>/%05d.jpg + root/{split}.json.

    referring=True: a Ref-Youtube-VOS-style R-VOS fixture: each video draws
    2+ objects of distinct categories but annotates only the first (the
    referred target; the others stay in the pixels as distractors), and the
    json gains an ``expressions`` table {video_id: [expr]} in the schema
    `load_ytvis_json(has_expression=True)` reads."""
    rng = np.random.RandomState(seed)
    out = {}
    vid_id = 0
    for split, n in (("train", n_train), ("val", n_val)):
        img_root = os.path.join(root, split, "JPEGImages")
        videos, annotations = [], []
        expressions: Dict[str, List[str]] = {}
        aid = 1
        for _ in range(n):
            vid_id += 1
            h, w = size
            vname = f"vid{vid_id:03d}"
            os.makedirs(os.path.join(img_root, vname), exist_ok=True)
            objs = []
            if referring:
                n_obj = min(int(rng.randint(2, max(max_objects, 2) + 1)),
                            len(CATEGORIES))   # distinct categories only
                cat_pick = list(rng.choice(len(CATEGORIES), size=n_obj,
                                           replace=False))
            else:
                # this rng call order keeps seeded fixtures byte-identical
                # to the JAX package's
                n_obj = int(rng.randint(1, max_objects + 1))
                cat_pick = None
            for _o in range(n_obj):
                cat = (CATEGORIES[int(cat_pick[_o])] if referring
                       else CATEGORIES[rng.randint(len(CATEGORIES))])
                r = float(rng.uniform(18, 34))
                objs.append({
                    "cat": cat, "r": r,
                    "cx": float(rng.uniform(r + 4, w - r - 4)),
                    "cy": float(rng.uniform(r + 4, h - r - 4)),
                    "vx": float(rng.uniform(-6, 6)),
                    "vy": float(rng.uniform(-4, 4)),
                    "color": tuple(int(c) for c in np.clip(
                        np.array(_COLORS[cat["name"]], np.float32)
                        + rng.randn(3) * 10, 0, 255)),
                    "bboxes": [], "segs": [], "areas": [],
                })
            fns = []
            for t in range(length):
                yy, xx = np.mgrid[0:h, 0:w]
                bg = (90 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 23.0)
                      + rng.randn(h, w) * 12)
                pil = Image.fromarray(np.clip(
                    np.stack([bg] * 3, -1), 0, 255).astype(np.uint8))
                draw = ImageDraw.Draw(pil)
                for o in objs:
                    cx = np.clip(o["cx"] + o["vx"] * t, o["r"],
                                 w - o["r"])
                    cy = np.clip(o["cy"] + o["vy"] * t, o["r"],
                                 h - o["r"])
                    poly = _polygon(o["cat"]["name"], float(cx), float(cy),
                                    o["r"], rng)
                    draw.polygon(list(zip(poly[0::2], poly[1::2])),
                                 fill=o["color"])
                    xs, ys = poly[0::2], poly[1::2]
                    x0, y0 = max(min(xs), 0.0), max(min(ys), 0.0)
                    x1, y1 = min(max(xs), float(w)), min(max(ys), float(h))
                    o["bboxes"].append([x0, y0, x1 - x0, y1 - y0])
                    o["segs"].append([poly])
                    o["areas"].append(float((x1 - x0) * (y1 - y0)))
                fn = f"{vname}/{t:05d}.jpg"
                pil.save(os.path.join(img_root, fn), quality=92)
                fns.append(fn)
            videos.append({"id": vid_id, "height": h, "width": w,
                           "length": length, "file_names": fns})
            for o in (objs[:1] if referring else objs):
                annotations.append({
                    "id": aid, "video_id": vid_id,
                    "category_id": o["cat"]["id"],
                    "bboxes": o["bboxes"], "segmentations": o["segs"],
                    "areas": o["areas"], "iscrowd": 0})
                aid += 1
            if referring:
                expressions[str(vid_id)] = [f"the {objs[0]['cat']['name']}"]
        js = {"videos": videos, "annotations": annotations,
              "categories": CATEGORIES}
        if referring:
            js["expressions"] = expressions
        jpath = os.path.join(root, f"{split}.json")
        with open(jpath, "w") as f:
            json.dump(js, f)
        out[f"{split}_json"] = jpath
        out[f"{split}_root"] = img_root
    return out


def make_mini_refcoco(root: str, n_train: int = 48, n_val: int = 16,
                      seed: int = 0, img_size: Tuple[int, int] = (280, 360)
                      ) -> Dict[str, str]:
    """RefCOCO-format mini dataset (the d2-converted per-expression schema
    of data/coco.py:load_refcoco_json): images contain 2-3 distinct-category
    shapes; each record grounds ONE of them with an expression built from
    its category and image side ("the red square on the left"). Category
    alone is ambiguous only across images, never within one, so expressions
    are uniquely resolvable."""
    rng = np.random.RandomState(seed)
    out = {}
    img_id = 0
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, f"ref_{split}")
        os.makedirs(img_dir, exist_ok=True)
        records = []
        for _ in range(n):
            img_id += 1
            h = int(rng.randint(img_size[0] - 40, img_size[0] + 40))
            w = int(rng.randint(img_size[1] - 40, img_size[1] + 40))
            yy, xx = np.mgrid[0:h, 0:w]
            bg = (90 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 23.0)
                  + rng.randn(h, w) * 12)
            pil = Image.fromarray(np.clip(
                np.stack([bg] * 3, -1), 0, 255).astype(np.uint8))
            draw = ImageDraw.Draw(pil)
            k = int(rng.randint(2, len(CATEGORIES) + 1))
            picked = rng.choice(len(CATEGORIES), size=k, replace=False)
            objs = []
            for ci in picked:
                cat = CATEGORIES[ci]
                r = float(rng.uniform(26, 50))
                cx = float(rng.uniform(r + 2, w - r - 2))
                cy = float(rng.uniform(r + 2, h - r - 2))
                poly = _polygon(cat["name"], cx, cy, r, rng)
                base = np.array(_COLORS[cat["name"]], np.float32)
                col = tuple(int(c) for c in np.clip(
                    base + rng.randn(3) * 12, 0, 255))
                draw.polygon(list(zip(poly[0::2], poly[1::2])), fill=col)
                objs.append((cat, cx, cy, poly))
            fn = f"{img_id:06d}.jpg"
            pil.save(os.path.join(img_dir, fn), quality=92)
            for cat, cx, cy, poly in objs:
                side = ("left" if cx < w / 3 else
                        "right" if cx > 2 * w / 3 else "middle")
                xs, ys = poly[0::2], poly[1::2]
                x0, y0 = max(min(xs), 0.0), max(min(ys), 0.0)
                x1, y1 = min(max(xs), float(w)), min(max(ys), float(h))
                records.append({
                    "file_name": fn, "image_id": img_id,
                    "height": h, "width": w,
                    "annotations": [{
                        "bbox": [x0, y0, x1 - x0, y1 - y0],
                        "category_id": 0,
                        "segmentation": [poly]}],
                    "expressions": [f"the {cat['name']} on the {side}",
                                    f"{cat['name']}"],
                })
        jpath = os.path.join(root, f"refcoco_{split}.json")
        with open(jpath, "w") as f:
            json.dump(records, f)
        out[f"{split}_json"] = jpath
        out[f"{split}_root"] = img_dir
    return out
