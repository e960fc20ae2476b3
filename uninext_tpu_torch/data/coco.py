"""A copy of `uninext_tpu/data/coco.py` (the port imports nothing of the JAX
package), BoxInst's targets included (`boxinst=True`: box bitmasks and the
LAB colour similarity of `data/boxinst.py` instead of gt masks).

COCO-format dataset loading + the unified detection/grounding mapper.

Parity anchors:
  * dataset dicts      — detectron2 load_coco_json semantics (file_name,
                         annotations with bbox XYWH, category_id, segmentation)
  * DetrDatasetMapperUni — data/coco_dataset_mapper_uni.py:103-315 (resize
                         shortest edge to a sampled bucket, random flip with
                         left/right swap in expressions, prompt construction,
                         positive maps, static padding)
  * RefCOCO loading    — data/datasets/refcoco.py:45 (one expression per dict)

Static shapes: every sample is padded to (bucket_h, bucket_w, max_insts,
max_text_len), so each (task, bucket) pair is one shape for the model.
Masks are rasterized at stride `mask_out_stride` directly (criterion contract)
using the reference's offset convention (start = stride // 2).
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..config import DataConfig
from . import masks as mask_util
from .boxinst import boxes_to_bitmasks, color_similarity
from .prompts import (build_detection_prompt, sample_classes_for_training,
                      tokenize_with_positive_map)
from .tokenizer import BertTokenizer


def load_coco_json(json_file: str, image_root: str,
                   filter_empty: bool = True) -> Tuple[List[Dict], List[str]]:
    """Minimal COCO json -> dataset dicts + category names (contiguous ids)."""
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_names = [c["name"] for c in cats]
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    anns_by_img: Dict[int, List[Dict]] = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)
    out = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"], [])
        annos = []
        for a in anns:
            if a.get("iscrowd", 0):
                continue
            annos.append({
                "bbox": a["bbox"],                       # XYWH abs
                "category_id": id_map[a["category_id"]],
                "segmentation": a.get("segmentation"),
            })
        if filter_empty and not annos:
            continue
        out.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"], "width": img["width"],
            "annotations": annos,
            "dataset": "coco",
            "task": "detection",
        })
    return out, cat_names


def load_refcoco_json(json_file: str, image_root: str) -> List[Dict]:
    """RefCOCO-style json (d2-converted format): one record per expression."""
    with open(json_file) as f:
        data = json.load(f)
    out = []
    for d in data:
        out.append({
            "file_name": os.path.join(image_root, d["file_name"]),
            "image_id": d["image_id"],
            "height": d["height"], "width": d["width"],
            "annotations": d["annotations"],
            "expressions": d["expressions"],
            "dataset": "refcoco",
            "task": "grounding",
        })
    return out


def resize_shortest_edge(h: int, w: int, short: int, max_size: int
                         ) -> Tuple[int, int]:
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


_ORDINALS = ("first", "second", "third", "fourth", "fifth", "sixth",
             "seventh", "eighth", "ninth", "tenth")


def has_ordinal_num(expressions) -> bool:
    """Reference coco_dataset_mapper_uni.py:252-262 (substring match): crop is
    disabled for expressions like "second dog from the left" whose meaning
    depends on objects a crop could remove."""
    if not expressions:
        return False
    if isinstance(expressions, str):
        expressions = [expressions]
    return any(o in e.lower() for e in expressions for o in _ORDINALS)


def sample_crop_size(h: int, w: int, crop_type: str,
                     crop_size: Tuple[float, float], rng: random.Random
                     ) -> Tuple[int, int]:
    """detectron2 RandomCrop.get_crop_size (augmentation_impl.py:390-414)."""
    if crop_type == "relative":
        return int(h * crop_size[0] + 0.5), int(w * crop_size[1] + 0.5)
    if crop_type == "relative_range":
        ch = crop_size[0] + rng.random() * (1 - crop_size[0])
        cw = crop_size[1] + rng.random() * (1 - crop_size[1])
        return int(h * ch + 0.5), int(w * cw + 0.5)
    if crop_type == "absolute":
        return min(int(crop_size[0]), h), min(int(crop_size[1]), w)
    if crop_type == "absolute_range":
        lo, hi = int(crop_size[0]), int(crop_size[1])
        assert lo <= hi
        ch = rng.randint(min(h, lo), min(h, hi))
        cw = rng.randint(min(w, lo), min(w, hi))
        return ch, cw
    raise ValueError(f"unknown crop type {crop_type}")


@dataclass
class SampleGeometry:
    """Full geometric transform original -> final (h, w) valid region:
    pre-scale s1, crop window (in s1 coords), post-scale s2, hflip."""
    s1x: float = 1.0
    s1y: float = 1.0
    cx0: float = 0.0
    cy0: float = 0.0
    cw: float = float("inf")
    ch: float = float("inf")
    s2x: float = 1.0
    s2y: float = 1.0
    flip: bool = False
    h: int = 0
    w: int = 0

    def apply_box(self, x0, y0, x1, y1):
        """XYXY abs original coords -> XYXY final coords, clipped to the crop
        window (reference: CropTransform.apply_box + clip)."""
        x0 = (min(max(x0 * self.s1x, self.cx0), self.cx0 + self.cw) - self.cx0) * self.s2x
        x1 = (min(max(x1 * self.s1x, self.cx0), self.cx0 + self.cw) - self.cx0) * self.s2x
        y0 = (min(max(y0 * self.s1y, self.cy0), self.cy0 + self.ch) - self.cy0) * self.s2y
        y1 = (min(max(y1 * self.s1y, self.cy0), self.cy0 + self.ch) - self.cy0) * self.s2y
        if self.flip:
            x0, x1 = self.w - x1, self.w - x0
        return x0, y0, x1, y1

    def apply_points(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) polygon vertices, NOT clipped — rasterization at (h, w)
        clips out-of-crop geometry exactly."""
        x = (pts[:, 0] * self.s1x - self.cx0) * self.s2x
        y = (pts[:, 1] * self.s1y - self.cy0) * self.s2y
        if self.flip:
            x = self.w - x
        return np.stack([x, y], 1)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class MappedSample:
    """One padded, model-ready sample (all numpy, static shapes)."""
    image: np.ndarray          # (Hb, Wb, 3) float32, normalized
    img_mask: np.ndarray       # (Hb, Wb) bool, True = padding
    image_size: np.ndarray     # (2,) int32 valid (h, w)
    text_ids: np.ndarray       # (T,) int32
    text_mask: np.ndarray      # (T,) int32
    boxes: np.ndarray          # (G, 4) cxcywh normalized
    valid: np.ndarray          # (G,) bool
    positive_map: np.ndarray   # (G, T) bool
    masks: Optional[np.ndarray]  # (G, Hb/4, Wb/4) float32 or None
    labels: np.ndarray         # (G,) int32 contiguous category (or 0)
    bucket: Tuple[int, int]    # padded (Hb, Wb) — batching key
    # BoxInst (box-supervised masks; reference uninext_img.py:529-595)
    box_bitmasks: Optional[np.ndarray] = None      # (G, Hb/4, Wb/4)
    color_similarity: Optional[np.ndarray] = None  # (8, Hb/4, Wb/4)


class UniDatasetMapper:
    """Detection + grounding train/eval mapper with static-shape outputs."""

    def __init__(self, cfg: DataConfig, categories: Sequence[str],
                 tokenizer: Optional[BertTokenizer] = None,
                 is_train: bool = True, with_masks: bool = True,
                 max_classes_per_prompt: int = 80,
                 lsj: bool = False, lsj_size: int = 1024,
                 lsj_min_scale: float = 0.1, lsj_max_scale: float = 2.0,
                 crop_raw: bool = False,
                 boxinst: bool = False, boxinst_bottom_pixels: int = 0):
        self.cfg = cfg
        self.categories = list(categories)
        self.tok = tokenizer or BertTokenizer()
        self.is_train = is_train
        self.with_masks = with_masks
        self.max_classes = max_classes_per_prompt
        # large-scale jitter (INPUT.DATASET_MAPPER_NAME=coco_instance_lsj):
        # random scale into a fixed square canvas (single compile bucket)
        self.lsj = lsj
        self.lsj_size = lsj_size
        self.lsj_scale = (lsj_min_scale, lsj_max_scale)
        # crop_raw: video pipeline crops at raw resolution (reference
        # augmentation.py:117 puts RandomCrop before resize); image pipeline
        # pre-resizes shortest edge to choice(400,500,600) first
        # (coco_dataset_mapper_uni.py:118-123).
        self.crop_raw = crop_raw
        # BoxInst: emit box bitmasks + LAB color similarity instead of gt
        # masks (reference MODEL.BOXINST.ENABLED, stage-1 obj365 pretrain)
        self.boxinst = boxinst
        self.boxinst_bottom_pixels = boxinst_bottom_pixels

    # -- geometry ------------------------------------------------------
    def _load_and_resize(self, record: Dict, rng: random.Random,
                         disable_crop: bool = False):
        img = Image.open(record["file_name"]).convert("RGB")
        w0, h0 = img.size
        g = SampleGeometry()
        if self.lsj and self.is_train:
            scale = rng.uniform(*self.lsj_scale)
            s = min(self.lsj_size / h0, self.lsj_size / w0) * scale
            h = min(int(round(h0 * s)), self.lsj_size)
            w = min(int(round(w0 * s)), self.lsj_size)
        elif self.lsj:
            # eval letterbox at the TRAIN canvas (deterministic scale=1 of
            # the jitter range, same square bucket). A from-
            # scratch ViT trained only on lsj_size grids collapses (AP
            # ~0.0002) when evaluated at shortest-edge rectangles its
            # rel-pos tables never saw; conv backbones shrug this off.
            # Matching eval geometry to train geometry is the honest
            # fixture protocol for grid-sensitive backbones.
            s = min(self.lsj_size / h0, self.lsj_size / w0)
            h = min(int(round(h0 * s)), self.lsj_size)
            w = min(int(round(w0 * s)), self.lsj_size)
        elif self.is_train:
            # 50/50 crop-vs-plain pipeline, reference transform_img
            # (coco_dataset_mapper_uni.py:175-184)
            do_crop = (self.cfg.crop_enabled and not disable_crop
                       and rng.random() < 0.5)
            ph, pw = h0, w0
            if do_crop:
                if not self.crop_raw:
                    short = rng.choice((400, 500, 600))
                    ph, pw = resize_shortest_edge(h0, w0, short, 10 ** 9)
                    img = img.resize((pw, ph), Image.BILINEAR)
                    g.s1x, g.s1y = pw / w0, ph / h0
                ch, cw = sample_crop_size(ph, pw, self.cfg.crop_type,
                                          self.cfg.crop_size, rng)
                cy0 = rng.randint(0, ph - ch)
                cx0 = rng.randint(0, pw - cw)
                img = img.crop((cx0, cy0, cx0 + cw, cy0 + ch))
                g.cx0, g.cy0, g.cw, g.ch = float(cx0), float(cy0), float(cw), float(ch)
                ph, pw = ch, cw
            short = rng.choice(self.cfg.min_size_train)
            max_size = self.cfg.max_size_train
            h, w = resize_shortest_edge(ph, pw, short, max_size)
            g.s2x, g.s2y = w / pw, h / ph
        else:
            short = self.cfg.min_size_test
            max_size = self.cfg.max_size_test
            h, w = resize_shortest_edge(h0, w0, short, max_size)
        if self.lsj and self.is_train or not self.is_train:
            g.s2x, g.s2y = w / w0, h / h0
        img = img.resize((w, h), Image.BILINEAR)
        g.flip = self.is_train and rng.random() < 0.5
        if g.flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        g.h, g.w = h, w
        arr = np.asarray(img, np.float32)
        arr = (arr - np.array(self.cfg.pixel_mean)) / np.array(self.cfg.pixel_std)
        return arr.astype(np.float32), (h0, w0), g

    def _bucket(self, h: int, w: int) -> Tuple[int, int]:
        if self.lsj:
            return self.lsj_size, self.lsj_size
        d = self.cfg.size_divisibility
        return round_up(h, d), round_up(w, d)

    # -- main ----------------------------------------------------------
    def __call__(self, record: Dict, rng: Optional[random.Random] = None
                 ) -> MappedSample:
        rng = rng or random.Random()
        task = record.get("task", "detection")
        # ordinal expressions disable crop (reference :281-283)
        disable_crop = has_ordinal_num(record.get("expressions"))
        image, (h0, w0), g = self._load_and_resize(record, rng, disable_crop)
        h, w, flip = g.h, g.w, g.flip
        G = self.cfg.max_insts
        T = self.cfg.max_text_len

        annos = record.get("annotations", [])[:G]
        boxes = np.zeros((G, 4), np.float32)
        valid = np.zeros((G,), bool)
        labels = np.zeros((G,), np.int32)
        polys = []
        for i, a in enumerate(annos):
            x, y, bw, bh = a["bbox"]
            x0, y0, x1, y1 = g.apply_box(x, y, x + bw, y + bh)
            cx, cy = (x0 + x1) / 2 / w, (y0 + y1) / 2 / h
            boxes[i] = (cx, cy, (x1 - x0) / w, (y1 - y0) / h)
            # instances cropped away (or degenerate) are filtered exactly like
            # d2 filter_empty_instances; slot POSITION is kept so video
            # (key, ref) pairs stay aligned
            valid[i] = (x1 - x0) > 1e-5 and (y1 - y0) > 1e-5
            labels[i] = a.get("category_id", 0)
            polys.append(a.get("segmentation"))

        # prompt + positive map
        if task == "grounding":
            expr = record["expressions"]
            if isinstance(expr, list):
                expr = rng.choice(expr) if self.is_train else expr[0]
            if flip:
                expr = expr.replace("left", "@").replace(
                    "right", "left").replace("@", "right")
            tok = self.tok(expr, max_length=T)
            text_ids, text_mask = tok["input_ids"], tok["attention_mask"]
            pm = np.zeros((G, T), bool)
            pm[valid, 0] = True          # single pooled-token target
        else:
            # prompt classes sampled from ALL annotated labels (not just
            # crop-surviving ones) so a shared-seed video pair always builds
            # the identical prompt even when validity differs per frame; a
            # cropped-out class merely stays in the prompt as a negative
            pos_labels = labels[:len(annos)].tolist()
            if self.is_train:
                keep = sample_classes_for_training(
                    pos_labels, len(self.categories), rng, self.max_classes)
            else:
                keep = list(range(len(self.categories)))
            text, spans = build_detection_prompt(
                [self.categories[c] for c in keep])
            label_to_slot = {c: i for i, c in enumerate(keep)}
            spans_per_obj = [[spans[label_to_slot[int(l)]]]
                             for l in labels[:len(annos)]]
            text_ids, text_mask, pm_all = tokenize_with_positive_map(
                text, spans_per_obj, self.tok, T)
            pm = np.zeros((G, T), bool)
            pm[:pm_all.shape[0]] = pm_all
            pm[~valid] = False

        # pad image to bucket
        Hb, Wb = self._bucket(h, w)
        padded = np.zeros((Hb, Wb, 3), np.float32)
        padded[:h, :w] = image
        img_mask = np.ones((Hb, Wb), bool)
        img_mask[:h, :w] = False

        gt_masks = None
        if self.with_masks:
            s = self.cfg.size_divisibility // 8  # mask_out_stride = 4
            stride = 4
            mh, mw = Hb // stride, Wb // stride
            gt_masks = np.zeros((G, mh, mw), np.float32)
            for i, seg in enumerate(polys):
                if seg is None or not valid[i]:
                    continue
                if isinstance(seg, dict):
                    m = mask_util.decode_mask(seg)
                    if np.isfinite(g.cw):     # crop window in original coords
                        ox0 = int(round(g.cx0 / g.s1x))
                        oy0 = int(round(g.cy0 / g.s1y))
                        ow = max(1, int(round(g.cw / g.s1x)))
                        oh = max(1, int(round(g.ch / g.s1y)))
                        m = m[oy0:oy0 + oh, ox0:ox0 + ow]
                    m = np.asarray(Image.fromarray(m * 255).resize(
                        (w, h), Image.BILINEAR)) > 127
                    if flip:
                        m = m[:, ::-1]
                else:
                    pts = [g.apply_points(np.asarray(p, np.float64)
                                          .reshape(-1, 2))
                           for p in seg if len(p) >= 6]
                    m = mask_util.polygons_to_mask(
                        [p.ravel().tolist() for p in pts], h, w)
                full = np.zeros((Hb, Wb), np.uint8)
                full[:h, :w] = m
                # stride-4 sampling with the reference's start offset
                gt_masks[i] = full[stride // 2::stride, stride // 2::stride]

        box_bitmasks = color_sim = None
        if self.boxinst and self.is_train:
            stride = 4
            # un-normalize back to [0,255] RGB (reference feeds the ORIGINAL
            # padded image into the 4x avg-pool -> uint8 -> LAB chain)
            raw = (padded * np.array(self.cfg.pixel_std, np.float32)
                   + np.array(self.cfg.pixel_mean, np.float32))
            vm = np.zeros((Hb, Wb), np.float32)
            vm[:h, :w] = 1.0
            # bottom rows cleared, scaled resized/original height
            # (uninext_img.py:541-546); acts only on the similarity weights
            pr = int(self.boxinst_bottom_pixels * float(h) / float(max(h0, 1)))
            if pr > 0:
                vm[h - pr:h, :] = 0.0
            color_sim = color_similarity(raw, vm, stride)
            xyxy = np.stack([
                (boxes[:, 0] - boxes[:, 2] / 2) * w,
                (boxes[:, 1] - boxes[:, 3] / 2) * h,
                (boxes[:, 0] + boxes[:, 2] / 2) * w,
                (boxes[:, 1] + boxes[:, 3] / 2) * h], axis=-1)
            box_bitmasks = boxes_to_bitmasks(xyxy, valid, Hb, Wb, stride)

        return MappedSample(
            image=padded, img_mask=img_mask,
            image_size=np.array([h, w], np.int32),
            text_ids=text_ids.astype(np.int32),
            text_mask=text_mask.astype(np.int32),
            boxes=boxes, valid=valid, positive_map=pm,
            masks=gt_masks, labels=labels, bucket=(Hb, Wb),
            box_bitmasks=box_bitmasks, color_similarity=color_sim)
