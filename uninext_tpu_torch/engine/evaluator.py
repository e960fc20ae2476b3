"""Evaluation over a dataset, mirroring `uninext_tpu/engine/evaluator.py`:
COCO box or mask AP of detection (`DetectionEvaluator`), and the REC and
RES metrics of grounding (`evaluate_refcoco`, `evaluate_res`).

One image at a time on the model's device: the mapper's padded sample, the
forward, `postprocess_detection` (NMS on the OTA path), with masks the
`predict_masks` of the kept queries; then on the host the boxes scaled to
the original size, the mask logits upsampled by 4 (bilinear), cropped to
the valid region and resized to the original size (nearest), and the C++
COCO matcher (`evaluation/fast_eval.py`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..config import UninextConfig
from ..data.coco import MappedSample, UniDatasetMapper
from ..data.masks import decode_mask, polygons_to_mask
from ..evaluation.coco_eval import COCOEvaluator, refcoco_iou_metrics, refcoco_metrics
from ..evaluation.fast_eval import coco_match
from ..models.detr import UninextDETR
from ..models.postprocess import postprocess_detection, postprocess_rec, take_queries


def _inputs(s: MappedSample, device: torch.device):
    """A mapped sample as a batch of one on `device`."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x[None])).to(device)
    return (t(s.image), t(s.img_mask), t(s.image_size), t(s.text_ids).long(),
            t(s.text_mask))


def _gt_mask(ann: Dict, oh: int, ow: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if isinstance(seg, dict):
        return decode_mask(seg) > 0
    if seg:
        return polygons_to_mask(seg, oh, ow) > 0
    return np.zeros((oh, ow), bool)


class DetectionEvaluator:
    """COCO-style evaluation of the detection path (`with_masks`: of its
    instance masks, "segm"). `times` holds (bucket, seconds) of each
    evaluated image: host time from the sample's copy to the device to its
    outputs on the host."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig,
                 cls_token_map: np.ndarray, with_masks: bool = False,
                 matcher: Callable = coco_match):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.cls_token_map = torch.as_tensor(np.asarray(cls_token_map)).to(self.device)
        self.with_masks = with_masks
        self.matcher = matcher
        self.times: List[Tuple[Tuple[int, int], float]] = []

    @torch.inference_mode()
    def predict(self, s: MappedSample) -> Dict[str, np.ndarray]:
        """The top 100 of one sample: boxes (K, 4) normalised xyxy, scores,
        classes and, with masks, their mask logits (K, Hb/4, Wb/4)."""
        t0 = time.perf_counter()
        images, img_mask, sizes, ids, tmask = _inputs(s, self.device)
        out = self.model(images, img_mask, sizes, ids, tmask, task="detection")
        post = postprocess_detection(out, self.cls_token_map, use_nms=self.cfg.loss.ota)
        if self.with_masks:
            idx = post["query_idx"]
            post["mask_logits"] = self.model.predict_masks(
                out["memory"], out["spatial_shapes"], take_queries(out["hs"], idx),
                take_queries(out["base_reference"], idx), sizes)
        res = {k: post[k][0].float().cpu().numpy() if k in ("boxes", "scores", "mask_logits")
               else post[k][0].cpu().numpy() for k in post}
        self.times.append((tuple(s.bucket), time.perf_counter() - t0))
        return res

    def evaluate(self, records: Sequence[Dict], mapper: UniDatasetMapper,
                 score_thr: float = 0.0) -> Dict[str, float]:
        was_training = self.model.training
        self.model.eval()
        try:
            ev = COCOEvaluator("segm" if self.with_masks else "bbox", matcher=self.matcher)
            for rec in records:
                ev.add(*self._image(rec, mapper(rec), score_thr))
            return ev.evaluate()
        finally:
            self.model.train(was_training)

    def _image(self, rec: Dict, s: MappedSample, score_thr: float):
        """(gt, pred) of one record, at its original size."""
        post = self.predict(s)
        h, w = s.image_size
        oh, ow = rec["height"], rec["width"]
        boxes = post["boxes"] * [w, h, w, h]
        boxes = boxes * [ow / w, oh / h, ow / w, oh / h]
        keep = post["scores"] > score_thr
        pred = {"boxes": boxes[keep], "scores": post["scores"][keep],
                "classes": post["classes"][keep]}
        if self.with_masks:
            pm = []
            for logit in post["mask_logits"][keep]:
                m = Image.fromarray(np.asarray(logit, np.float32))
                m = m.resize((logit.shape[1] * 4, logit.shape[0] * 4), Image.BILINEAR)
                m = np.asarray(m)[:h, :w]
                m = np.asarray(Image.fromarray(m).resize((ow, oh), Image.NEAREST))
                pm.append(m > 0)
            pred["masks"] = pm
        gt_boxes, gt_classes = [], []
        for a in rec["annotations"]:
            x, y, bw, bh = a["bbox"]
            gt_boxes.append([x, y, x + bw, y + bh])
            gt_classes.append(a["category_id"])
        gt = {"boxes": np.array(gt_boxes, np.float32).reshape(-1, 4),
              "classes": np.array(gt_classes, np.int64)}
        if self.with_masks:
            gt["masks"] = [_gt_mask(a, oh, ow) for a in rec["annotations"]]
        return gt, pred


@torch.inference_mode()
def _grounding_top1(model: UninextDETR, s: MappedSample):
    """The grounding forward's top-1 query of one sample: box (4,) cxcywh
    normalised and mask logits (Hb/4, Wb/4)."""
    device = next(model.parameters()).device
    images, img_mask, sizes, ids, tmask = _inputs(s, device)
    out = model(images, img_mask, sizes, ids, tmask, task="grounding")
    rec = postprocess_rec(model, out, sizes)
    return rec["box"][0].float().cpu().numpy(), rec["mask_logits"][0, 0].float().cpu().numpy()


def evaluate_refcoco(model: UninextDETR, records: Sequence[Dict],
                     mapper: UniDatasetMapper) -> Dict[str, float]:
    """REC: the top-1 box of each expression -> P@0.5..0.9, oIoU, mIoU."""
    preds, gts = [], []
    for rec in records:
        s = mapper(rec)
        cx, cy, bw, bh = _grounding_top1(model, s)[0]
        h, w = s.image_size
        oh, ow = rec["height"], rec["width"]
        xyxy = np.array([(cx - bw / 2) * w, (cy - bh / 2) * h,
                         (cx + bw / 2) * w, (cy + bh / 2) * h])
        preds.append(xyxy * [ow / w, oh / h, ow / w, oh / h])
        x, y, bw, bh = rec["annotations"][0]["bbox"]
        gts.append([x, y, x + bw, y + bh])
    return refcoco_metrics(np.stack(preds), np.array(gts, np.float32))


def evaluate_res(model: UninextDETR, records: Sequence[Dict],
                 mapper: UniDatasetMapper) -> Dict[str, float]:
    """RES: the top-1 query's mask of each expression, thresholded at logit
    0 after a bilinear resize of its valid part to the original size ->
    mask P@0.5..0.9, oIoU, mIoU."""
    inter_sum = union_sum = 0.0
    ious = []
    for rec in records:
        s = mapper(rec)
        logits = _grounding_top1(model, s)[1]
        h, w = s.image_size
        oh, ow = rec["height"], rec["width"]
        content = logits[: int(np.ceil(h / 4)), : int(np.ceil(w / 4))]
        pred = np.asarray(Image.fromarray(content.astype(np.float32)).resize(
            (ow, oh), Image.BILINEAR)) > 0
        gt = _gt_mask(rec["annotations"][0], oh, ow)
        inter = float(np.logical_and(pred, gt).sum())
        union = float(np.logical_or(pred, gt).sum())
        ious.append(inter / max(union, 1e-9))
        inter_sum += inter
        union_sum += union
    return refcoco_iou_metrics(np.asarray(ious), inter_sum, union_sum)
