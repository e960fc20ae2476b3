"""Streaming video instance segmentation (VIS), mirroring
`uninext_tpu/engine/video_inference.py`.

    frame -> `UninextDETR.forward` (the category prompt encoded once per
    video; reid embeddings of every query) -> sqrt(cls * iou) -> the
    queries above `select_thr`, the best one always -> class-aware NMS
    over them (the NMS kernel, with that selection as its `valid` mask) ->
    top TOPK_VIS -> their masks and reid embeddings
    -> host: IDOL tracker, stride-4 masks to the original size, RLE, track
    pruning and temporal score aggregation.

The frame step (`make_vis_frame_step`) runs on the model's device and its
outputs come to the host in one transfer per frame (`to_host`). The top
TOPK_VIS is a stable descending sort, the lower query first among equal
scores, as `jax.lax.top_k` orders them: every query NMS suppressed scores
-1, so ties always exist among the invalid slots.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..config import UninextConfig
from ..data import masks as mask_util
from ..models.detr import UninextDETR
from ..models.postprocess import grounding_to_od_logits, take_queries
from ..models.trackers import IDOLTracker
from ..ops.nms import batched_nms
from ..utils import box_ops
from ..utils.misc import stable_topk_indices

TOPK_VIS = 50


def make_vis_frame_step(model: UninextDETR, cls_token_map: torch.Tensor,
                        select_thr: float = 0.1, nms_thr: float = 0.9,
                        with_masks: bool = True) -> Callable:
    """step(image (1, H, W, 3), img_mask (1, H, W), sizes (1, 2), lang) ->
    dict of tensors on the model's device: query_idx, valid, scores_full
    (K, C), boxes (K, 4) normalised xyxy, boxes_cxcywh, labels,
    max_scores, embeds (K, d_model) and, `with_masks`, mask_logits (K,
    H/4, W/4), for the K = TOPK_VIS best queries after NMS. `lang` is the
    prompt's `encode_text` output."""
    cmap = cls_token_map

    @torch.inference_mode()
    def step(image, img_mask, sizes, lang) -> Dict[str, torch.Tensor]:
        out = model(image, img_mask, sizes, None, lang["masks"], lang_dict=lang)
        prob = grounding_to_od_logits(out["pred_logits"], cmap).sigmoid()
        if "pred_boxious" in out:
            prob = (prob * out["pred_boxious"].float().sigmoid()).sqrt()
        prob = prob[0]                                         # (Q, C)
        max_score = prob.amax(-1)
        cls = prob.argmax(-1)                 # the first maximum, as jnp.argmax
        boxes_cxcywh = out["pred_boxes"][0].float()
        boxes = box_ops.box_cxcywh_to_xyxy(boxes_cxcywh)
        selected = max_score > select_thr
        selected[max_score.argmax()] = True   # at least one candidate
        keep = batched_nms(boxes[None].contiguous(), max_score[None].contiguous(),
                           cls[None].contiguous(), nms_thr, valid=selected[None])[0]
        ranked = torch.where(keep, max_score, -1.0)
        top_q = stable_topk_indices(ranked, min(TOPK_VIS, ranked.shape[0]))
        res = {"query_idx": top_q, "valid": ranked[top_q] > 0,
               "scores_full": prob[top_q], "boxes": boxes[top_q],
               "boxes_cxcywh": boxes_cxcywh[top_q], "labels": cls[top_q],
               "max_scores": max_score[top_q],
               "embeds": out["pred_embeds"][0, top_q].float()}
        if with_masks:
            idx = top_q[None]
            res["mask_logits"] = model.predict_masks(
                out["memory"], out["spatial_shapes"], take_queries(out["hs"], idx),
                take_queries(out["base_reference"], idx), sizes)[0]
        return res

    return step


def to_host(outputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A frame step's outputs as numpy arrays, in one device-to-host copy:
    every tensor is packed into one fp32 buffer (the integer outputs are
    query and class indices, exact in fp32) and split again on the host."""
    tensors = {k: torch.as_tensor(v) for k, v in outputs.items()}
    flat = torch.cat([v.reshape(-1).float() for v in tensors.values()]).cpu().numpy()
    res, start = {}, 0
    for k, v in tensors.items():
        n = v.numel()
        dt = {torch.bool: bool, torch.int64: np.int64,
              torch.int32: np.int32}.get(v.dtype, np.float32)
        res[k] = flat[start:start + n].reshape(tuple(v.shape)).astype(dt)
        start += n
    return res


def image_size(sizes) -> tuple:
    """(h, w) of a (1, 2) sizes array or tensor, on the host."""
    sizes = sizes.cpu().numpy() if torch.is_tensor(sizes) else np.asarray(sizes)
    return int(sizes[0, 0]), int(sizes[0, 1])


def _mask_to_original(mask_logit: np.ndarray, image_size, ori_size) -> np.ndarray:
    """stride-4 logits -> binary mask at original resolution (host)."""
    from PIL import Image
    h, w = image_size
    oh, ow = ori_size
    m = Image.fromarray(np.asarray(mask_logit, np.float32))
    m = m.resize((mask_logit.shape[1] * 4, mask_logit.shape[0] * 4),
                 Image.BILINEAR)
    m = np.asarray(m)[:h, :w]
    m = np.asarray(Image.fromarray(m).resize((ow, oh), Image.NEAREST))
    return m > 0


class _FrameDriver:
    """What the VIS and MOT drivers share: the model on `device` (the card
    unless the caller asks for another), the prompt encoded once per video
    and a frame step whose outputs reach the host in one copy."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, cls_token_map,
                 device="cuda", select_thr: float = 0.1, nms_thr: float = 0.9,
                 with_masks: bool = True):
        self.device = torch.device(device)
        where = next(model.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"the model is on {where}, the driver runs on {self.device}")
        self.model = model
        self.cfg = cfg
        self.step = make_vis_frame_step(
            model, torch.as_tensor(np.asarray(cls_token_map)).to(self.device),
            select_thr=select_thr, nms_thr=nms_thr, with_masks=with_masks)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                               ).to(self.device)

    def encode_prompt(self, text_ids, text_mask) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return self.model.encode_text(self._tensor(text_ids).long(),
                                          self._tensor(text_mask))

    def frame_outputs(self, frame, img_masks, sizes, lang) -> Dict[str, np.ndarray]:
        return to_host(self.step(self._tensor(frame), self._tensor(img_masks),
                                 self._tensor(sizes), lang))


class VISDriver(_FrameDriver):
    """Per-video streaming driver with IDOL tracking and RLE memory
    (`uninext_tpu/engine/video_inference.py:VISDriver`)."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, cls_token_map,
                 device="cuda"):
        super().__init__(model, cfg, cls_token_map, device,
                         select_thr=cfg.track.inference_select_thr, nms_thr=0.9)

    def run_video(self, frames, img_masks, sizes, text_ids, text_mask,
                  ori_size) -> Dict:
        """frames: (1, H, W, 3) each; img_masks (1, H, W), sizes (1, 2) of
        the padded frames; the prompt's text_ids and text_mask (1, T);
        ori_size (h, w). Returns the post-processed video output."""
        tr = self.cfg.track
        tracker = IDOLTracker(
            init_score_thr=tr.idol_init_score_thr,
            addnew_score_thr=tr.idol_addnew_score_thr,
            obj_score_thr=tr.idol_obj_score_thr,
            match_score_thr=tr.idol_match_score_thr,
            memory_len=tr.memory_len,
            frame_weight=tr.frame_weight,
            temporal_weight=tr.temporal_weight)
        lang = self.encode_prompt(text_ids, text_mask)
        video_dict: Dict[int, Dict] = {}
        n_frames = len(frames)
        size = image_size(sizes)
        for fi in range(n_frames):
            o = self.frame_outputs(frames[fi], img_masks, sizes, lang)
            v = o["valid"]
            keep_idx, ids = tracker.match(
                o["boxes"][v], o["max_scores"][v], o["labels"][v],
                o["mask_logits"][v], o["embeds"][v], fi)
            sel = np.flatnonzero(v)[keep_idx]
            for si, tid in zip(sel, ids):
                if tid < 0:
                    continue
                mask = _mask_to_original(o["mask_logits"][si], size, ori_size)
                rle = mask_util.encode_mask(mask.astype(np.uint8))
                if tid not in video_dict:
                    video_dict[tid] = {"masks": [None] * fi,
                                       "scores": [None] * fi, "valid": 0}
                video_dict[tid]["masks"].append(rle)
                video_dict[tid]["scores"].append(o["scores_full"][si])
                video_dict[tid]["valid"] += 1
            for tid, rec in video_dict.items():
                if len(rec["masks"]) < fi + 1:
                    rec["masks"].append(None)
                    rec["scores"].append(None)
            # prune short noise tracks (reference :1457-1464)
            if fi > 8:
                dead = [tid for tid, rec in video_dict.items()
                        if rec["masks"][-1] is None
                        and rec["masks"][-2] is None and rec["valid"] < 3]
                for tid in dead:
                    video_dict.pop(tid)
        return self.post_process(video_dict, n_frames, ori_size)

    def post_process(self, video_dict, vid_len, ori_size) -> Dict:
        tr = self.cfg.track
        out_scores, out_labels, out_masks = [], [], []
        for tid, rec in video_dict.items():
            sc = np.stack([s for s in rec["scores"] if s is not None])
            agg = sc.mean(0) if tr.temporal_score_type == "mean" else sc.max(0)
            if tr.multi_cls_on:
                for c in np.flatnonzero(agg > tr.apply_cls_thr):
                    out_scores.append(float(agg[c]))
                    out_labels.append(int(c))
                    out_masks.append(rec["masks"])
            else:
                out_scores.append(float(agg.max()))
                out_labels.append(int(agg.argmax()))
                out_masks.append(rec["masks"])
        return {"image_size": ori_size, "pred_scores": out_scores,
                "pred_labels": out_labels, "pred_masks": out_masks}
