"""MOT / MOTS streaming driver, mirroring `uninext_tpu/engine/mot_inference.py`
(reference uninext_vid.py:1199-1292 inference_mot): the VIS frame step with
class-aware NMS at 0.7 and a selection floor of min(inference_select_thr,
obj_score_thr), then QDTrack association on the host (`associate`); MOTS
adds the masks of the tracked boxes. Without masks the frame step skips
the mask head. `RVOSDriver` (inference_rvos, :1293-1358): an expression's
prompt, the top-1 query's mask per frame (`engine/sot_inference.py:
make_rvos_frame_step`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import UninextConfig
from ..models.detr import UninextDETR
from ..models.trackers import QuasiDenseTracker
from .sot_inference import _TemplateDriver, make_rvos_frame_step
from .video_inference import _FrameDriver, _mask_to_original, image_size, to_host


class MOTDriver(_FrameDriver):
    """BDD100K-style multi-object tracking (boxes; masks when with_masks),
    on `device` (the card unless the caller asks for another)."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, cls_token_map,
                 with_masks: bool = False, device="cuda"):
        # Cache detections at a LOW floor independent of obj_score_thr: the
        # tracker applies init/obj thresholds during association, so keeping
        # the floor below them makes cached detections reusable for
        # hyperparameter sweeps.
        self.select_thr = min(cfg.track.inference_select_thr, cfg.track.obj_score_thr)
        self.with_masks = with_masks
        super().__init__(model, cfg, cls_token_map, device, select_thr=self.select_thr,
                         nms_thr=0.7, with_masks=with_masks)

    def detect_video(self, frames, img_masks, sizes, text_ids, text_mask
                     ) -> List[Dict]:
        """Model pass only: per-frame raw detections (valid-filtered at
        self.select_thr), no association."""
        lang = self.encode_prompt(text_ids, text_mask)
        raw: List[Dict] = []
        for frame in frames:
            o = self.frame_outputs(frame, img_masks, sizes, lang)
            v = o["valid"]
            rec = {"boxes": o["boxes"][v], "scores": o["max_scores"][v],
                   "labels": o["labels"][v], "embeds": o["embeds"][v]}
            if self.with_masks:
                rec["mask_logits"] = o["mask_logits"][v]
            raw.append(rec)
        return raw

    def run_video(self, frames, img_masks, sizes, text_ids, text_mask,
                  ori_size) -> List[List[Dict]]:
        raw = self.detect_video(frames, img_masks, sizes, text_ids, text_mask)
        tr = self.cfg.track
        return associate(raw, image_size(sizes), ori_size,
                         init_score_thr=tr.init_score_thr,
                         obj_score_thr=tr.obj_score_thr,
                         with_masks=self.with_masks)


def associate(raw_frames: List[Dict], image_size, ori_size,
              with_masks: bool = False, **tracker_kwargs
              ) -> List[List[Dict]]:
    """QDTrack association over cached per-frame detections -> the
    per-frame record format every downstream consumer (bdd_submit,
    mot_eval) expects. Pure numpy; cheap to re-run per hyperparameter."""
    tracker = QuasiDenseTracker(**tracker_kwargs)
    # frame-step boxes are cxcywh->xyxy of pred_boxes, i.e. NORMALIZED to
    # the content region — original-pixel coords are normalized * (ow, oh).
    # image_size is only needed for the stride-4 mask decode.
    ow, oh = float(ori_size[1]), float(ori_size[0])
    per_frame: List[List[Dict]] = []
    for fi, o in enumerate(raw_frames):
        keep_idx, ids = tracker.match(
            o["boxes"], o["scores"], o["labels"], o["embeds"], fi)
        dets = []
        for si, tid in zip(keep_idx, ids):
            if tid < 0:
                continue
            box = o["boxes"][si] * [ow, oh, ow, oh]
            rec = {"id": int(tid), "category": int(o["labels"][si]),
                   "score": float(o["scores"][si]), "box_xyxy": box}
            if with_masks:
                rec["mask"] = _mask_to_original(
                    o["mask_logits"][si], image_size, ori_size)
            dets.append(rec)
        per_frame.append(dets)
    return per_frame


class RVOSDriver(_TemplateDriver):
    """Referring VOS, online: the expression's prompt, the top-1 mask per
    frame, on `device` (the card unless the caller asks for another). With
    `rvos_temporal_weight` > 0 the choice carries the previous frame's
    reid embedding as a prior (`make_rvos_frame_step`); at 0 it is the
    reference's frame-independent inference_rvos."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, device="cuda"):
        super().__init__(model, cfg, device)
        self.step = make_rvos_frame_step(model, cfg)

    def encode_prompt(self, text_ids, text_mask) -> Dict[str, torch.Tensor]:
        """The expression's BERT features (`encode_text`), (1, T) ids and mask."""
        with torch.inference_mode():
            return self.model.encode_text(self._tensor(text_ids).long(),
                                          self._tensor(text_mask))

    def run_expression(self, frames, img_masks, sizes, lang_hidden, lang_mask):
        """The frame step over the video with one expression, the chosen
        embedding carried from frame to frame. Yields each frame's outputs
        on the host."""
        img_masks, sizes = self._tensor(img_masks), self._tensor(sizes)
        prev_embed = torch.zeros((1, self.cfg.transformer.d_model), device=self.device)
        has_prev = False
        for frame in frames:
            r = self.step(self._tensor(frame), img_masks, sizes, lang_hidden, lang_mask,
                          prev_embed, has_prev)
            prev_embed, has_prev = r["embed"], True
            yield to_host(r)

    def run_video(self, frames, img_masks, sizes, lang_hidden, lang_mask,
                  ori_size) -> List[np.ndarray]:
        """lang_hidden, lang_mask: the expression's features (`encode_prompt`,
        the grounding path pools them). Returns per-frame boolean masks at
        `ori_size`."""
        size = image_size(sizes)
        return [_mask_to_original(o["mask_logits"][0], size, ori_size)
                for o in self.run_expression(frames, img_masks, sizes, lang_hidden,
                                             lang_mask)]
