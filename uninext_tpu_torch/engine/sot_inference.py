"""SOT / VOS / R-VOS streaming inference, mirroring
`uninext_tpu/engine/sot_inference.py` (reference uninext_vid.py:435-547
SOT, :671-960 VOS, :1293-1358 R-VOS):

    template: frame, box [, gt mask] -> `crop_template` ->
        `UninextDETR.encode_template` -> a pseudo-language prompt
    frame: `UninextDETR.forward` (task "grounding", that prompt) ->
        sqrt(sigmoid(cls) * sigmoid(iou)) per query (sigmoid(cls) without
        the IoU branch) -> the argmax query's box and score [-> its mask
        (`predict_masks`)]
    R-VOS frame: the same with an expression's BERT features, the score
        optionally blended with the reid cosine to the previous frame's
        choice (`rvos_temporal_weight`, gated by `has_prev`).

`SOTDriver` tracks one box through a video (online template update every
`update_interval` frames above `update_threshold`); `VOSDriver` segments
several objects, one pass per object and frame, merged by
`soft_aggregate`; with `inference_on_3f` each object's prompt is its first
template and its previous frame's, the latter re-encoded from the merged
mask. The frame steps run on the model's device and their few outputs come
to the host per frame; the merge and the template refresh run on the host
as in the JAX package. The SOT and VOS steps skip the reid head, whose
output they do not read (XLA prunes it from the JAX steps); the R-VOS step
computes it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..config import UninextConfig
from ..models.detr import UninextDETR
from ..models.postprocess import take_queries
from ..models.sot import crop_template
from ..utils import box_ops
from ..utils.misc import agg_lang_feat
from .video_inference import image_size, to_host


def make_template_encoder(model: UninextDETR, cfg: UninextConfig) -> Callable:
    """encode(image (1, H, W, 3) normalised, box_xyxy (1, 4) in pixels,
    gt_mask optional (1, H, W) in {0, 1}) -> the template prompt
    (`encode_template`). With the 4-channel template backbone the crop
    carries the gt mask, or without one the box region, as its 4th channel
    (ddetrs_vid_dn.py get_template_4c)."""
    mask_channel = cfg.sot.extra_backbone_for_template

    @torch.inference_mode()
    def encode(image, box_xyxy, gt_mask=None) -> Dict[str, torch.Tensor]:
        crop, pad = crop_template(image, box_xyxy, cfg.sot.template_size,
                                  cfg.sot.search_area_factor, gt_masks=gt_mask,
                                  mask_channel=mask_channel)
        return model.encode_template(crop, pad)

    return encode


def _grounding_scores(model, image, img_mask, sizes, lang_hidden, lang_mask, reid):
    """The grounding forward with a prompt made elsewhere, and each query's
    sqrt(sigmoid(cls) * sigmoid(iou)) (B, Q) fp32, or sigmoid(cls) alone
    for heads without the IoU branch. The pooled prompt is the masked mean
    (reference agg_lang_feat), which R-VOS's padded expressions need."""
    lang = {"hidden": lang_hidden, "masks": lang_mask,
            "aggregate": agg_lang_feat(lang_hidden, lang_mask)}
    out = model(image, img_mask, sizes, None, lang_mask, task="grounding",
                lang_dict=lang, reid=reid)
    prob = out["pred_logits"].float().sigmoid()[..., 0]
    if "pred_boxious" in out:
        prob = (prob * out["pred_boxious"].float().sigmoid()[..., 0]).sqrt()
    return out, prob


def _best_mask(model, out, best, sizes) -> torch.Tensor:
    """Mask logits (B, H/4, W/4) of query `best` (B,) of each image."""
    idx = best[:, None]
    return model.predict_masks(out["memory"], out["spatial_shapes"],
                               take_queries(out["hs"], idx),
                               take_queries(out["base_reference"], idx), sizes)[:, 0]


def make_sot_frame_step(model: UninextDETR, with_mask: bool = False) -> Callable:
    """step(image (1, H, W, 3), img_mask (1, H, W), sizes (1, 2),
    lang_hidden (1, N, D), lang_mask (1, N)) -> {box_cxcywh (1, 4)
    normalised, score (1,) [, mask_logits (1, H/4, W/4)]} on the model's
    device: the argmax query of sqrt(cls * iou) (the first among equal
    scores, as `jnp.argmax`)."""

    @torch.inference_mode()
    def step(image, img_mask, sizes, lang_hidden, lang_mask) -> Dict[str, torch.Tensor]:
        out, prob = _grounding_scores(model, image, img_mask, sizes, lang_hidden,
                                      lang_mask, reid=False)
        score, best = prob.amax(-1), prob.argmax(-1)
        res = {"box_cxcywh": take_queries(out["pred_boxes"], best[:, None])[:, 0],
               "score": score}
        if with_mask:
            res["mask_logits"] = _best_mask(model, out, best, sizes)
        return res

    return step


def make_rvos_frame_step(model: UninextDETR, cfg: UninextConfig) -> Callable:
    """The R-VOS frame step (`uninext_tpu/engine/sot_inference.py:
    make_rvos_frame_step`): step(image, img_mask, sizes, lang_hidden,
    lang_mask, prev_embed (1, d_model), has_prev: bool) -> {box_cxcywh,
    score, embed (1, d_model), mask_logits (1, H/4, W/4)}. The reference
    scores each query by sqrt(sigmoid(cls) * sigmoid(iou)) (inference_rvos,
    uninext_vid.py:1325-1328); with `rvos_temporal_weight` w > 0 and the
    reid head, and `has_prev`, the choice is made on
    prob * ((1 - w) + w * (cos(embed, prev_embed) + 1) / 2), and `score`
    stays the chosen query's prob. Frame 0 (has_prev False) is the
    reference's scoring."""
    w = cfg.rvos_temporal_weight
    use_sim = w > 0 and cfg.use_reid
    d_model = cfg.transformer.d_model

    @torch.inference_mode()
    def step(image, img_mask, sizes, lang_hidden, lang_mask, prev_embed,
             has_prev: bool) -> Dict[str, torch.Tensor]:
        out, prob = _grounding_scores(model, image, img_mask, sizes, lang_hidden,
                                      lang_mask, reid=True)
        score = prob
        embeds = out.get("pred_embeds")
        if use_sim and embeds is not None and has_prev:
            e = embeds.float()
            e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp(min=1e-6)
            p = prev_embed.float()
            p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=1e-6)
            sim01 = (torch.einsum("bqd,bd->bq", e, p) + 1.0) / 2.0
            score = prob * ((1.0 - w) + w * sim01)
        best = score.argmax(-1)
        idx = best[:, None]
        res = {"box_cxcywh": take_queries(out["pred_boxes"], idx)[:, 0],
               "score": torch.gather(prob, 1, idx)[:, 0],
               "embed": (take_queries(embeds, idx)[:, 0] if embeds is not None else
                         torch.zeros((prob.shape[0], d_model), device=prob.device)),
               "mask_logits": _best_mask(model, out, best, sizes)}
        return res

    return step


class _TemplateDriver:
    """The model on `device` (the card unless the caller asks for another)
    and the conversion of host inputs to tensors there."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, device="cuda"):
        self.device = torch.device(device)
        where = next(model.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"the model is on {where}, the driver runs on {self.device}")
        self.model = model
        self.cfg = cfg

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                               ).to(self.device)


class SOTDriver(_TemplateDriver):
    """Single-object tracking over one video (`uninext_tpu/engine/
    sot_inference.py:SOTDriver`); the model needs the template branch."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, device="cuda"):
        super().__init__(model, cfg, device)
        self.encode = make_template_encoder(model, cfg)
        self.step = make_sot_frame_step(model)

    def run_video(self, frames, img_mask, sizes, init_box_xyxy: np.ndarray):
        """frames (1, H, W, 3) each; img_mask (1, H, W) and sizes (1, 2) of
        the padded frames; the first frame's box xyxy in pixels. Returns
        the per-frame boxes (T, 4) xyxy in pixels (frame 0: the given box)
        and each frame's host seconds (frame 0: 0)."""
        c = self.cfg.sot
        img_mask, sizes = self._tensor(img_mask), self._tensor(sizes)
        lang_init = self.encode(self._tensor(frames[0]),
                                self._tensor(np.asarray(init_box_xyxy, np.float32)[None]))
        lang_cur = lang_init
        boxes_out = [np.asarray(init_box_xyxy)]
        times = [0.0]
        h, w = image_size(sizes)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=self.device)
        for fi in range(1, len(frames)):
            t0 = time.perf_counter()
            if c.online_update:
                hidden = torch.cat([lang_init["hidden"], lang_cur["hidden"]], 1)
                mask = torch.cat([lang_init["masks"], lang_cur["masks"]], 1)
            else:
                hidden, mask = lang_init["hidden"], lang_init["masks"]
            frame = self._tensor(frames[fi])
            r = self.step(frame, img_mask, sizes, hidden, mask)
            o = to_host({"box": box_ops.box_cxcywh_to_xyxy(r["box_cxcywh"] * scale),
                         "score": r["score"]})
            box, score = o["box"][0], float(o["score"][0])
            boxes_out.append(box)
            if (c.online_update and fi % c.update_interval == 0
                    and score > c.update_threshold):
                lang_cur = self.encode(frame, self._tensor(box[None]))
            times.append(time.perf_counter() - t0)
        return np.stack(boxes_out), np.asarray(times)


def soft_aggregate(prob_maps: np.ndarray) -> np.ndarray:
    """(N_obj, H, W) per-object foreground probabilities -> (H, W) label map
    (0 = background): P(bg) = prod(1 - p_i), the N + 1 channels
    renormalised, argmax (uninext_vid.py:774-794)."""
    bg = np.prod(1.0 - prob_maps, axis=0, keepdims=True)
    stacked = np.concatenate([bg, prob_maps], axis=0)
    stacked = stacked / np.clip(stacked.sum(0, keepdims=True), 1e-7, None)
    return stacked.argmax(0).astype(np.uint8)


def upsample_mask_logits(logits: torch.Tensor) -> torch.Tensor:
    """(h, w) stride-4 mask logits -> (4h, 4w): bilinear at half-pixel
    centres (align_corners False), which for an upsample equals the JAX
    package's `jax.image.resize(..., "linear")` (no antialias; its edge taps
    renormalise to the edge value, as torch's clamp does)."""
    return F.interpolate(logits[None, None].float(), scale_factor=4, mode="bilinear",
                         align_corners=False)[0, 0]


class VOSDriver(_TemplateDriver):
    """Multi-object VOS (`uninext_tpu/engine/sot_inference.py:VOSDriver`):
    per-object templates, one pass per object and frame; the model needs
    the template branch."""

    def __init__(self, model: UninextDETR, cfg: UninextConfig, device="cuda"):
        super().__init__(model, cfg, device)
        self.encode = make_template_encoder(model, cfg)
        self.step = make_sot_frame_step(model, with_mask=True)

    def run_video(self, frames, img_mask, sizes,
                  init_per_object: Dict[int, Dict]) -> List[np.ndarray]:
        """init_per_object: {obj_id: {frame: int, box_xyxy: (4,), mask:
        optional (H, W) {0, 1} annotation of that frame}}; the mask feeds
        the template's 4th channel (coco_inference_ref_vos,
        ddetrs_vid_dn.py:547-597). Each object's probability map is its
        mask logits upsampled x4 on the device, sigmoid, cut to the valid
        (h, w), zero below `inst_threshold_vos`; the maps merge by
        `soft_aggregate`. With `sot.inference_on_3f` (inference_ytbvos_3f,
        uninext_vid.py:798-960) each prompt is the object's first template
        and its previous one, re-encoded after each frame from the merged
        mask and its bounding box, skipping objects new in that frame,
        scores below `update_threshold` and empty masks. Returns per-frame
        (h, w) uint8 label maps of object ids."""
        sot = self.cfg.sot
        on_3f = sot.inference_on_3f
        img_mask, sizes = self._tensor(img_mask), self._tensor(sizes)
        templates: Dict[int, Dict] = {}
        prev: Dict[int, Dict] = {}
        h, w = image_size(sizes)
        outputs = []
        for fi in range(len(frames)):
            frame = self._tensor(frames[fi])
            new_ids = []
            for oid, init in init_per_object.items():
                if init["frame"] == fi:
                    gm = init.get("mask")
                    if gm is not None:
                        gm = self._tensor(np.asarray(gm, np.float32)[None])
                    box = self._tensor(np.asarray(init["box_xyxy"], np.float32)[None])
                    templates[oid] = self.encode(frame, box, gm)
                    prev[oid] = templates[oid]
                    new_ids.append(oid)
            if not templates:
                outputs.append(np.zeros((h, w), np.uint8))
                continue
            oids = sorted(templates)
            probs, scores = [], {}
            for oid in oids:
                t = templates[oid]
                if on_3f:
                    hidden = torch.cat([t["hidden"], prev[oid]["hidden"]], 1)
                    mask = torch.cat([t["masks"], prev[oid]["masks"]], 1)
                else:
                    hidden, mask = t["hidden"], t["masks"]
                r = self.step(frame, img_mask, sizes, hidden, mask)
                prob = upsample_mask_logits(r["mask_logits"][0]).sigmoid()[:h, :w]
                o = to_host({"score": r["score"], "prob": prob})
                scores[oid] = float(o["score"][0])
                m = o["prob"]
                if scores[oid] < sot.inst_threshold_vos:
                    m = np.zeros_like(m)
                probs.append(m)
            remap = np.zeros(len(oids) + 1, np.uint8)
            for i, oid in enumerate(oids):
                remap[i + 1] = oid
            label = remap[soft_aggregate(np.stack(probs))]
            outputs.append(label)
            if on_3f:
                HH, WW = frame.shape[1:3]
                for oid in oids:
                    if oid in new_ids or scores[oid] < sot.update_threshold:
                        continue
                    cur = label == oid
                    ys, xs = np.nonzero(cur)
                    if ys.size == 0:
                        continue
                    box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                                   np.float32)
                    gm = np.zeros((HH, WW), np.float32)
                    gm[:h, :w] = cur
                    prev[oid] = self.encode(frame, self._tensor(box[None]),
                                            self._tensor(gm[None]))
        return outputs
