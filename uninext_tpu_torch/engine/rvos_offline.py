"""Ref-DAVIS offline R-VOS, mirroring `uninext_tpu/engine/rvos_offline.py`
(reference inference_rvos_offline, uninext_vid.py:551-670): each object
has several expressions; one pass over the video per (object, expression)
through `RVOSDriver`'s frame step, the mask probabilities averaged over an
object's expressions, then the objects merged per frame by
`soft_aggregate` (as VOS). The resizes are PIL's, as in the JAX package:
the stride-4 logits bilinear x4, cut to the valid size, nearest to the
original size, then the sigmoid.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from PIL import Image

from .sot_inference import soft_aggregate
from .video_inference import image_size


def aggregate_expressions(prob_maps_per_expr: List[np.ndarray]) -> np.ndarray:
    """Mean over expressions: a list of (T, H, W) -> (T, H, W)."""
    return np.mean(np.stack(prob_maps_per_expr), axis=0)


def merge_objects_per_frame(per_object_probs: Dict[int, np.ndarray]) -> List[np.ndarray]:
    """{obj_id: (T, H, W) probabilities} -> per-frame (H, W) uint8 label
    maps of the object ids."""
    oids = sorted(per_object_probs)
    T = per_object_probs[oids[0]].shape[0]
    remap = np.zeros(len(oids) + 1, np.uint8)
    for i, oid in enumerate(oids):
        remap[i + 1] = oid
    return [remap[soft_aggregate(np.stack([per_object_probs[o][t] for o in oids]))]
            for t in range(T)]


def _probability(logit: np.ndarray, size, ori_size) -> np.ndarray:
    """stride-4 logits -> probabilities at the original size (PIL)."""
    m = Image.fromarray(np.asarray(logit, np.float32))
    m = m.resize((logit.shape[1] * 4, logit.shape[0] * 4), Image.BILINEAR)
    m = np.asarray(m)[:size[0], :size[1]]
    m = np.asarray(Image.fromarray(m).resize((ori_size[1], ori_size[0]), Image.NEAREST))
    return 1.0 / (1.0 + np.exp(-m))


def run_refdavis_offline(rvos_driver, frames, img_masks, sizes,
                         expressions_per_object: Dict[int, List[tuple]],
                         ori_size) -> List[np.ndarray]:
    """expressions_per_object: {obj_id: [(lang_hidden, lang_mask), ...]}
    (the expressions' `encode_prompt` features). One pass per (object,
    expression), the chosen embedding carried across its frames; returns
    per-frame (oh, ow) uint8 label maps. rvos_driver:
    `engine/mot_inference.py:RVOSDriver`."""
    size = image_size(sizes)
    per_object = {}
    for oid, exprs in expressions_per_object.items():
        probs_per_expr = [
            np.stack([_probability(o["mask_logits"][0], size, ori_size)
                      for o in rvos_driver.run_expression(frames, img_masks, sizes, lh, lm)])
            for lh, lm in exprs]
        per_object[oid] = aggregate_expressions(probs_per_expr)
    return merge_objects_per_frame(per_object)
