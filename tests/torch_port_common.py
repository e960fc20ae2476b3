"""Shared pieces of the `test_torch_*.py` parity tests: the small ViT-H
detection config, seeded inputs and a perturbed JAX parameter tree.

This module imports no JAX at import time, so the CUDA-only tests can use
it on a machine without JAX. Inputs and weights come from numpy
(`np.random.RandomState`) and go to both frameworks as arrays, so neither
framework's RNG is involved.
"""
import dataclasses

import numpy as np

from uninext_tpu_torch.config import BackboneConfig, tiny_test_config


def tiny_vit_config():
    """tiny_test_config with the small ViT backbone of tests/test_model.py
    (embed 32, 2 blocks, 2 heads, window 4, block 1 global), fp32."""
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(16, 32, 32),
        vit_flash_attn=False, vit_drop_path_rate=0.0))


def detection_inputs(seed=0, B=2, H=64, W=96, T=16):
    """Padded images (image 0 valid on 48 x 80), masks, sizes, prompt ids."""
    rng = np.random.RandomState(seed)
    images = rng.randn(B, H, W, 3).astype(np.float32)
    img_mask = np.zeros((B, H, W), bool)
    img_mask[0, 48:] = True
    img_mask[0, :, 80:] = True
    sizes = np.array([[48, 80], [H, W]][:B], np.int32)
    ids = rng.randint(0, 1000, (B, T)).astype(np.int32)
    tmask = np.zeros((B, T), np.int32)
    tmask[:, :10] = 1
    return images, img_mask, sizes, ids, tmask


# MSDA location sets: (geometry, level shapes). "tiny" has levels of 1x1 and
# 1x2 and odd widths; "edges" puts every coordinate on the frame's edges (0,
# 1), a pixel edge or a pixel centre, where grid_sample's rescaling through
# [-1, 1] may round to either side (continuous in the forward only).
MSDA_GEOMETRIES = ("uniform", "clustered", "tiny", "edges")
TINY_LEVELS = ((1, 1), (1, 2), (3, 5), (2, 7))


def msda_locations(rng, shapes, B, Lq, M, P, geometry, margin=0.0):
    """Sampling locations (B, Lq, M, L, P, 2), float32, of one geometry:
    "uniform" (and "tiny") in [-0.15, 1.15], a fifth of them out of frame;
    "clustered": the samples of each (image, head, level) within a 2 x 2
    pixel box at a random place (also across the frame's edge); "edges": on
    multiples of half a pixel. Each image draws its own. `margin` > 0 moves
    every location at least that many pixels off a pixel centre (bilinear
    sampling's kink, where gradients depend on rounding)."""
    L = len(shapes)
    loc = np.empty((B, Lq, M, L, P, 2), np.float32)
    for lvl, (H, W) in enumerate(shapes):
        size = np.array([W, H], np.float64)
        if geometry in ("uniform", "tiny"):
            px = rng.uniform(-0.15, 1.15, (B, Lq, M, P, 2)) * size - 0.5
        elif geometry == "clustered":
            corner = rng.randint(-1, size.astype(int), (B, 1, M, 1, 2))
            px = corner + rng.uniform(0, 2, (B, Lq, M, P, 2))
        elif geometry == "edges":
            half = rng.randint(0, 2 * size.astype(int) + 1, (B, Lq, M, P, 2))
            px = half / 2 - 0.5
        else:
            raise ValueError(geometry)
        if margin:
            frac = px - np.floor(px)
            px = np.where(frac < margin, px + margin,
                          np.where(frac > 1 - margin, px - margin, px))
        loc[:, :, :, lvl] = (px + 0.5) / size
    return loc


def perturb(params, seed=1, scale=0.05):
    """Add seeded noise to every leaf, so zero- and constant-initialised
    parameters (biases, rel-pos tables, offsets) carry information through
    the comparison. `up_res3/bias` stays four equal copies, the only form a
    ConvTranspose2d bias can take."""
    import jax      # imported here: the CUDA tests use this module without JAX

    rng = np.random.RandomState(seed)

    def one(path, x):
        x = np.asarray(x, np.float32)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("up_res3/bias"):
            return np.tile(rng.randn(x.shape[0] // 4).astype(np.float32) * scale, 4)
        return x + rng.randn(*x.shape).astype(np.float32) * scale

    return jax.tree_util.tree_map_with_path(one, params)


def detection_targets(seed=0, B=2, G=20, T=16, n=(3, 8)):
    """Synthetic targets padded to G: per image n[0]..n[1]-1 valid boxes
    (cxcywh inside the image), each with one or two positive prompt tokens
    among the first 10. Returns numpy boxes (B, G, 4), valid (B, G),
    positive_map (B, G, T)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    pm = np.zeros((B, G, T), bool)
    for b in range(B):
        k = rng.randint(*n)
        boxes[b, :k, :2] = rng.uniform(0.25, 0.75, (k, 2))
        boxes[b, :k, 2:] = rng.uniform(0.05, 0.4, (k, 2))
        valid[b, :k] = True
        for i in range(k):
            t0 = rng.randint(1, 9)
            pm[b, i, t0:t0 + 1 + rng.randint(2)] = True
    return boxes, valid, pm


def jax_train_init(jax_model, inputs, targets, seed=0):
    """Parameters of the JAX model initialised through its training path
    (so the DN label encoder `dn_resizer` exists), as a tree of numpy
    arrays."""
    import jax

    boxes, valid, pm = targets
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm, "has_masks": False}
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda r: jax_model.init(
        {"params": r, "dn": jax.random.fold_in(r, 1)}, *inputs,
        targets=tgt, train=True))(key)
    return jax.tree.map(np.asarray, params)
