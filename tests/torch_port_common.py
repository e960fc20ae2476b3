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
