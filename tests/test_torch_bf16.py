"""The port in bf16 vs the JAX package in bf16, on the CPU, with the same
weights (the bridge, `uninext_tpu_torch/engine/convert.py:load_jax_params`).

The presets compute in bf16, and the two frameworks round at different
places. These tests hold the port to the JAX package where bf16 matters:

- MSDA's module at the level shapes of an 800x1216 image. The JAX module
  rounds the sampling locations and attention weights to the value's dtype
  before the op (uninext_tpu/models/layers.py:131-132), and so does the
  port. A standing difference remains: the JAX op also rounds each corner
  product and the four-corner sum to bf16 (uninext_tpu/ops/msda.py:201-208),
  where the port's kernel and its plain version fold the corners in fp32.
  That leaves about one output rounding step between them.
- The small ViT detection slice (`tiny_vit_config()` in bf16). The encoder
  memory is compared elementwise. The decoder outputs are not: the
  two-stage top-k picks other proposals on bf16 near-ties, in JAX's own
  bf16 as in the port's, so the test asks that the port's bf16 be no
  further from JAX's fp32 than JAX's bf16 is, within a factor 1.5, in the
  maximum and in the median over several inputs.
- One train step's losses, by the same criterion.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (detection_inputs, detection_targets, jax_train_init,
                                     one_torch_thread, perturb, shared_across_workers,
                                     tiny_vit_config)
from uninext_tpu.models import layers as jlayers
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import layers
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# level shapes of an 800x1216 image (strides 8, 16, 32 and the extra level)
SHAPES_800 = ((100, 152), (50, 76), (25, 38), (13, 19))
# input seeds of the slice comparison: one input decides little, since a
# top-k near-tie moves a query's outputs by far more than rounding does
SEEDS = (0, 1, 2, 3)
FACTOR = 1.5
DN_KEY = jax.random.PRNGKey(123)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at the power of two at or above x."""
    return 2.0 ** (math.ceil(math.log2(x)) - 7)


def test_msdeform_attn_bf16_matches_jax_at_800x1216():
    """MSDeformAttn (d_model 256, M=8, L=P=4) on 2000 queries at uniform
    reference points over the four levels of an 800x1216 image (S = 20197),
    bf16, with perturbed weights: the offset and attention projections are
    non-zero, so the sampling locations lie off the pixel centres.

    Tolerance: two bf16 steps at the power of two above the largest output
    (0.03125 here, max |out| = 1.84). Measured by this test: 0.0156 max
    abs, 0.0015 mean. Before the port rounded the locations and weights to
    bf16 it measured 0.416 max abs, 0.0395 mean."""
    d, M, L, P, Lq = 256, 8, 4, 4, 2000
    S = sum(h * w for h, w in SHAPES_800)
    rng = np.random.RandomState(0)
    query = rng.randn(1, Lq, d).astype(np.float32)
    ref = rng.uniform(0, 1, (1, Lq, L, 2)).astype(np.float32)
    src = rng.randn(1, S, d).astype(np.float32)
    jm = jlayers.MSDeformAttnModule(d_model=d, n_levels=L, n_heads=M, n_points=P,
                                    dtype=jnp.bfloat16)
    params = perturb(jax.jit(lambda k: jm.init(k, query, ref, src, None, SHAPES_800))(
        jax.random.PRNGKey(0)))
    want = jax.jit(lambda p: jm.apply(p, query, ref, src, None, SHAPES_800))(params)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want).astype(np.float32)
    tm = layers.MSDeformAttn(d, L, M, P, dtype=torch.bfloat16)
    convert.load_jax_params(tm, params, fill=convert.fill_msda)
    with torch.no_grad():
        got = tm(_t(query), _t(ref), _t(src), None, SHAPES_800)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    tol = 2 * _bf16_step(float(np.abs(want).max()))
    assert err.max() <= tol, (err.max(), tol)


# ---- the small ViT detection slice -----------------------------------------

@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory, worker_id):
    """fp32 and bf16 configs, one perturbed JAX tree (initialised through
    the training path, so it holds the DN label encoder; once per
    session), and the port's bf16 model loaded from it."""
    c32 = tiny_vit_config()
    c16 = dataclasses.replace(c32, compute_dtype="bfloat16")
    targets = detection_targets(2, G=c32.data.max_insts)
    params = shared_across_workers("bf16_slice_pair", lambda: perturb(jax_train_init(
        jdetr.UninextDETR(c32), detection_inputs(0), targets)), tmp_path_factory, worker_id)
    model = build_model(c16, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return c32, c16, params, model, targets


OUT_KEYS = ("memory", "pred_logits", "pred_boxes", "pred_boxious")


@pytest.fixture(scope="module")
def slice_outputs(slice_pair, tmp_path_factory, worker_id):
    """{"j32" | "j16" | "p16": {key: [fp32 array per seed]}}: JAX fp32, JAX
    bf16 (compiled once per session) and the port's bf16 on the inputs of
    SEEDS."""
    c32, c16, params, model, _ = slice_pair

    def jax_outputs():
        fns = {n: jax.jit(lambda p, *a, jm=jdetr.UninextDETR(c): jm.apply(p, *a))
               for n, c in (("j32", c32), ("j16", c16))}
        outs = {n: {k: [] for k in OUT_KEYS} for n in fns}
        for seed in SEEDS:
            for n, fn in fns.items():
                res = fn(params, *detection_inputs(seed))
                for k in OUT_KEYS:
                    outs[n][k].append(np.asarray(res[k]).astype(np.float32))
        return outs

    outs = {**shared_across_workers("bf16_slice_outputs", jax_outputs, tmp_path_factory,
                                    worker_id), "p16": {k: [] for k in OUT_KEYS}}
    for i, seed in enumerate(SEEDS):
        inputs = detection_inputs(seed)
        with torch.inference_mode():
            res = model(*(_t(a) for a in inputs))
        for k in OUT_KEYS:
            assert res[k].shape == outs["j32"][k][i].shape, k
            outs["p16"][k].append(res[k].float().numpy())
    return outs


def _dist(outs, a, b, key):
    """|a - b| over every element of every seed."""
    return np.concatenate([np.abs(x - y).ravel()
                           for x, y in zip(outs[a][key], outs[b][key])])


def test_encoder_memory_bf16_matches_jax_bf16(slice_outputs):
    """The encoder memory after 2 ViT blocks, the neck and 2 encoder layers,
    port bf16 against JAX bf16 elementwise. If the port's bf16 error is no
    larger than JAX's, the two are at most twice JAX bf16's distance from
    JAX fp32 apart: the bound, in max and in median. Measured by this test:
    max 0.055 against a bound of 0.077 or more (|memory| < 4), median
    0.0056 against 0.0105."""
    got = _dist(slice_outputs, "p16", "j16", "memory")
    own = _dist(slice_outputs, "j16", "j32", "memory")
    assert got.max() <= 2 * own.max(), (got.max(), own.max())
    assert np.median(got) <= 2 * np.median(own), (np.median(got), np.median(own))


@pytest.mark.parametrize("key", ["pred_logits", "pred_boxes", "pred_boxious"])
def test_decoder_outputs_bf16_as_close_to_fp32_as_jax_bf16(slice_outputs, key):
    """The port's bf16 distance from JAX fp32 is at most 1.5x JAX bf16's,
    in the maximum and in the median over the elements of all SEEDS. Per
    input the ratio varies between 0.5 and 1.7 in both directions (a
    near-tie that flips in one framework and not the other), so the test
    pools four inputs; measured pooled ratios: max 1.29 / 0.99 / 1.06,
    median 0.90 / 0.76 / 0.81 (logits / boxes / IoU)."""
    port = _dist(slice_outputs, "p16", "j32", key)
    own = _dist(slice_outputs, "j16", "j32", key)
    assert port.max() <= FACTOR * own.max(), (port.max(), own.max())
    assert np.median(port) <= FACTOR * np.median(own), (np.median(port), np.median(own))


def test_train_step_losses_bf16_as_close_to_fp32_as_jax_bf16(slice_pair, monkeypatch):
    """One train step of the port in bf16 (forward in train mode, losses,
    backward): each loss's relative distance from JAX fp32's, in the
    maximum and the median over the 17 losses, is at most 1.5x JAX bf16's.
    The JAX DN key is pinned and the port gets the same (sign, part) noise,
    as in tests/test_torch_train.py. Measured by this test: ratios 1.21
    (max) and 0.59 (median)."""
    c32, c16, params, model, (boxes, valid, pm) = slice_pair
    real = jdetr.prepare_dn_static

    def pinned(gt_boxes, gt_valid, label_enc, rng, box_noise_scale, **kw):
        return real(gt_boxes, gt_valid, label_enc, DN_KEY, box_noise_scale, **kw)

    monkeypatch.setattr(jdetr, "prepare_dn_static", pinned)
    inputs = detection_inputs(0)
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm, "has_masks": False}
    losses = {}
    for n, c in (("j32", c32), ("j16", c16)):
        jm = jdetr.UninextDETR(c)
        res = jax.jit(lambda p: jm.apply(p, *inputs, targets=tgt, train=True,
                                         rngs={"dn": jax.random.PRNGKey(0)}))(params)
        losses[n] = {k: float(v) for k, v in res.items()}
    single_pad = min(jdetr.DN_SINGLE_PAD, c16.data.max_insts)
    shape = (2, 5, 2, single_pad, 4)
    k_sign, k_part = jax.random.split(DN_KEY)
    noise = (_t(np.asarray(jax.random.rademacher(k_sign, shape, dtype=jnp.float32))),
             _t(np.asarray(jax.random.uniform(k_part, shape))))
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(boxes), "valid": _t(valid), "positive_map": _t(pm)}}
    total, got = loss_and_grads(model, batch, loss_weights(c16), dn_noise=noise)
    assert torch.isfinite(total)
    losses["p16"] = {k: float(v.detach()) for k, v in got.items()}
    assert set(losses["p16"]) == set(losses["j32"])
    rel = {n: np.array([abs(losses[n][k] - w) / abs(w) for k, w in losses["j32"].items()])
           for n in ("p16", "j16")}
    assert rel["p16"].max() <= FACTOR * rel["j16"].max(), rel
    assert np.median(rel["p16"]) <= FACTOR * np.median(rel["j16"]), rel
