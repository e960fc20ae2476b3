"""The SOT/VOS template branch of the port against the JAX package on the
CPU, fp32, on the same inputs made from a seed with numpy:
`crop_template` (SOT's box-filled 4th channel, VOS's gt-mask channel, the
pad mask, a box over the image's border, a zero-area box, a centre on .5
for the window's rounding), `resize_level`, `_downsample_mask`,
`FeatureFuser`, `encode_template` on three models (the 4-channel R50 with
the fuser of `tiny_video_test_config`, the 3-channel per-level tokens of
`tiny_test_config`, a 2-block ViT template backbone), `forward_sot_train`'s
losses and every gradient (the template branch's included) against
`jax.value_and_grad`, the SOT and VOS frame steps end to end at 64x96 from
the same weights, and the weight bridge of the template branch (a whole
`init_all_paths` tree, a tree missing a template leaf, the optimizer
groups).

Templates here are 128x128 (the configs' 256 cut for the CPU): the fused
prompt is then 256 tokens, the per-level one 4 x 64. At 64x64 the P6 level
is 1x1, where GroupNorm normalises 2 values a group and turns fp32
rounding of the order of 1e-5 into 2e-3. The ViT model is
`tests/torch_port_common.py:tiny_vit_config` (flash off on the JAX side, as
`tests/test_sot.py:81`) with the template branch; its global block's
127-row rel-pos table shrinks to 15 rows on the 8x8 template grid through
`interp_rel_pos`, which copies JAX's antialiased resize (ROADMAP §3.1).
"""
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (bridge_sources, dn_noise, one_torch_thread, perturb,
                                     tiny_vit_config)
import uninext_tpu.models.detr as jdetr
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine import sot_inference as jsoti
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.engine.train import loss_weights as jax_loss_weights
from uninext_tpu.engine.train import weighted_total as jax_weighted_total
from uninext_tpu.models import sot as jsot
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import init_all_paths
from uninext_tpu_torch.config import tiny_test_config, tiny_video_test_config
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine import sot_inference
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import detr, sot
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TS = 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def _small_template(cfg, **sot_kw):
    return dataclasses.replace(cfg, sot=dataclasses.replace(cfg.sot, template_size=TS,
                                                            **sot_kw))


# ---- crop_template ---------------------------------------------------------------

H, W = 40, 56
CROP_BOXES = {
    # x0, y0, x1, y1 in pixels, one box per image of the batch
    "inside": [[10.2, 8.7, 30.9, 27.3], [3.0, 5.0, 20.0, 33.0], [30.5, 2.25, 50.75, 19.5]],
    "over_border": [[-6.0, -4.5, 14.0, 12.0], [40.0, 30.0, 62.0, 47.0], [0.0, 0.0, 56.0, 40.0]],
    "zero_area": [[20.0, 15.0, 20.0, 15.0], [5.0, 5.0, 25.0, 5.0], [10.0, 10.0, 10.0, 30.0]],
    # w = h = 8: crop 16, x0 - 4 and y0 - 4 land on .5 and round half to even
    "half": [[10.5, 11.5, 18.5, 19.5], [12.5, 13.5, 20.5, 21.5], [20.5, 2.5, 28.5, 10.5]],
}


def _crop_inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(3, H, W, 3).astype(np.float32)
    gt = (rng.rand(3, H, W) > 0.5).astype(np.float32)
    pad = np.zeros((3, H, W), bool)
    pad[0, 32:] = True
    pad[1, :, 44:] = True
    return images, gt, pad


@pytest.mark.parametrize("boxes", sorted(CROP_BOXES))
@pytest.mark.parametrize("channel", ["sot_box", "vos_mask", "rgb"])
def test_crop_template_matches_jax(boxes, channel):
    """The crop (and its 4th channel) within 1e-6 in fp32 and the pad mask
    equal: the integer window and its rounding (half to even on both
    sides), the content's stop at min(x2, W - 1), the taps clamped at the
    crop's border, the pad mask padded with 1 and > 0, the box region or
    the gt mask as the 4th channel."""
    images, gt, pad = _crop_inputs()
    b = np.asarray(CROP_BOXES[boxes], np.float32)
    kw = dict(mask_channel=channel != "rgb")
    jkw = dict(kw, gt_masks=jnp.asarray(gt) if channel == "vos_mask" else None,
               pad_masks=jnp.asarray(pad))
    want_crop, want_pad = jsot.crop_template(jnp.asarray(images), jnp.asarray(b), 24, 2.0,
                                             **jkw)
    got_crop, got_pad = sot.crop_template(
        _t(images), _t(b), 24, 2.0, gt_masks=_t(gt) if channel == "vos_mask" else None,
        pad_masks=_t(pad), **kw)
    assert got_crop.shape == want_crop.shape == (3, 24, 24, 3 + kw["mask_channel"])
    np.testing.assert_allclose(got_crop.numpy(), np.asarray(want_crop), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
    if boxes == "over_border":
        assert got_pad.numpy()[0].any() and not got_pad.numpy()[0].all()


def test_interp_taps_match_jax():
    rng = np.random.RandomState(2)
    coords = (rng.rand(3, 17) * 20 - 2).astype(np.float32)
    size = np.array([5.0, 12.0, 30.0], np.float32)
    want = [np.asarray(jsot._interp_taps(jnp.asarray(c), jnp.asarray(s)))
            for c, s in zip(coords, size)]
    got = sot._interp_taps(_t(coords), _t(size))
    for i, w in enumerate(want):
        for g, x in zip(got, w):
            np.testing.assert_array_equal(g[i].numpy(), x)


# ---- the levels: resize, pad masks, fuser --------------------------------------

def test_resize_level_and_downsample_mask_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 9, 5).astype(np.float32)
    for out in (4, 8, 11):
        np.testing.assert_array_equal(sot.resize_level(_t(x), out).numpy(),
                                      np.asarray(jsot.resize_level(jnp.asarray(x), out)))
    m = rng.rand(2, 37, 45) > 0.7
    for hw in ((5, 6), (19, 23), (37, 45)):
        np.testing.assert_array_equal(detr._downsample_mask(_t(m), hw).numpy(),
                                      np.asarray(jdetr._downsample_mask(jnp.asarray(m), hw)))


def test_feature_fuser_matches_jax():
    """3x3 convolutions on levels 8x8 ... 1x1, aligned-bilinear to 8x8,
    sum; the weights bridged by `convert._conv` (`sot_fuser/refine_{i}`)."""
    rng = np.random.RandomState(4)
    levels = [rng.randn(2, s, s, 16).astype(np.float32) for s in (8, 4, 2, 1)]
    jf = jsot.FeatureFuser(16)
    params = perturb(jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0),
                                                      [jnp.asarray(x) for x in levels])))
    want = jf.apply(params, [jnp.asarray(x) for x in levels])
    fuser = sot.FeatureFuser(16, 4)
    lv = convert._Leaves(params)
    sd = {}
    for i in range(4):
        convert._conv(sd, f"refine.{i}.", lv, f"refine_{i}")
    lv.check_empty()
    fuser.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = fuser([_t(x) for x in levels])
    _close(got.detach().numpy(), want, 1e-5, "fused")


# ---- encode_template ------------------------------------------------------------

def _template_tree_fill(sd, key, lv, path):
    """The parts of a tree of `encode_template`'s path: the backbone the
    crops take, the input projections, the fuser and `adjust_layer`."""
    fill = convert.fill_resnet if lv.has("backbone/stem_conv") or lv.has(
        "template_backbone/stem_conv") else convert.fill_vit
    if lv.has("backbone"):
        fill(sd, key + convert.ROOT + "backbone.0.backbone.", lv, "backbone")
    i = 0
    while lv.has(f"input_proj_{i}"):
        convert._conv(sd, f"{key}{convert.ROOT}input_proj.{i}.0.", lv, f"input_proj_{i}")
        convert._norm(sd, f"{key}{convert.ROOT}input_proj.{i}.1.", lv, f"input_gn_{i}")
        i += 1
    convert.fill_template(sd, key, lv, path, fill)


def _random_tree(shapes, seed=0, scale=0.02):
    """Weights for a tree of these shapes, from a seed: kernels N(0, 1 /
    fan_in) (lecun's scale), norms' scales and FrozenBN variances 1 +
    `scale` N(0, 1), every other leaf `scale` N(0, 1) (ViT's `up_res3` bias
    as four equal copies, the only form the port's ConvTranspose2d bias
    takes): the JAX initialisers' statistics with `perturb`'s noise,
    without compiling the init."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name.endswith("['up_res3']['bias']"):
            return np.tile(rng.randn(s.shape[0] // 4) * scale, 4).astype(np.float32)
        base = 1.0 if name.endswith(("['scale']", "['var']")) else 0.0
        return (base + rng.randn(*s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _crop_for(cfg, seed=5):
    """A template crop of a random frame (1, 96, 128) with part of the window
    outside the frame, so the pad mask is partly true."""
    rng = np.random.RandomState(seed)
    image = rng.randn(2, 96, 128, 3).astype(np.float32)
    box = np.array([[2.0, 50.0, 40.0, 94.0], [60.0, 20.0, 100.0, 52.0]], np.float32)
    gt = (rng.rand(2, 96, 128) > 0.5).astype(np.float32)
    crop, pad = jsot.crop_template(jnp.asarray(image), jnp.asarray(box), TS, 2.0,
                                   gt_masks=jnp.asarray(gt),
                                   mask_channel=cfg.sot.extra_backbone_for_template)
    return np.asarray(crop), np.asarray(pad)


def _check_prompt(got, want, n_tokens, rel=1e-4):
    assert got["hidden"].shape == want["hidden"].shape == (2, n_tokens, 64)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))
    assert 0 < np.asarray(want["masks"]).mean() < 1            # the pad mask reached it
    for k in ("hidden", "aggregate"):
        _close(got[k].numpy(), want[k], rel, k)


@pytest.mark.parametrize("name", ["r50_fused_4ch", "r50_levels_3ch"])
def test_encode_template_r50_matches_jax(name):
    """`tiny_video_test_config` (a 4-channel R50 template backbone, the
    fuser: the stride-8 map, 256 tokens) and `tiny_test_config` (the main
    R50 on a 3-channel crop, each of 4 levels resized to 8x8: 256 tokens):
    the prompt's hidden states and aggregate within 1e-4 of their largest
    value (fp32 through R50 at full width), its masks equal. The JAX tree
    holds only this path's parameters (`_random_tree`)."""
    cfg = _small_template(tiny_video_test_config() if name == "r50_fused_4ch"
                          else tiny_test_config())
    crop, pad = _crop_for(cfg)
    jm = JaxDETR(cfg)
    params = _random_tree(jax.eval_shape(
        lambda r: jm.init(r, crop, pad, method=JaxDETR.encode_template), jax.random.PRNGKey(0)))
    assert ("template_backbone" in params["params"]) == (name == "r50_fused_4ch")
    want = jax.jit(lambda p: jm.apply(p, crop, pad, method=JaxDETR.encode_template))(params)
    model = build_model(cfg, "cpu", seed=0, template=True)
    sd = convert.state_dict_from_jax(params, fill=_template_tree_fill)
    _, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == []
    with torch.inference_mode():
        got = model.encode_template(_t(crop), _t(pad))
    _check_prompt(got, want, (TS // 8) ** 2 if name == "r50_fused_4ch" else 256)


# ---- the ViT model with the template branch: a whole tree ---------------------

def vit_template_config():
    cfg = tiny_vit_config()
    return dataclasses.replace(
        _small_template(cfg, extra_backbone_for_template=True, feature_fusion=True),
        loss=dataclasses.replace(cfg.loss, sot_loss_scale=0.5))


@pytest.fixture(scope="module")
def vit_pair():
    """A tree of `init_all_paths`'s shapes for the ViT config (every
    branch, the 4-channel template ViT and the fuser included; weights by
    `_random_tree` at 0.05, without compiling the init), bridged whole into
    the port (`load_jax_params` consumes every leaf)."""
    cfg = vit_template_config()
    jm = JaxDETR(cfg)
    params = _random_tree(jax.eval_shape(lambda r: init_all_paths(jm, r, H=64, W=96),
                                         jax.random.PRNGKey(0)), scale=0.05)
    assert {"template_backbone", "sot_fuser", "adjust_layer"} <= set(params["params"])
    model = build_model(cfg, "cpu", seed=0, template=True)
    convert.load_jax_params(model, params)
    return cfg, jm, params, model


def test_encode_template_vit_matches_jax(vit_pair):
    """The 2-block ViT template backbone (4 channels, an 8x8 patch grid,
    window 4, one global block) with the fuser: 256 tokens."""
    cfg, jm, params, model = vit_pair
    crop, pad = _crop_for(cfg, seed=6)
    want = jax.jit(lambda p: jm.apply(p, crop, pad, method=JaxDETR.encode_template))(params)
    with torch.inference_mode():
        got = model.encode_template(_t(crop), _t(pad))
    _check_prompt(got, want, (TS // 8) ** 2)


def _sot_batch(G, seed=7):
    """Key and ref frames of two clips at 64x96 (image 0 valid on 48x80 in
    both), slot-aligned targets with masks; the first valid ref slot is 1
    in clip 0 (slot 0 is gone) and 0 in clip 1."""
    rng = np.random.RandomState(seed)
    B, Hh, Ww = 2, 64, 96
    img_mask = np.zeros((B, Hh, Ww), bool)
    img_mask[0, 48:] = True
    img_mask[0, :, 80:] = True
    key = rng.randn(B, Hh, Ww, 3).astype(np.float32) * ~img_mask[..., None]
    ref = rng.randn(B, Hh, Ww, 3).astype(np.float32) * ~img_mask[..., None]
    sizes = np.array([[48, 80], [64, 96]], np.int32)
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    for b, k in ((0, 3), (1, 2)):
        boxes[b, :k, :2] = rng.uniform(0.3, 0.7, (k, 2))
        boxes[b, :k, 2:] = rng.uniform(0.15, 0.4, (k, 2))
        valid[b, :k] = True
    boxes_r = boxes.copy()
    boxes_r[..., :2] += rng.uniform(-0.03, 0.03, boxes[..., :2].shape).astype(np.float32)
    valid_r = valid.copy()
    valid_r[0, 0] = False
    masks = (rng.rand(B, G, Hh // 4, Ww // 4) > 0.5).astype(np.float32)
    tk = {"boxes": boxes, "valid": valid, "masks": masks * valid[..., None, None]}
    tr = {"boxes": boxes_r, "valid": valid_r, "masks": masks * valid_r[..., None, None]}
    return key, ref, img_mask, sizes, tk, tr


def test_forward_sot_train_matches_jax(vit_pair, monkeypatch):
    """`loss_and_grads(task="sot")` against `jax.value_and_grad` of the
    weighted total of `forward_sot_train` scaled by `sot_loss_scale` (0.5
    here), the DN key pinned and the port handed the same noise: every loss
    (rtol 2e-5) and every gradient within 2e-4 of its leaf's largest
    value, the template ViT's, the fuser's and `adjust_layer`'s included
    (the prompt is encoded inside the differentiated function)."""
    cfg, jm, params, _ = vit_pair
    model = build_model(cfg, "cpu", seed=0, template=True).train()
    convert.load_jax_params(model, params)
    key, ref, img_mask, sizes, tk, tr = _sot_batch(cfg.data.max_insts)
    dn_key = jax.random.PRNGKey(11)
    real = jdetr.prepare_dn_static
    monkeypatch.setattr(jdetr, "prepare_dn_static",
                        lambda gb, gv, le, rng, s, **kw: real(gb, gv, le, dn_key, s, **kw))
    weights = jax_loss_weights(cfg)
    jt = lambda t: {**t, "has_masks": True}

    def loss_fn(p):
        losses = jm.apply({"params": p}, key, img_mask, sizes, jt(tk), jt(tr), ref,
                          rngs={"dn": jax.random.PRNGKey(0)},
                          method=JaxDETR.forward_sot_train)
        return jax_weighted_total(losses, weights, task_weight=0.5), losses

    (total, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"])
    pt = lambda t: {**{k: _t(v) for k, v in t.items()}, "has_masks": True}
    batch = {"images_key": _t(key), "images_ref": _t(ref), "img_mask": _t(img_mask),
             "image_sizes": _t(sizes), "targets_key": pt(tk), "targets_ref": pt(tr)}
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg),
                                       dn_noise=dn_noise(dn_key, 2, cfg.data.max_insts),
                                       task="sot")
    assert set(losses) == set(jlosses) and "loss_mask" in losses and "loss_ce_dn" in losses
    assert "loss_reid" not in losses
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_total.detach().numpy(), np.asarray(total), rtol=2e-5)

    named = dict(model.named_parameters())
    tensors = {k: p.grad if p.grad is not None else torch.zeros_like(p)
               for k, p in named.items()}
    zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
    tree, report = convert_checkpoint(tensors, copy.deepcopy(zeros))
    assert report["missing_target"] == [] and report["unused_source"] == []
    grads = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    checked = set()
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        want = np.asarray(want)
        if name.endswith("['up_res3']['bias']"):
            # one ConvTranspose2d bias for the four sub-pixels: the port's
            # gradient is their sum, copied to each
            want = np.tile(want.reshape(4, -1).sum(0), 4)
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(grads[path], want, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)
        if np.abs(want).max() > 0:
            checked.add(name.split("'")[1])
    assert {"template_backbone", "sot_fuser", "adjust_layer", "backbone",
            "transformer", "dn_resizer"} <= checked
    assert "bert" not in checked            # the template prompt replaces BERT's


def test_sot_and_vos_frame_steps_match_jax(vit_pair):
    """The template encoders (VOS: the gt mask as 4th channel; SOT: the box
    region) and the frame step with masks at 64x96 of both packages from
    the same weights, on a prompt of two templates (online update /
    inference_on_3f concatenate them): the prompts within 1e-4, the same
    chosen query, its box and score within 1e-5, its mask logits within
    1e-4 of their largest value."""
    cfg, jm, params, model = vit_pair
    rng = np.random.RandomState(8)
    frames = rng.randn(2, 1, 64, 96, 3).astype(np.float32)
    gt = np.zeros((1, 64, 96), np.float32)
    gt[0, 20:40, 30:60] = 1
    box = np.array([[30.0, 20.0, 60.0, 40.0]], np.float32)
    img_mask = np.zeros((1, 64, 96), bool)
    sizes = np.array([[64, 96]], np.int32)
    jenc = jsoti.make_template_encoder(jm, cfg, with_gt_mask=True)
    p = params["params"]
    want_t = [jenc(p, frames[0], box, gt), jenc(p, frames[0], box + 4, None)]
    enc = sot_inference.make_template_encoder(model, cfg)
    got_t = [enc(_t(frames[0]), _t(box), _t(gt)), enc(_t(frames[0]), _t(box + 4))]
    for g, w in zip(got_t, want_t):
        for k in ("hidden", "aggregate"):
            _close(g[k].numpy(), w[k], 1e-4, k)
        np.testing.assert_array_equal(g["masks"].numpy(), np.asarray(w["masks"]))
    cat = lambda ts, k: np.concatenate([np.asarray(t[k]) for t in ts], 1)
    hidden, masks = cat(want_t, "hidden"), cat(want_t, "masks")
    assert hidden.shape == (1, 2 * (TS // 8) ** 2, 64)
    jstep = jsoti.make_sot_frame_step(jm, cfg, 64, 96, with_mask=True)
    step = sot_inference.make_sot_frame_step(model, with_mask=True)
    for f in frames[1:]:
        want = jstep(p, f, img_mask, sizes, hidden, masks)
        got = step(_t(f), _t(img_mask), _t(sizes), _t(hidden), _t(masks))
        for k in ("box_cxcywh", "score"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert got["mask_logits"].shape == (1, 16, 24)
        _close(got["mask_logits"].numpy(), want["mask_logits"], 1e-4, "mask_logits")


# ---- the bridge of the template branch --------------------------------------------

@pytest.fixture(scope="module")
def video_tree():
    """The shapes of `init_all_paths` of `tiny_video_test_config` (4-channel
    R50 template backbone, fuser, adjust_layer), by `jax.eval_shape`, as
    zeros."""
    cfg = tiny_video_test_config()
    jm = JaxDETR(cfg)
    shapes = jax.eval_shape(lambda r: init_all_paths(jm, r, H=64, W=96),
                            jax.random.PRNGKey(0))
    return cfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_bridge_loads_a_whole_tree_with_the_template_branch(video_tree):
    """Every leaf consumed, every port parameter filled; a model built
    without the template branch refuses the tree, and a model with it
    refuses a tree of the video detection path, which has none."""
    cfg, tree = video_tree
    convert.load_jax_params(build_model(cfg, "cpu", seed=1, template=True), tree)
    with pytest.raises(RuntimeError, match="ref_backbone"):
        convert.load_jax_params(build_model(cfg, "cpu", seed=1), tree)
    no_branch = {"params": {k: v for k, v in tree["params"].items()
                            if k not in convert.TEMPLATE_BRANCH}}
    with pytest.raises(RuntimeError, match="adjust_layer"):
        convert.load_jax_params(build_model(cfg, "cpu", seed=1, template=True), no_branch)


@pytest.mark.parametrize("leaf", ["adjust_layer/kernel", "sot_fuser/refine_2/kernel",
                                  "template_backbone/stem_conv/kernel",
                                  "template_backbone/res3_block0/conv1/kernel",
                                  "template_backbone/res4_block1/bn2/var"])
def test_bridge_names_a_missing_template_leaf(video_tree, leaf):
    cfg, tree = video_tree
    tree = copy.deepcopy(tree)
    node = tree["params"]
    *parents, last = leaf.split("/")
    for p in parents:
        node = node[p]
    del node[last]
    with pytest.raises(KeyError, match=re.escape(leaf)):
        convert.load_jax_params(build_model(cfg, "cpu", seed=1, template=True), tree)


def test_template_optimizer_groups_match_classify_param(video_tree):
    """The template branch's groups equal JAX's `classify_param` of the
    leaves each parameter is built from: the template R50 in "backbone",
    its stem, res2 and every FrozenBN mean and var in "frozen" (they get
    gradients and no update, as the main backbone's); `sot_fuser` and
    `adjust_layer` in "base"."""
    cfg, tree = video_tree
    model = build_model(cfg, "cpu", seed=1, template=True)
    sources = bridge_sources(tree)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    groups = {n: g for g, names in opt.names.items() for n in names}
    assert set(sources) == set(groups)
    seen, by_group = set(), {}
    for key, paths in sources.items():
        for p in paths:
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert groups[key] == joptim.classify_param(tuple(p_jax.split("/"))), key
            seen.add(p_jax)
        branch = re.match(r"detr\.(?:detr\.)?(ref_backbone|sot_fuser|adjust_layer)\.", key)
        if branch:
            by_group.setdefault(groups[key], set()).add(branch.group(1))
    assert len(seen) == len(jax.tree_util.tree_leaves(tree))
    assert by_group == {"frozen": {"ref_backbone"}, "backbone": {"ref_backbone"},
                        "base": {"sot_fuser", "adjust_layer"}}
    tb = "detr.detr.ref_backbone.0.backbone."
    assert groups[tb + "stem.conv1.weight"] == "frozen"
    assert groups[tb + "res2.0.conv1.weight"] == "frozen"
    assert groups[tb + "res3.0.conv1.norm.running_var"] == "frozen"
    assert groups[tb + "res3.0.conv1.weight"] == "backbone"
    assert groups["detr.sot_fuser.refine.0.weight"] == "base"
    assert groups["detr.adjust_layer.weight"] == "base"
