"""The ConvNeXt slice of the port against the JAX package on the CPU: the
trunk (`uninext_tpu_torch/models/convnext.py` against
`uninext_tpu/models/convnext.py`, 3 and 4 input channels, fp32 and bf16),
the weight bridge both ways, drop-path by its statistics, the small
ConvNeXt model of the fixture tool (`tools/convnext_check.py:
tiny_convnext_cfg`: depths 2/2/4/2, dims 32/64/96/128) serving and taking a
train step, both ConvNeXt-L presets at full width on the meta device
(bridge, parameter counts, optimizer groups, strictness), the stage
hand-off with the 3 -> 4 channel stem, tensor parallelism leaving ConvNeXt
whole, RoBERTa, and the trunk's random initialisation against JAX's `init`
leaf by leaf (ROADMAP §3.27).

Drop-path draws from JAX's 'droppath' rng there and from a
`torch.Generator` here, so parity is held at rate 0 and drop-path by its
statistics. Inputs and weights come from numpy; the JAX trees of the
models from `jax.eval_shape`, not a compiled init.
"""
import copy
import dataclasses
import importlib.util
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uninext_tpu.config as jcfg
from tests.test_torch_handoff import check_handoff_through_the_bridge
from tests.test_torch_sot import _random_tree
from tests.torch_port_common import (bridge_sources, detection_inputs, detection_targets,
                                     dn_noise, init_statistics_match, jax_loss_and_grads,
                                     perturb)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.convert import convert_checkpoint, convert_convnext
from uninext_tpu.models import convnext as jconvnext
from uninext_tpu.models.bert import BertEncoder
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import init_all_paths
from uninext_tpu.parallel.sharding import param_pspec
import uninext_tpu_torch.config as tcfg
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.checkpoint import load_stage_weights
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import convnext, detr
from uninext_tpu_torch.models.bert import BertModel
from uninext_tpu_torch.models.detr import UninextDETR, build_model, init_params
from uninext_tpu_torch.models.layers import Conv2d
from uninext_tpu_torch.parallel import sharding
from uninext_tpu_torch.tools.convnext_check import tiny_convnext_cfg

DEPTHS, DIMS = (2, 2, 4, 2), (32, 64, 96, 128)
H, W = 64, 96
LEVELS = ("res3", "res4", "res5")
DN_KEY = jax.random.PRNGKey(321)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_tool_cfg(steps):
    """`tools/convnext_check.py:tiny_convnext_cfg` of the JAX tool (loaded
    by path; the path it puts on `sys.path` is taken off again)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_convnext_check", os.path.join(REPO, "tools", "convnext_check.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.tiny_convnext_cfg(steps)
    finally:
        sys.path[:] = path


def _trunk(dtype=torch.float32, in_channels=3, rate=0.0):
    return convnext.ConvNeXt(DEPTHS, DIMS, drop_path_rate=rate, in_channels=in_channels,
                             dtype=dtype)


# ---- the trunk ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[3, 4], ids=["3ch", "4ch"])
def trunk(request):
    c = request.param
    x = np.random.RandomState(c).randn(2, H, W, c).astype(np.float32)
    jm = lambda dt: jconvnext.ConvNeXt(depths=DEPTHS, dims=DIMS, in_channels=c, dtype=dt)
    raw = jax.tree.map(np.asarray, jm(jnp.float32).init(jax.random.PRNGKey(0), x))
    params = perturb(raw, scale=0.02)
    want = {}
    for name, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        out = jax.jit(jm(dt).apply)(params, x)
        assert all(out[k].dtype == jnp.float32 for k in LEVELS)   # flax's LN promotes
        want[name] = {k: np.asarray(out[k]) for k in LEVELS}
    return c, x, params, want, raw


def _port(params, dtype, c):
    m = _trunk(dtype, c)
    convert.load_jax_params(m, params, fill=convert.fill_convnext)
    return m


def test_convnext_fp32_matches_jax(trunk):
    c, x, params, want, _ = trunk
    with torch.no_grad():
        got = _port(params, torch.float32, c)(torch.from_numpy(x))
    assert set(got) == set(LEVELS)
    for k in LEVELS:
        w = want["j32"][k]
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_convnext_bf16_as_close_to_fp32_as_jax_bf16(trunk):
    """The convolutions and the MLP in bf16, the LayerNorms and the
    residual stream in fp32 (res3-res5 come out fp32, as JAX's), held by
    the distance from JAX fp32: at most 1.5x JAX bf16's, in the maximum and
    the median of each level."""
    c, x, params, want, _ = trunk
    with torch.no_grad():
        got = _port(params, torch.bfloat16, c)(torch.from_numpy(x))
    for k in LEVELS:
        assert got[k].dtype == torch.float32, k
        port = np.abs(got[k].numpy() - want["j32"][k])
        own = np.abs(want["j16"][k] - want["j32"][k])
        assert own.max() > 0
        assert port.max() <= 1.5 * own.max(), (k, port.max(), own.max())
        assert np.median(port) <= 1.5 * np.median(own), (k, np.median(port), np.median(own))


def test_convnext_stays_channels_last(trunk):
    """Every convolution gets an NHWC-contiguous input (cuDNN's channels-last
    layout as its NCHW view), and the levels come out NHWC-contiguous."""
    c, x, params, _, _ = trunk
    m = _port(params, torch.float32, c)
    seen = []
    for mod in m.modules():
        if isinstance(mod, Conv2d):
            mod.register_forward_pre_hook(lambda mod, a: seen.append(a[0].is_contiguous()))
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert len(seen) == 4 + sum(DEPTHS) and all(seen)
    assert all(out[k].is_contiguous() for k in LEVELS)


def test_convnext_bridge_round_trip_through_convert_convnext(trunk):
    """JAX tree -> `fill_convnext` -> the port's state_dict (D2ConvNeXt's
    keys) -> the JAX package's `convert_convnext` onto a zeroed tree gives
    back every leaf exactly; and `jax_module_path` names each JAX leaf."""
    c, _, params, _, _ = trunk
    sd = _port(params, torch.float32, c).state_dict()
    assert sd["downsample_layers.0.0.weight"].shape == (DIMS[0], c, 4, 4)
    assert sd["stages.2.3.dwconv.weight"].shape == (DIMS[2], 1, 7, 7)
    assert {"stages.0.0.gamma.weight", "norm3.bias"} <= set(sd)
    zeroed = {"backbone": jax.tree.map(np.zeros_like, params["params"])}
    report = {"loaded": 0, "missing_target": [], "shape_mismatch": []}
    convert_convnext(sd, zeroed, report, src_prefix="")
    leaves = jax.tree_util.tree_leaves_with_path(params["params"])
    assert report == {"loaded": len(leaves), "missing_target": [], "shape_mismatch": []}
    back = dict(jax.tree_util.tree_leaves_with_path(zeroed["backbone"]))
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    for root in ("backbone", "ref_backbone"):
        names = {convert.jax_module_path(f"detr.detr.{root}.0.backbone.{k}") for k in sd}
        prefix = "template_backbone/" if root == "ref_backbone" else "backbone/"
        assert names == {prefix + "/".join(p.key for p in path) for path, _ in leaves}


def test_convnext_gradient_on_zero_padding_matches_jax(trunk):
    """ROADMAP §3.29: at init (zero biases) a region of exact zeros (the
    collate pads normalised images with 0) reaches every LayerNorm there as
    an all-zero vector, whose gradient is 1 / sqrt(eps) = 1000 times its
    output's; the biases' gradients grow by about that for each such
    LayerNorm. The port's trunk gives JAX's gradients there too (every
    leaf within 1e-4 of its largest), the stem bias's above 1e6 against
    O(1) for the same image without padding."""
    c, x, _, _, raw = trunk
    x = x[:1].copy()
    x[:, :, W // 2:] = 0
    jm = jconvnext.ConvNeXt(depths=DEPTHS, dims=DIMS, in_channels=c)
    cot = {k: np.random.RandomState(9).randn(*v.shape).astype(np.float32)
           for k, v in jax.eval_shape(jm.apply, raw, x).items()}
    jgrad = jax.jit(jax.grad(lambda p: sum((jm.apply(p, x)[k] * cot[k]).sum() for k in cot)))(
        raw)
    want = convert.state_dict_from_jax(jgrad, convert.fill_convnext)
    m = _port(raw, torch.float32, c)
    out = m(torch.from_numpy(x))
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    for k, p in m.named_parameters():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4 * max(scale, 1e-6), err_msg=k)
    assert float(want["downsample_layers.0.0.bias"].abs().max()) > 1e6


def test_clip_norm_stays_finite_above_the_fp32_range():
    """The clip's global norm is summed in fp64: with gradients of 1e20
    (optax's fp32 norm is inf there, and its clip zeroes the step) it is
    the exact norm, and the step moves the parameters by finite amounts."""
    import optax
    a, b = torch.nn.Parameter(torch.zeros(1000)), torch.nn.Parameter(torch.ones(10))
    a.grad, b.grad = torch.full((1000,), 1e20), torch.ones(10)
    opt = optim.AdamW([("backbone/x/kernel", a), ("y/kernel", b)],
                      tcfg.tiny_test_config().solver, path_of=lambda n: n)
    norm = opt.step()
    assert float(norm) == pytest.approx(np.sqrt(1000) * 1e20, rel=1e-6)
    assert torch.isfinite(a).all() and torch.isfinite(b).all() and a.abs().max() > 0
    assert not np.isfinite(float(optax.global_norm([np.full(1000, 1e20, np.float32)])))


def test_zero_channel_makes_the_4_channel_trunk_the_3_channel_one():
    """A 4-channel trunk whose stem is the 3-channel one's inflated by
    `load_stage_weights` (the 4th input channel zero) gives, on [image, 0],
    what the 3-channel trunk gives on the image (the half of
    tests/test_convnext_parity.py::test_convnext_4ch_template_inflation
    that needs no reference checkout); once the 4th channel's weights
    train away from 0, a mask in that channel changes the levels."""
    three, four = _trunk(), _trunk(in_channels=4)
    init_params(three, torch.Generator().manual_seed(0))
    init_params(four, torch.Generator().manual_seed(1))
    sd, rep = load_stage_weights(four.state_dict(), three.state_dict(), verbose=False)
    assert rep["inflated"] == 1 and rep["loaded"] == len(sd) and not rep["mismatched"]
    four.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, H, W, 3).astype(np.float32))
    with torch.no_grad():
        want = three(x)
        got = four(torch.cat([x, torch.zeros_like(x[..., :1])], -1))
        stem = four.downsample_layers[0][0].weight
        assert torch.equal(stem[:, :3], three.downsample_layers[0][0].weight)
        assert not stem[:, 3].any()
        # (a constant would not do: the stem's LayerNorm takes it out again)
        stem[:, 3] = 0.1 * torch.randn(stem[:, 3].shape, generator=torch.Generator().manual_seed(6))
        other = four(torch.cat([x, torch.ones_like(x[..., :1])], -1))
    for k in LEVELS:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        assert float((other[k] - want[k]).abs().max()) > 1e-2 * scale, k


# ---- drop-path ----------------------------------------------------------------------

def test_drop_path_by_its_statistics():
    """Per-sample masks of 0 or 1, kept with probability 1 - rate; a kept
    sample's branch scaled by 1 / keep, a dropped one's output its input;
    the rates rise linearly from 0 over the blocks; eval mode is the
    identity, as is training at rate 0."""
    g = torch.Generator().manual_seed(0)
    mask, keep = convnext.drop_path_mask(20000, 0.3, g, "cpu")
    assert mask.shape == (20000,) and set(mask.unique().tolist()) == {0.0, 1.0}
    assert keep == pytest.approx(0.7) and abs(float(mask.mean()) - 0.7) < 0.01
    blk = convnext.Block(16, 1.0, torch.float32)
    init_params(blk, torch.Generator().manual_seed(1))
    x = torch.randn(8, 5, 7, 16, generator=torch.Generator().manual_seed(2))
    mask, keep = convnext.drop_path_mask(8, 0.5, torch.Generator().manual_seed(3), "cpu")
    assert 0 < float(mask.sum()) < 8
    with torch.no_grad():
        full, dropped = blk(x), blk(x, (mask, keep))
    for b in range(8):
        if mask[b] == 0:
            assert torch.equal(dropped[b], x[b]), b
        else:
            torch.testing.assert_close(dropped[b] - x[b], (full[b] - x[b]) / keep,
                                       rtol=1e-5, atol=1e-6)
    m = _trunk(rate=0.7)
    init_params(m, torch.Generator().manual_seed(4))
    assert m.drop_path_rates == pytest.approx(list(np.linspace(0, 0.7, sum(DEPTHS))))
    img = torch.randn(4, H, W, 3, generator=torch.Generator().manual_seed(5))
    det = _trunk(rate=0.0)
    det.load_state_dict(m.state_dict())
    with torch.no_grad():
        want = det(img)
        evald = m(img, train=False, generator=torch.Generator().manual_seed(6))
        trained = m(img, train=True, generator=torch.Generator().manual_seed(6))
        at_zero = det(img, train=True, generator=torch.Generator().manual_seed(6))
    for k in LEVELS:
        assert torch.equal(evald[k], want[k]) and torch.equal(at_zero[k], want[k]), k
    assert any(not torch.equal(trained[k], want[k]) for k in LEVELS)


# ---- the small ConvNeXt model --------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The fixture tool's config (held to the JAX tool's), the JAX model, a
    tree of its training path's shapes with mask targets (`jax.eval_shape`,
    no compiled init) and random values (`_random_tree`, the layer scales
    `gamma` 1 + 0.02 N(0, 1)), and the port's model loaded from it."""
    cfg, jc = tiny_convnext_cfg(10), _jax_tool_cfg(10)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    inputs = detection_inputs(0)
    targets = detection_targets(2, G=cfg.data.max_insts)
    jm = JaxDETR(jc)
    boxes, valid, pm = targets
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm, "has_masks": True,
           "masks": np.zeros((2, valid.shape[1], H // 4, W // 4), np.float32)}
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dn": jax.random.fold_in(r, 1)},
                                              *inputs, targets=tgt, train=True),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (1 + 0.02 * rng.randn(*x.shape)).astype(np.float32)
        if path[-1].key == "gamma" else x, _random_tree(shapes, seed=1))
    model = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return cfg, inputs, targets, jm, params, model


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


@pytest.mark.parametrize("task", ["detection", "grounding"])
def test_tiny_convnext_model_serving_matches_jax(pair, task):
    _, inputs, _, jm, params, model = pair
    want = jax.jit(lambda p: jm.apply(p, *inputs, task=task))(params)
    with torch.inference_mode():
        got = model(*map(_t, inputs), task=task)
    for key in ("memory", "pred_logits", "pred_boxes", "pred_boxious"):
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key], 1e-4, f"{task} {key}")


def test_tiny_convnext_train_step_matches_jax(pair, monkeypatch):
    """One step at drop-path 0 (the fixture's): every loss and every
    gradient, the trunk's included, against `jax.value_and_grad` of
    `model.apply`, at the R50 step's tolerances; the stem's gradient is
    taken (it enters the clip's norm) though its group is frozen."""
    cfg, inputs, targets, jm, params, _ = pair
    model = build_model(cfg, "cpu", seed=0).train()
    convert.load_jax_params(model, params)
    total, jlosses, jgrads = jax_loss_and_grads(jm, params, inputs, targets, cfg,
                                                monkeypatch, DN_KEY)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(targets[0]), "valid": _t(targets[1]),
                         "positive_map": _t(targets[2])}}
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg),
                                       dn_noise=dn_noise(DN_KEY, 2, single_pad))
    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_total.detach().numpy(), np.asarray(total), rtol=2e-5)
    zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
    tree, report = convert_checkpoint(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()}, copy.deepcopy(zeros))
    assert report["missing_target"] == [] and report["unused_source"] == []
    grads = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    held = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(grads[path], want, rtol=0, atol=2e-4 * scale, err_msg=name)
        held += name.startswith("['backbone']") and np.abs(want).max() > 0
    assert held > 30                         # the trunk's gradients, stem included


# ---- full width on the meta device ---------------------------------------------------

def _zero_tree(shapes):
    """Arrays of the tree's shapes that take no memory (zero strides)."""
    return jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)


def _meta_state_dict(params, fill=convert.fill_model):
    """What `state_dict_from_jax` makes of the tree, as meta tensors of the
    same shapes: the bridge runs over every leaf (and must consume each)
    without making a copy of the weights."""
    lv = convert._Leaves(params)
    sd = {}
    fill(sd, "", lv, "")
    lv.check_empty()
    return {k: torch.empty(np.shape(v), device="meta") for k, v in sd.items()}


@pytest.mark.parametrize("preset", ["image_joint_convnext_large",
                                    "video_joint_convnext_large"])
def test_full_width_preset_on_the_meta_device(preset, monkeypatch):
    """`init_all_paths`'s tree of the preset (by `jax.eval_shape`): the
    bridge consumes every leaf and fills every tensor of the port's model
    (with the template branch, which the tree holds) at equal shapes, and
    `load_jax_params` is strict both ways; the parameter counts are equal;
    every port parameter's optimizer group is the JAX `classify_param` of
    each leaf it is built from, ConvNeXt's stem (and the template's) in the
    frozen group."""
    jc, tc = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    shapes = jax.eval_shape(lambda r: init_all_paths(JaxDETR(jc), r, H=64, W=96),
                            jax.random.PRNGKey(0))
    tree = _zero_tree(shapes)
    with torch.device("meta"):
        model = UninextDETR(tc, template=True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert (n_jax == 337926624) == (preset == "image_joint_convnext_large")
    monkeypatch.setattr(convert, "state_dict_from_jax", _meta_state_dict)
    convert.load_jax_params(model, tree)
    sd = _meta_state_dict(tree)
    want = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    bb = "detr.detr.backbone.0.backbone."
    assert want[bb + "stages.2.26.pwconv1.weight"].shape == (3072, 768)
    if tc.sot.extra_backbone_for_template:
        assert want["detr.detr.ref_backbone.0.backbone.downsample_layers.0.0.weight"].shape \
            == (192, 4, 4, 4)
    # strict both ways: a leaf short, a leaf over, a model without the branch
    short = copy.copy(tree)
    short["params"] = {**tree["params"], "backbone": {
        k: v for k, v in tree["params"]["backbone"].items() if k != "stage2_block26"}}
    with pytest.raises(RuntimeError, match=r"stages\.2\.26\.gamma"):
        convert.load_jax_params(model, short)
    over = copy.copy(tree)
    over["params"] = {**tree["params"], "backbone": {
        **tree["params"]["backbone"], "stage3_block3": tree["params"]["backbone"]["stage3_block2"]}}
    with pytest.raises(RuntimeError, match=r"does not have: \[[^]]*stages\.3\.3\."):
        convert.load_jax_params(model, over)
    with torch.device("meta"):
        plain = UninextDETR(tc)
    with pytest.raises(RuntimeError, match="adjust_layer"):
        convert.load_jax_params(plain, tree)
    # the optimizer's groups, leaf by leaf
    sources = bridge_sources(tree)
    assert set(sources) == set(want)
    jax_labels = {"/".join(p.key for p in path): joptim.classify_param(tuple(p.key for p in path))
                  for path, _ in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    seen = set()
    for key, paths in sources.items():
        group = optim.classify_param(convert.jax_module_path(key))
        for p in paths:
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert group == jax_labels[p_jax], (key, p_jax)
            seen.add(p_jax)
    assert seen == set(jax_labels)
    groups = {k: optim.classify_param(convert.jax_module_path(k)) for k in want}
    stems = [k for k in want if ".downsample_layers.0." in k]
    assert len(stems) == 4 * (2 if tc.sot.extra_backbone_for_template else 1)
    assert {groups[k] for k in stems} == {"frozen"}
    assert groups[bb + "stages.0.0.dwconv.weight"] == "backbone"
    assert groups[bb + "downsample_layers.1.0.weight"] == "backbone"


# ---- the hand-off and tensor parallelism ---------------------------------------------

def test_convnext_handoff_matches_jax_through_the_bridge():
    """`load_stage_weights` from the small ConvNeXt image config into its
    video config with the 4-channel template ConvNeXt, against JAX's, as
    tests/test_torch_handoff.py does for R50: one convolution inflated
    (the stem, (32, 3, 4, 4) -> (32, 4, 4, 4))."""
    img_cfg = tiny_convnext_cfg(10)
    vid_cfg = dataclasses.replace(img_cfg, use_reid=True, sot=dataclasses.replace(
        img_cfg.sot, extra_backbone_for_template=True, feature_fusion=True))
    jvid = dataclasses.replace(_jax_tool_cfg(10), use_reid=True, sot=dataclasses.replace(
        img_cfg.sot, extra_backbone_for_template=True, feature_fusion=True))
    shapes = jax.eval_shape(lambda r: init_all_paths(JaxDETR(jvid), r, H=64, W=96),
                            jax.random.PRNGKey(0))
    image_part = {"params": {k: v for k, v in shapes["params"].items()
                             if k not in convert.TEMPLATE_BRANCH and not k.startswith("reid_")}}
    rep = check_handoff_through_the_bridge(img_cfg, vid_cfg, _random_tree(image_part, seed=1),
                                           _random_tree(shapes, seed=2),
                                           "downsample_layers.0.0.weight")
    assert rep["inflated"] == 1 and rep["remapped_template"] == len(
        [k for k in build_model(vid_cfg, "cpu", template=True).state_dict()
         if k.startswith("detr.detr.ref_backbone.")])


def test_tensor_parallelism_leaves_convnext_whole(pair):
    """JAX's TP rules name no ConvNeXt leaf (every backbone leaf of the
    small model's tree is replicated), and `shard_module` over a model
    group of 2 leaves every ConvNeXt parameter whole and replicated while it
    cuts BERT."""
    *_, params, _ = pair
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        if path[0].key == "backbone":
            assert param_pspec(path, leaf) == jax.sharding.PartitionSpec(), path
    model = build_model(tiny_convnext_cfg(10), "cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mesh = types.SimpleNamespace(model_size=2, model_rank=0, model_group=None)
    sharding.shard_module(model, mesh)
    bb = [(n, p) for n, p in model.named_parameters() if ".backbone.0.backbone." in n]
    assert len(bb) == 4 * 4 + 3 * 2 + 9 * sum(DEPTHS)
    for n, p in bb:
        assert p.tp_kind == "replicated" and torch.equal(p.data, before[n]), n
    assert any(p.tp_kind == "sharded" for n, p in model.named_parameters()
               if n.startswith("text_encoder."))


# ---- RoBERTa ----------------------------------------------------------------------------

def test_roberta_matches_jax():
    """`roberta-base`'s encoder at a small width (its own vocabulary,
    positions, one token type and LN eps 1e-5) against JAX's `BertEncoder`,
    with pad id 1 inside a row and at its end: RoBERTa's position ids come
    from the ids, so a pad token inside the valid span shifts the later
    positions; the bridge (`fill_bert`) carries the shapes; and the
    full-width tower's shapes equal JAX's."""
    lc = dataclasses.replace(jcfg.roberta_base_language(), hidden_dim=64, num_layers=2,
                             num_heads=4, intermediate_dim=128)
    tc = dataclasses.replace(tcfg.roberta_base_language(), hidden_dim=64, num_layers=2,
                             num_heads=4, intermediate_dim=128)
    assert dataclasses.asdict(lc) == dataclasses.asdict(tc)
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 50265, (3, 24)).astype(np.int32)
    ids[0, 7] = 1                       # a pad id inside the valid span
    ids[1, 18:] = 1                     # padding at the end
    ids[2, 0] = 0                       # <s>
    mask = (ids != 1).astype(np.int32)
    mask[0, 7] = 1
    jm = BertEncoder(lc)
    params = perturb(jm.init(jax.random.PRNGKey(0), ids, mask), scale=0.05)
    want = jax.jit(jm.apply)(params, ids, mask)
    model = BertModel(tc)
    convert.load_jax_params(model, {"params": params["params"]},
                            fill=convert.fill_bert)
    assert model.embeddings.position_embeddings.weight.shape == (514, 64)
    assert model.embeddings.token_type_embeddings.weight.shape == (1, 64)
    assert model.encoder.layer[0].output.LayerNorm.eps == 1e-5
    with torch.no_grad():
        got = model(_t(ids).long(), _t(mask))
    for k in ("hidden", "aggregate"):
        _close(got[k], want[k], 1e-5, k)
    plain = BertModel(dataclasses.replace(tc, model_type="bert-base-uncased"))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        arange = plain(_t(ids).long(), _t(mask))
    assert float((arange["hidden"] - got["hidden"]).abs().max()) > 1e-2   # positions differ
    shapes = jax.eval_shape(BertEncoder(jcfg.roberta_base_language()).init,
                            jax.random.PRNGKey(0), ids, mask)
    with torch.device("meta"):
        full = BertModel(tcfg.roberta_base_language())
    sd = _meta_state_dict(_zero_tree(shapes), fill=convert.fill_bert)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in full.state_dict().items()}


def test_roberta_request_through_the_model():
    """`tiny_test_config` with a small RoBERTa tower serves a REC/RES
    request whose ids are padded with 1: the prompt's padding masks its
    tokens out, as a model with the BERT tower does."""
    base = tcfg.tiny_test_config()
    cfg = dataclasses.replace(base, language=dataclasses.replace(
        tcfg.roberta_base_language(), hidden_dim=64, num_layers=2, num_heads=4,
        intermediate_dim=128, max_len=32))
    model = build_model(cfg, "cpu", seed=0)
    images, img_mask, sizes, _, _ = detection_inputs(0)
    ids = np.random.RandomState(1).randint(3, 50265, (2, 16))
    ids[:, 10:] = 1
    tmask = (ids != 1).astype(np.int32)
    with torch.inference_mode():
        out = model(_t(images), _t(img_mask), _t(sizes), _t(ids).long(), _t(tmask),
                    task="grounding")
    assert out["pred_logits"].shape == (2, cfg.transformer.num_queries, 1)
    assert torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_boxes"]).all()


def test_convnext_random_init_matches_jax_leaf_by_leaf(trunk):
    """The port's ConvNeXt as `build_model` initialises it (`init_params`:
    flax's truncated lecun-normal kernels, unit norms, `gamma` 1.0) against
    JAX's `init` of the trunk, leaf by leaf through `convert_convnext`'s
    names (`init_statistics_match`; ROADMAP §3.27). The model's other
    leaves are `tiny_test_config`'s, held in tests/test_torch_r50.py."""
    c, _, _, _, raw = trunk
    m = _trunk(in_channels=c)
    init_params(m, torch.Generator().manual_seed(0))
    zeroed = {"backbone": jax.tree.map(np.zeros_like, raw["params"])}
    report = {"loaded": 0, "missing_target": [], "shape_mismatch": []}
    convert_convnext(m.state_dict(), zeroed, report, src_prefix="")
    assert not report["missing_target"] and not report["shape_mismatch"]
    gammas = [k for k, _ in jax.tree_util.tree_leaves_with_path(raw) if "gamma" in str(k)]
    assert len(gammas) == sum(DEPTHS)
    compared, extremes = init_statistics_match(zeroed["backbone"], raw["params"],
                                               min_extremes=1024)
    assert len(compared) == len(extremes) == 4 + 3 * sum(DEPTHS)     # every kernel
