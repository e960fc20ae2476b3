"""The ResNet-50 slice of the port against the JAX `UninextDETR` on the CPU,
fp32, on `tiny_test_config()` as it is (R50 at full width, 2 + 2
transformer layers of width 64, 60 queries) at 64x96 (level shapes
divisible by 32, where the JAX callers' `feature_shapes` are the real
ones): detection with `postprocess_detection`, the instance masks of the
top 100, the REC/RES top-1 box and mask, the weight bridge's round trip
with the mask head, the optimizer groups, one train step through AdamW, and
one BoxInst step's losses and gradients.

One JAX tree for the file, initialised through the training path with
mask targets and perturbed by 0.02 (the 0.05 of the ViT slice would grow
the R50 trunk's activations by 1e5; tests/test_torch_resnet.py).
"""
import copy
import dataclasses
import re

import jax
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_common import (boxinst_targets, bridge_sources, class_token_map,
                                     detection_inputs, detection_targets, dn_noise,
                                     init_statistics_match, jax_loss_and_grads, jax_train_init,
                                     one_torch_thread, perturb, shared_across_workers)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import feature_shapes
from uninext_tpu.models.postprocess import postprocess_detection as jax_post
from uninext_tpu_torch.config import tiny_test_config
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import detr
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.models.postprocess import (postprocess_detection, postprocess_instseg,
                                                  postprocess_rec)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DN_KEY = jax.random.PRNGKey(321)
BB = "detr.detr.backbone.0.backbone."


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def initial(tmp_path_factory, worker_id):
    """The JAX model and its tree as initialised, before the perturbation
    (the init compiles once per session)."""
    cfg = tiny_test_config()
    assert cfg.backbone.name == "resnet50" and cfg.mask_head.enabled
    inputs = detection_inputs(0)
    targets = detection_targets(2, G=cfg.data.max_insts)
    jm = JaxDETR(cfg)
    params = shared_across_workers("r50_initial", lambda: jax_train_init(jm, inputs, targets),
                                   tmp_path_factory, worker_id)
    return cfg, inputs, targets, jm, params


@pytest.fixture(scope="module")
def pair(initial):
    cfg, inputs, targets, jm, params = initial
    params = perturb(params, scale=0.02)
    model = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return cfg, inputs, targets, jm, params, model


@pytest.fixture(scope="module")
def served(pair, tmp_path_factory, worker_id):
    """Both frameworks' inference outputs for the two tasks (JAX's compiled
    once per session)."""
    cfg, inputs, _, jm, params, model = pair
    want = shared_across_workers("r50_served", lambda: {
        task: jax.tree.map(np.asarray, jax.jit(
            lambda p, t=task: jm.apply(p, *inputs, task=t))(params))
        for task in ("detection", "grounding")}, tmp_path_factory, worker_id)
    got = {}
    for task in ("detection", "grounding"):
        with torch.inference_mode():
            got[task] = model(*map(_t, inputs), task=task)
    return want, got


def _close(got, want, rel, what):
    """Within `rel` of the tensor's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def _masks_jax(jm, params, out, idx, inputs):
    """`predict_masks` of the JAX model for queries idx (B, K), with the
    level shapes its callers pass (`feature_shapes`)."""
    sizes = inputs[2]
    shapes = feature_shapes(4, *inputs[0].shape[1:3])
    take = lambda x: np.take_along_axis(np.asarray(x), idx[..., None], axis=1)
    return np.asarray(jax.jit(lambda p, m, h, r, s: jm.apply(
        p, m, shapes, h, r, s, method=JaxDETR.predict_masks))(
        params, out["memory"], take(out["hs"]), take(out["base_reference"]), sizes))


def test_r50_detection_matches_jax(served):
    want, got = served[0]["detection"], served[1]["detection"]
    assert got["spatial_shapes"] == feature_shapes(4, 64, 96)
    for key in ("memory", "pred_logits", "pred_boxes", "pred_boxious"):
        assert got[key].shape == want[key].shape, key
        # fp32 through R50, BERT, 2 + 2 transformer layers and the heads
        _close(got[key], want[key], 1e-4, key)
    cmap = class_token_map()
    jpost = jax.jit(lambda o: jax_post(o, cmap))(
        {k: want[k] for k in ("pred_logits", "pred_boxes", "pred_boxious")})
    with torch.inference_mode():
        post = postprocess_detection(got, _t(cmap))
    for key in ("query_idx", "classes"):
        np.testing.assert_array_equal(post[key].numpy(), np.asarray(jpost[key]), key)
    for key in ("boxes", "scores"):
        _close(post[key], jpost[key], 1e-5, key)


def test_r50_instance_masks_match_jax(pair, served):
    """`postprocess_instseg`: the top 100 detections and their mask logits
    (B, 100, 16, 24) against the JAX evaluator's inline selection and
    `predict_masks`."""
    _, inputs, _, jm, params, model = pair
    want, got = served[0]["detection"], served[1]["detection"]
    cmap = class_token_map()
    jpost = jax.jit(lambda o: jax_post(o, cmap, max_inst=100))(
        {k: want[k] for k in ("pred_logits", "pred_boxes", "pred_boxious")})
    idx = np.asarray(jpost["query_idx"])
    jmasks = _masks_jax(jm, params, want, idx, inputs)
    with torch.inference_mode():
        post = postprocess_instseg(model, got, _t(cmap), _t(inputs[2]), max_inst=100)
    np.testing.assert_array_equal(post["query_idx"].numpy(), idx)
    assert post["mask_logits"].shape == (2, 100, 16, 24)
    # the mask head's convolutions and three dynamic layers over the memory
    _close(post["mask_logits"], jmasks, 1e-4, "mask_logits")


def test_r50_rec_res_matches_jax(pair, served):
    """Grounding: logits (B, Q, 1) against the pooled expression; then
    `postprocess_rec`'s top-1 query, its box and its mask (B, 1, 16, 24)
    against `bench.py:bench_rec`'s inline selection."""
    _, inputs, _, jm, params, model = pair
    want, got = served[0]["grounding"], served[1]["grounding"]
    assert got["pred_logits"].shape == (2, 60, 1)
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        _close(got[key], want[key], 1e-4, key)
    prob = np.sqrt(jax.nn.sigmoid(np.asarray(want["pred_logits"])[..., 0])
                   * jax.nn.sigmoid(np.asarray(want["pred_boxious"])[..., 0]))
    best = np.asarray(prob).argmax(-1)[:, None]
    jmask = _masks_jax(jm, params, want, best, inputs)
    with torch.inference_mode():
        res = postprocess_rec(model, got, _t(inputs[2]))
    np.testing.assert_array_equal(res["query_idx"].numpy(), best[:, 0])
    _close(res["box"], np.take_along_axis(np.asarray(want["pred_boxes"]),
                                          best[..., None], 1)[:, 0], 1e-5, "box")
    assert res["mask_logits"].shape == (2, 1, 16, 24)
    _close(res["mask_logits"], jmask, 1e-4, "mask_logits")


def test_r50_bridge_round_trip_through_convert_checkpoint(pair):
    """JAX tree (R50, mask head) -> port -> state_dict (detectron2's ResNet
    keys, `detr.controller.*`, `detr.mask_head.*`) -> `convert_checkpoint`
    onto a zeroed tree gives back every leaf exactly."""
    *_, params, model = pair
    sd = model.state_dict()
    assert BB + "res5.2.conv3.norm.running_mean" in sd
    assert "detr.controller.layers.2.bias" in sd and "detr.mask_head.jia_dcn.weight" in sd
    zeroed = jax.tree.map(np.zeros_like, params)
    back, report = convert_checkpoint(sd, copy.deepcopy(zeroed))
    assert report["missing_target"] == []
    assert report["shape_mismatch"] == []
    assert report["unused_source"] == []
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_r50_bridge_refuses_an_image_tree_without_dn_resizer(pair):
    """Only a video tree (one with the reid head) may lack the DN label
    encoder: an image tree without `dn_resizer` raises, naming the leaf,
    and the port's `detr.resizer.*` is not left with its random values."""
    cfg, *_, params, _ = pair
    tree = {**params, "params": {k: v for k, v in params["params"].items()
                                 if k != "dn_resizer"}}
    with pytest.raises(KeyError, match="dn_resizer"):
        convert.load_jax_params(build_model(cfg, "cpu", seed=1), tree)


def test_r50_random_init_matches_jax_distributions(initial):
    """A model the port builds from a seed (what a run from scratch, as the
    fixture AP run, starts from) draws every leaf from JAX's distribution:
    constant leaves (norms, biases, FrozenBN) equal JAX's, and every other
    leaf of 16 or more entries has its standard deviation within 0.8-1.25x
    of JAX's init (different generators, so the values differ)."""
    cfg, _, _, _, params = initial
    sd = build_model(cfg, "cpu", seed=0).state_dict()
    got, report = convert_checkpoint(sd, copy.deepcopy(jax.tree.map(np.zeros_like, params)))
    assert report["missing_target"] == [] and report["unused_source"] == []
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    compared = 0
    for path, want in jax.tree_util.tree_leaves_with_path(params):
        name, g = jax.tree_util.keystr(path), np.asarray(got_leaves[path])
        if np.ptp(want) == 0:
            np.testing.assert_array_equal(g, want, err_msg=name)
        elif want.size >= 16:
            ratio = g.std() / want.std()
            assert 0.8 < ratio < 1.25, f"{name}: std {g.std():.4g} against {want.std():.4g}"
            compared += 1
    assert compared > 100


def test_r50_random_init_matches_jax_leaf_by_leaf(initial):
    """ROADMAP §3.27: the port's random init (what BoxInst's stage 1 of
    `tools/pipeline_check.py` starts from) against JAX's `init` leaf by
    leaf through `convert_checkpoint`'s names: means, standard deviations
    and extremes (`init_statistics_match`), the mask branch's leaves
    (`controller`, `mask_head`) and the mask features' inputs (the
    encoder, the input projections) among them. The fixture's tree is the
    BoxInst training path's too: flax draws a leaf from the key and the
    module that makes it, and both paths make the same modules (the
    BoxInst config only changes the losses)."""
    cfg, _, _, _, params = initial
    sd = build_model(cfg, "cpu", seed=0).state_dict()
    got, report = convert_checkpoint(sd, copy.deepcopy(jax.tree.map(np.zeros_like, params)))
    assert report["missing_target"] == [] and report["unused_source"] == []
    compared, extremes = init_statistics_match(got, params)
    heads = [n for n in compared if "controller" in n or "mask_head" in n]
    assert len(compared) > 100 and len(extremes) > 40 and len(heads) >= 6
    assert any("input_proj" in n for n in extremes)


def test_r50_optimizer_groups_match_classify_param(pair):
    """Every port parameter's group equals the JAX `classify_param` of each
    leaf the bridge builds it from, the frozen group included: the stem,
    res2 and every FrozenBN mean and var (lr 0); res3-res5's FrozenBN scale
    and bias train with the backbone, as in the JAX package."""
    cfg, *_, params, model = pair
    sources = bridge_sources(params)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    groups = {n: g for g, names in opt.names.items() for n in names}
    assert set(groups) == set(sources)
    jax_labels = {"/".join(p.key for p in path): joptim.classify_param(tuple(p.key for p in path))
                  for path, _ in jax.tree_util.tree_leaves_with_path(params["params"])}
    seen = set()
    for key, paths in sources.items():
        for p in paths:
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert groups[key] == jax_labels[p_jax], (key, p_jax)
            seen.add(p_jax)
    assert seen == set(jax_labels)
    expect = {BB + "stem.conv1.weight": "frozen",
              BB + "stem.conv1.norm.weight": "frozen",
              BB + "res2.2.conv3.weight": "frozen",
              BB + "res2.0.shortcut.norm.bias": "frozen",
              BB + "res3.0.conv1.norm.running_mean": "frozen",
              BB + "res5.2.conv2.norm.running_var": "frozen",
              BB + "res3.0.conv1.norm.weight": "backbone",
              BB + "res4.1.conv2.weight": "backbone",
              "detr.controller.layers.0.weight": "base",
              "detr.mask_head.lay1.weight": "base"}
    assert {k: groups[k] for k in expect} == expect
    assert all(p.requires_grad for p in model.parameters())


def test_r50_train_step_matches_jax(pair, monkeypatch):
    """One step on the JAX targets: every loss and every gradient against
    `jax.value_and_grad` (the frozen parameters' too, which enter the
    clip's norm), the global norm against optax's, and the parameters after
    AdamW against optax's chain on the JAX gradients; the frozen ones stay
    bit-equal. A fresh port model, so the shared one stays as loaded."""
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

    def as_tree(tensors):
        zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
        tree, report = convert_checkpoint(tensors, copy.deepcopy(zeros))
        assert report["missing_target"] == [] and report["unused_source"] == []
        return dict(jax.tree_util.tree_leaves_with_path(tree["params"]))

    grads = as_tree({k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in model.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        want = np.asarray(want)
        # 2e-4 of the leaf's largest gradient, at least 2e-6 (as the ViT step)
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(grads[path], want, rtol=0, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))

    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in opt.names["frozen"]}
    norm = opt.step()
    # optax's functions over the whole tree under one jit: run eagerly they
    # compile one small computation per leaf shape
    np.testing.assert_allclose(float(norm), float(jax.jit(optax.global_norm)(jgrads)),
                               rtol=1e-4)
    assert float(norm) > cfg.solver.grad_clip              # the clip acts
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    tx = joptim.build_optimizer(cfg.solver, params["params"])
    updates, _ = jax.jit(tx.update)(jgrads, jax.jit(tx.init)(params["params"]),
                                    params["params"])
    jnew = jax.jit(optax.apply_updates)(params["params"], updates)
    new = as_tree(dict(model.named_parameters()))
    lr = optim.group_learning_rates(cfg.solver)
    jgrad_leaves = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, want in jax.tree_util.tree_leaves_with_path(jnew):
        name = jax.tree_util.keystr(path)
        want, got, g = np.asarray(want), new[path], np.asarray(jgrad_leaves[path])
        group = joptim.classify_param(tuple(p.key for p in path))
        if group == "frozen":
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        # Adam's first step moves each element by lr x (g / (|g| + eps) + wd x p):
        # where |g| is ten times the gradients' tolerance above, both move the
        # same way; elsewhere the sign of a gradient of rounding noise may
        # differ, a move of at most 2 x lr apart
        strong = np.abs(g) >= 2e-3 * max(float(np.abs(g).max()), 1e-2)
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_less(np.abs(got - want), 2 * lr[group] + 1e-6,
                                     err_msg=name)


def test_r50_boxinst_train_step_matches_jax(pair, monkeypatch):
    """The step above with `loss.boxinst`, past the pairwise term's warm-up,
    on the same weights, inputs and boxes: every loss (`loss_prj` and
    `loss_pairwise` of every decoder layer in place of the mask and dice
    losses) and every gradient, the R50 trunk's included, against
    `jax.value_and_grad`, at the step's tolerances."""
    base, inputs, targets, _, params, _ = pair
    cfg = dataclasses.replace(base, loss=dataclasses.replace(
        base.loss, boxinst=True, boxinst_warmup_iters=4))
    model = build_model(cfg, "cpu", seed=0).train()
    convert.load_jax_params(model, params)
    extra = boxinst_targets(8, inputs, targets, step=6)
    total, jlosses, jgrads = jax_loss_and_grads(JaxDETR(cfg), params, inputs, targets, cfg,
                                                monkeypatch, DN_KEY, boxinst=extra)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(targets[0]), "valid": _t(targets[1]),
                         "positive_map": _t(targets[2]), "has_masks": True,
                         "box_bitmasks": _t(extra["box_bitmasks"]),
                         "color_similarity": _t(extra["color_similarity"]), "step": 6}}
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg),
                                       dn_noise=dn_noise(DN_KEY, 2, single_pad))
    assert set(losses) == set(jlosses) and {"loss_prj", "loss_pairwise_0"} <= set(losses)
    assert not any(k.startswith(("loss_mask", "loss_dice")) for k in losses)
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    assert float(losses["loss_pairwise"].detach()) > 0 and float(losses["loss_prj"].detach()) > 0
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
        held += name.startswith(("['mask_head']", "['controller']")) and np.abs(want).max() > 0
    assert held > 0                      # the mask losses reach the mask head
