"""The port's detection training step vs the JAX package, on the CPU, fp32.

Pieces (DN queries, matchers, losses, optimizer) and then one whole step
of the small ViT config: the same numpy inputs go to both frameworks. The
JAX side is compiled as plain `jax.jit` of the functions (never through
`make_train_step`, `create_train_state` or `Trainer`).

Random numbers: the JAX model draws its DN noise from `jax.random`; the
whole-step test pins its key with `monkeypatch` and hands the port the same
(sign, part) tensors, computed from that key exactly as
`uninext_tpu/models/detr.py:123-125` does. Drop-path is 0 in the config.
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (bridge_sources, detection_inputs, detection_targets, dn_noise,
                                     jax_loss_and_grads, one_torch_thread, perturb, tiny_vit_config,
                                     tiny_vit_init)
from uninext_tpu.config import LossConfig as JLossConfig
from uninext_tpu.config import SolverConfig as JSolverConfig
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.engine.train import loss_weights as jloss_weights
from uninext_tpu.engine.train import weighted_total as jweighted_total
from uninext_tpu.models import criterion as jcrit
from uninext_tpu.models import matcher as jmatch
from uninext_tpu_torch.config import LossConfig, SolverConfig
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights, weighted_total
from uninext_tpu_torch.models import criterion as crit
from uninext_tpu_torch.models import detr, matcher
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- DN ---------------------------------------------------------------------

@pytest.mark.parametrize("Q,single_pad,groups", [(900, 20, 5), (60, 20, 5), (7, 3, 2)])
def test_dn_attn_mask_matches_jax(Q, single_pad, groups):
    np.testing.assert_array_equal(
        detr.build_dn_attn_mask(Q, single_pad, groups),
        jdetr.build_dn_attn_mask(Q, single_pad, groups))


def test_prepare_dn_static_matches_jax():
    boxes, valid, _ = detection_targets(4, B=2, G=20)
    label_enc = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda b, v, l, k: jdetr.prepare_dn_static(b, v, l, k, 1.0, single_pad=20))(
        boxes, valid, label_enc, key)
    got = detr.prepare_dn_static(_t(boxes), _t(valid), _t(label_enc), 1.0,
                                 noise=dn_noise(key, 2, 20), single_pad=20)
    # the same fp32 box arithmetic op for op; inverse_sigmoid's log: 1 ulp
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=2e-6)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))


def test_prepare_dn_static_draws_from_generator():
    boxes, valid, _ = detection_targets(6, B=2, G=20)
    label_enc = torch.zeros(2, 8)
    outs = [detr.prepare_dn_static(_t(boxes), _t(valid), label_enc, 1.0,
                                   generator=torch.Generator().manual_seed(s))[1]
            for s in (0, 0, 1)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])


# ---- matchers ----------------------------------------------------------------

def _match_inputs(seed, B=2, Q=40, G=6, T=12):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Q, T).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                           rng.uniform(0.05, 0.4, (B, Q, 2))], -1).astype(np.float32)
    boxes, valid, pm = detection_targets(seed + 1, B=B, G=G, T=T, n=(2, G))
    return logits, pred, pm, boxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_matrices_match_jax(seed):
    logits, pred, pm, boxes, valid = _match_inputs(seed)
    got = matcher.vl_cost_matrix(*map(_t, (logits, pred, pm, boxes, valid)))
    want = jax.jit(jax.vmap(jmatch.vl_cost_matrix))(logits, pred, pm, boxes, valid)
    # fp32 logs, GIoU and a 12-token einsum: summation order only
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    cost, iou = matcher.ota_cost_and_iou(*map(_t, (logits, pred, pm, boxes, valid)))
    jcost, jiou = jax.jit(jax.vmap(jmatch.ota_cost_and_iou))(logits, pred, pm, boxes, valid)
    np.testing.assert_allclose(_np(cost), np.asarray(jcost), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(iou), np.asarray(jiou), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_matches_jax_lsa(seed):
    """scipy's linear_sum_assignment on the host vs the JAX package's
    on-device Jonker-Volgenant: the same assignment on random costs with
    padded gts (a unique optimum, so exact)."""
    rng = np.random.RandomState(seed)
    cost = rng.rand(2, 30, 8).astype(np.float32)
    valid = rng.rand(2, 8) > 0.3
    got = matcher.hungarian_match(_t(cost), _t(valid))
    want = jax.jit(jax.vmap(jmatch.hungarian_match))(cost, valid)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_matches_jax(seed):
    logits, pred, pm, boxes, valid = _match_inputs(seed + 10, Q=60, G=8)
    cost, iou = jax.jit(jax.vmap(jmatch.ota_cost_and_iou))(logits, pred, pm, boxes, valid)
    cost, iou = np.asarray(cost), np.asarray(iou)
    q2g, g2q = matcher.simota_match(_t(cost), _t(iou), _t(valid))
    jq2g, jg2q = jax.jit(jax.vmap(jmatch.simota_match))(cost, iou, valid)
    np.testing.assert_array_equal(_np(q2g), np.asarray(jq2g))
    np.testing.assert_array_equal(_np(g2q), np.asarray(jg2q))


# ---- losses ------------------------------------------------------------------

def test_losses_match_jax():
    logits, pred, pm, boxes, valid = _match_inputs(20, Q=30, G=6)
    rng = np.random.RandomState(21)
    q2g = np.where(rng.rand(2, 30) > 0.6, rng.randint(0, 6, (2, 30)), -1).astype(np.int32)
    tmask = (rng.rand(2, 12) > 0.2).astype(np.int32)
    ious = rng.randn(2, 30, 1).astype(np.float32)
    nb = np.float32(7.0)
    jcfg, cfg = JLossConfig(), LossConfig()
    ce = crit.loss_labels_vl(_t(logits), _t(pm), _t(q2g), _t(tmask), torch.tensor(nb), cfg)
    jce = jax.jit(lambda *a: jcrit.loss_labels_vl(*a, jcfg))(logits, pm, q2g, tmask, nb)
    # focal terms of 720 logits summed in fp32: summation order only
    np.testing.assert_allclose(_np(ce), np.asarray(jce), rtol=1e-5)
    bx = crit.loss_boxes(_t(pred), _t(boxes), _t(q2g), torch.tensor(nb), _t(ious))
    jbx = jax.jit(jcrit.loss_boxes)(pred, boxes, q2g, nb, ious)
    assert set(bx) == set(jbx) == {"loss_bbox", "loss_giou", "loss_boxiou"}
    for k in bx:
        np.testing.assert_allclose(_np(bx[k]), np.asarray(jbx[k]), rtol=1e-5, err_msg=k)
    x = rng.randn(50).astype(np.float32) * 4
    y = (rng.rand(50) > 0.5).astype(np.float32)
    np.testing.assert_allclose(_np(crit.sigmoid_focal_loss(_t(x), _t(y))),
                               np.asarray(jcrit.sigmoid_focal_loss(x, y)), rtol=1e-5,
                               atol=1e-7)


def test_weighted_total_matches_jax():
    names = ["loss_ce", "loss_ce_0", "loss_bbox_enc", "loss_giou_dn_1", "loss_boxiou",
             "loss_reid", "loss_reid_aux", "loss_dice_2"]
    vals = np.random.RandomState(3).rand(len(names)).astype(np.float32)
    cfg = tiny_vit_config()
    from uninext_tpu.config import tiny_test_config as jtiny
    assert loss_weights(cfg) == jloss_weights(jtiny())
    got = weighted_total({n: torch.tensor(v) for n, v in zip(names, vals)},
                         loss_weights(cfg))
    want = jweighted_total(dict(zip(names, vals)), jloss_weights(jtiny()))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


# ---- optimizer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory, worker_id):
    """The small ViT config's JAX model and parameter tree (initialised
    through its training path, perturbed; once per session), the port's
    model loaded from it, and a batch: inputs and targets padded to
    max_insts."""
    cfg = tiny_vit_config()
    inputs = detection_inputs(1)
    targets = detection_targets(2, G=cfg.data.max_insts)
    jm = jdetr.UninextDETR(cfg)
    params = perturb(tiny_vit_init(tmp_path_factory, worker_id))
    model = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return cfg, jm, params, model, inputs, targets


def test_optimizer_groups_match_classify_param(pair):
    """Every port parameter's group equals `classify_param` of each JAX leaf
    the bridge builds it from, and every JAX leaf is reached."""
    cfg, jm, params, model, _, _ = pair
    sources = bridge_sources(params)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    groups = {n: g for g, names in opt.names.items() for n in names}
    assert set(groups) == set(sources)
    jax_labels = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(params["params"]):
        name = "/".join(p.key for p in path)
        jax_labels[name] = joptim.classify_param(tuple(p.key for p in path))
    seen = set()
    for key, paths in sources.items():
        for p in paths:
            # the bridge unstacks the scan-stacked encoder into layers
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert groups[key] == jax_labels[p_jax], (key, p_jax)
            seen.add(p_jax)
    assert seen == set(jax_labels)
    assert {g for g in groups.values()} >= {"backbone", "lang", "vl", "linear_proj", "base"}
    assert groups["detr.detr.transformer.decoder.layers.0.cross_attn.attention_weights.weight"] == "base"


def test_optimizer_matches_optax_for_three_steps():
    """The same gradients into optax's `build_optimizer` chain and the
    port's AdamW for 3 steps: parameters and both Adam moments agree. The
    gradients are scaled so that the clip acts on steps 1 and 3 only."""
    rng = np.random.RandomState(0)
    named = {"backbone/block_0/attn/qkv/kernel": (4, 6), "bert/layer_0/query/bias": (5,),
             "transformer/vl_layer_0/gamma_v": (3,),
             "transformer/decoder_layer_0/cross_attn/sampling_offsets/kernel": (2, 4),
             "transformer/decoder_layer_0/cross_attn/attention_weights/bias": (7,)}
    jparams = {k: rng.randn(*s).astype(np.float32) for k, s in named.items()}
    scfg = SolverConfig(warmup_iters=2, warmup_factor=0.25, steps=(2,), gamma=0.5)
    jscfg = JSolverConfig(warmup_iters=2, warmup_factor=0.25, steps=(2,), gamma=0.5)

    # a flat dict keyed by path: the port's AdamW takes the same names, with
    # the group from `classify_param` of each path
    tparams = {k: torch.nn.Parameter(_t(v.copy())) for k, v in jparams.items()}
    opt = optim.AdamW(tparams.items(), scfg, path_of=lambda name: name)

    tree = {k: jnp.asarray(v) for k, v in jparams.items()}
    tx = joptim.build_optimizer(jscfg, tree)
    state = tx.init(tree)
    for step, scale in enumerate((1.0, 1e-3, 1.0)):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in named.items()}
        updates, state = jax.jit(tx.update)(grads, state, tree)
        tree = optax.apply_updates(tree, updates)
        for k, p in tparams.items():
            p.grad = _t(grads[k].copy())
        norm = opt.step()
        want_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        for k in named:
            # fp32 Adam arithmetic in the same order; sqrt and division: a few ulp
            np.testing.assert_allclose(_np(tparams[k]), np.asarray(tree[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {step} {k}")
    # chain(clip, multi_transform): per group chain(adam, decay, schedule)
    adam_states = {g: st.inner_state[0] for g, st in state[1].inner_states.items()
                   if not isinstance(st.inner_state, optax.EmptyState)}
    for g, names in opt.names.items():
        for i, k in enumerate(names):
            np.testing.assert_allclose(_np(opt.mu[g][i]), np.asarray(adam_states[g].mu[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(_np(opt.nu[g][i]), np.asarray(adam_states[g].nu[k]),
                                       rtol=1e-6, atol=1e-12, err_msg=k)


# ---- the whole step ----------------------------------------------------------

DN_KEY = jax.random.PRNGKey(123)


def test_train_step_matches_jax(pair, monkeypatch):
    """One step of the small ViT config: every loss key and every gradient
    leaf against `jax.value_and_grad`. The port's gradients, as a state dict,
    go into the JAX tree through `convert_checkpoint`."""
    cfg, jm, params, model, inputs, targets = pair
    total, jlosses, jgrads = jax_loss_and_grads(jm, params, inputs, targets, jm.cfg,
                                                monkeypatch, DN_KEY)
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(targets[0]), "valid": _t(targets[1]),
                         "positive_map": _t(targets[2])}}
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg),
                                       dn_noise=dn_noise(DN_KEY, 2, single_pad))
    assert set(losses) == set(jlosses)
    for k in losses:
        # fp32 through backbone, BERT, 2 + 2 transformer layers, matching
        # and losses: the forward agrees to ~1e-6 relative
        np.testing.assert_allclose(_np(losses[k]), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(got_total), np.asarray(total), rtol=2e-5)

    grad_sd = {k: p.grad if p.grad is not None else torch.zeros_like(p)
               for k, p in model.named_parameters()}
    zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
    got, report = convert_checkpoint(grad_sd, copy.deepcopy(zeros))
    assert report["missing_target"] == [] and report["unused_source"] == []
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        g = np.asarray(got_leaves[path])
        want = np.asarray(want)
        if name.endswith("['up_res3']['bias']"):
            # one ConvTranspose2d bias for the four sub-pixels: the port's
            # gradient is their sum, copied to each
            want = np.tile(want.reshape(4, -1).sum(0), 4)
        # gradients through the same fp32 graph in another summation order:
        # 2e-4 of the leaf's largest entry, at least 2e-6 (leaves whose exact
        # gradient is 0, like the key bias of a softmax attention, hold only
        # rounding noise of the O(1e-2) terms that cancel there)
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-4 * scale, err_msg=name)
