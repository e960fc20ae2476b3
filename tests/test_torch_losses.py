"""The port's training losses and optimizer options against the JAX package
on the CPU, fp32: the CondInst mask losses (focal and dice on the matched
queries' dynamic masks) and the grounding losses, each in one whole train
step of the small ViT config of `tests/torch_port_common.py`
(`tiny_test_config` with a 2-block ViT; the losses are the backbone's
heads', and an R50 step costs three times as much to compile in JAX), and
AdamW with gradient accumulation (`optax.MultiSteps`) and with a bf16 first
moment (optax's `mu_dtype`).

The JAX side is `jax.value_and_grad` of `model.apply(..., train=True)`
with its DN key pinned (`torch_port_common.jax_loss_and_grads`), never
`make_train_step` or `Trainer`.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (detection_inputs, detection_targets, dn_noise,
                                     jax_loss_and_grads, jax_train_init,
                                     one_torch_thread, perturb, tiny_vit_config)
from uninext_tpu.config import LossConfig as JLossConfig
from uninext_tpu.config import SolverConfig as JSolverConfig
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.models import criterion as jcrit
from uninext_tpu_torch.config import LossConfig, SolverConfig
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import criterion as crit
from uninext_tpu_torch.models import detr
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DN_KEY = jax.random.PRNGKey(77)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().numpy()


def _mask_targets(valid, H=64, W=96, seed=5):
    """(B, G, H/4, W/4) random {0, 1} masks, zero on padded gts."""
    rng = np.random.RandomState(seed)
    m = (rng.rand(*valid.shape, H // 4, W // 4) > 0.6).astype(np.float32)
    return m * valid[..., None, None]


# ---- the pieces -----------------------------------------------------------------

def test_select_matched_matches_jax():
    rng = np.random.RandomState(0)
    q2g = np.where(rng.rand(2, 30) > 0.7, rng.randint(0, 6, (2, 30)), -1).astype(np.int32)
    q2g[1] = -1
    q2g[1, 29] = 2
    for n in (5, 20, 40):
        got = detr.select_matched(_t(q2g), n)
        want = jax.jit(jdetr.select_matched, static_argnums=1)(q2g, n)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_loss_masks_matches_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 7, 12, 16) * 3).astype(np.float32)
    tgt = (rng.rand(2, 7, 12, 16) > 0.5).astype(np.float32)
    valid = rng.rand(2, 7) > 0.3
    nb = np.float32(5.0)
    got = crit.loss_masks(_t(logits), _t(tgt), _t(valid), torch.tensor(nb), LossConfig())
    want = jax.jit(lambda *a: jcrit.loss_masks(*a, JLossConfig()))(logits, tgt, valid, nb)
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in got:
        # 192 pixels' focal terms and dice sums in fp32: summation order only
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(crit.dice_loss_elem(_t(logits), _t(tgt))),
                               np.asarray(jcrit.dice_loss_elem(logits, tgt)), rtol=1e-5)


# ---- whole steps ------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The small ViT config's JAX model and perturbed tree, the port's model
    loaded from it, and a batch with targets padded to max_insts."""
    cfg = tiny_vit_config()
    inputs = detection_inputs(3)
    targets = detection_targets(4, G=cfg.data.max_insts)
    jm = jdetr.UninextDETR(cfg)
    params = perturb(jax_train_init(jm, inputs, targets))
    model = build_model(cfg, "cpu", seed=0).train()
    convert.load_jax_params(model, params)
    return cfg, jm, params, model, inputs, targets


def _batch(inputs, targets, masks=None):
    tgt = {"boxes": _t(targets[0]), "valid": _t(targets[1]),
           "positive_map": _t(targets[2]), "has_masks": masks is not None}
    if masks is not None:
        tgt["masks"] = _t(masks)
    return {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
            "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
            "text_mask": _t(inputs[4]), "targets": tgt}


def _check_step(pair, monkeypatch, task, masks):
    """Every loss against JAX's, every gradient leaf against
    `jax.value_and_grad`'s. Returns the port's losses and its gradients by
    JAX leaf path."""
    cfg, jm, params, model, inputs, targets = pair
    total, jlosses, jgrads = jax_loss_and_grads(jm, params, inputs, targets, jm.cfg,
                                                monkeypatch, DN_KEY, task=task,
                                                masks=masks)
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    got_total, losses = loss_and_grads(model, _batch(inputs, targets, masks),
                                       loss_weights(cfg), task=task,
                                       dn_noise=dn_noise(DN_KEY, 2, single_pad))
    assert set(losses) == set(jlosses)
    for k in losses:
        # fp32 through the whole model, matching and losses: the forward
        # agrees to ~1e-6 relative (as tests/test_torch_train.py)
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
        g, want = np.asarray(got_leaves[path]), np.asarray(want)
        if name.endswith("['up_res3']['bias']"):
            want = np.tile(want.reshape(4, -1).sum(0), 4)   # one bias, four sub-pixels
        # 2e-4 of the leaf's largest gradient, at least 2e-6, as the detection
        # step's test
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-4 * scale, err_msg=name)
    return losses, got_leaves


def test_mask_losses_step_matches_jax(pair, monkeypatch):
    """Detection with gt masks: `loss_mask` and `loss_dice` of every layer
    join the loss dict, and the controller and the mask head get their
    gradients (from these losses only)."""
    cfg, _, _, _, _, targets = pair
    losses, grads = _check_step(pair, monkeypatch, "detection", _mask_targets(targets[1]))
    t = cfg.transformer
    want = {f"loss_{k}{s}" for k in ("mask", "dice")
            for s in [""] + [f"_{l}" for l in range(t.dec_layers - 1)]}
    assert want <= set(losses)
    for head in ("controller", "mask_head"):
        leaves = [v for p, v in grads.items() if jax.tree_util.keystr(p).startswith(
            f"['{head}']")]
        assert leaves and all(np.abs(v).max() > 0 for v in leaves), head


def test_mask_targets_off_keep_the_detection_losses(pair):
    """Without masks (has_masks False) no mask loss is formed."""
    cfg, _, _, model, inputs, targets = pair
    _, losses = loss_and_grads(model, _batch(inputs, targets), loss_weights(cfg),
                               dn_noise=dn_noise(DN_KEY, 2, 20))
    assert not any(k.startswith(("loss_mask", "loss_dice")) for k in losses)
    assert model.detr.controller.layers[0].weight.grad is None


def test_grounding_step_matches_jax(pair, monkeypatch):
    """Grounding: each query aligned with the pooled expression (one logit),
    a positive map of ones for every valid gt."""
    _check_step(pair, monkeypatch, "grounding", None)


def test_boxinst_is_refused(pair):
    """BoxInst's losses (`tests/test_torch_boxinst.py`) are refused on a
    batch without BoxInst's targets (gt masks only)."""
    cfg, _, _, model, inputs, targets = pair
    model.cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, boxinst=True))
    try:
        with pytest.raises(ValueError, match="BoxInst"):
            loss_and_grads(model, _batch(inputs, targets, _mask_targets(targets[1])),
                           loss_weights(cfg))
    finally:
        model.cfg = cfg


# ---- optimizer options -------------------------------------------------------------

NAMED = {"backbone/block_0/attn/qkv/kernel": (4, 6), "bert/layer_0/query/bias": (5,),
         "transformer/vl_layer_0/gamma_v": (3,),
         "transformer/decoder_layer_0/cross_attn/sampling_offsets/kernel": (2, 4),
         "transformer/decoder_layer_0/cross_attn/attention_weights/bias": (7,)}


def _run_both(overrides, grad_scales):
    """The same gradients, one set per micro-step, into optax's
    `build_optimizer` chain and the port's AdamW with `overrides`. Yields
    after each micro-step (port params, optax params, port opt, optax state)."""
    rng = np.random.RandomState(0)
    jparams = {k: rng.randn(*s).astype(np.float32) for k, s in NAMED.items()}
    common = {**dict(warmup_iters=2, warmup_factor=0.25, steps=(2,), gamma=0.5),
              **overrides}
    tparams = {k: torch.nn.Parameter(_t(v.copy())) for k, v in jparams.items()}
    opt = optim.AdamW(tparams.items(), SolverConfig(**common), path_of=lambda name: name)
    tree = {k: jnp.asarray(v) for k, v in jparams.items()}
    tx = joptim.build_optimizer(JSolverConfig(**common), tree)
    state = tx.init(tree)
    update = jax.jit(tx.update)
    for scale in grad_scales:
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in NAMED.items()}
        updates, state = update(grads, state, tree)
        tree = optax.apply_updates(tree, updates)
        for k, p in tparams.items():
            g = _t(grads[k].copy())
            # micro-steps of one update add to .grad, as autograd does
            p.grad = g if not opt.accumulating or p.grad is None else p.grad + g
        norm = opt.step()
        yield tparams, tree, opt, state, norm


def _adam_states(state):
    """The per-group scale_by_adam states of the chain (inside MultiSteps
    when accumulating)."""
    inner = state.inner_opt_state if isinstance(state, optax.MultiStepsState) else state
    return {g: st.inner_state[0] for g, st in inner[1].inner_states.items()
            if not isinstance(st.inner_state, optax.EmptyState)}


def test_grad_accumulation_matches_optax_multisteps():
    """k = 2 over two updates (4 micro-steps): the parameters move only on
    the 2nd and 4th, by the clipped AdamW update of the mean gradient, with
    the schedule and Adam's count in updates. The gradients are scaled so
    that the clip acts on the first update only."""
    before = None
    for i, (tparams, tree, opt, state, norm) in enumerate(
            _run_both({"grad_accum_steps": 2}, (1.0, 1.0, 1e-3, 1e-3))):
        emitted = i % 2 == 1
        assert (norm is not None) == emitted
        assert opt.count == (i + 1) // 2 and opt.accumulating == (not emitted)
        if not emitted:
            if before is not None:
                for k, p in tparams.items():
                    assert torch.equal(p.detach(), before[k]), k
            continue
        for k in NAMED:
            # the mean as a sum / k against optax's running mean: a few ulp
            np.testing.assert_allclose(_np(tparams[k]), np.asarray(tree[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"micro-step {i} {k}")
        adam = _adam_states(state)
        for g, names in opt.names.items():
            for j, k in enumerate(names):
                np.testing.assert_allclose(_np(opt.mu[g][j]), np.asarray(adam[g].mu[k]),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
                np.testing.assert_allclose(_np(opt.nu[g][j]), np.asarray(adam[g].nu[k]),
                                           rtol=1e-6, atol=1e-12, err_msg=k)
        before = {k: p.detach().clone() for k, p in tparams.items()}
    assert int(state.gradient_step) == 2


@pytest.mark.parametrize("warmup_factor", [None, 1e-3], ids=["as-set", "ramp-1e-3"])
def test_fixture_run_schedule_matches_optax_over_1500_updates(warmup_factor):
    """The flagship fixture run's solver (`tools/ap_check.py:build_cfg`: the
    group learning rates, 50 warm-up updates, the 10x decay at update 1200,
    the clip, weight decay) over all 1500 updates, the same gradients into
    both: the parameters agree after every update, so the schedule, clip
    and Adam's bias correction act at the same updates. Every config's
    warm-up factor is 1.0 (a flat warm-up); the second case ramps from 1e-3
    (detectron2's default) so that the warm-up's 50 updates differ."""
    from uninext_tpu_torch.tools.ap_check import build_cfg
    solver = dataclasses.asdict(build_cfg(1500).solver)
    assert solver["warmup_iters"] == 50 and solver["steps"] == (1200,)
    if warmup_factor is not None:
        solver["warmup_factor"] = warmup_factor
    scales = [1.0] * 1000 + [1e-3] * 500        # the clip acts, then not
    largest = 0.0
    for i, (tparams, tree, opt, _, _) in enumerate(_run_both(solver, scales)):
        for k in NAMED:
            got, want = _np(tparams[k]), np.asarray(tree[k])
            # 1500 fp32 AdamW updates of the same values, rounded alike
            # but for the order of a few sums: within 1e-6 of the leaf's
            # largest entry (6e-8 seen)
            err = np.abs(got - want).max() / np.abs(want).max()
            largest = max(largest, err)
            assert err < 1e-6, f"update {i} {k}: {err}"
    assert opt.count == 1500
    print(f"largest difference over 1500 updates: {largest:.3g} of the leaf")


def test_bf16_first_moment_matches_optax_mu_dtype():
    """adam_mu_dtype "bfloat16" over two updates: the stored first moment is
    bf16 and equals optax's bit for bit where both round the same fp32
    value; the parameters agree as in fp32."""
    for tparams, tree, opt, state, _ in _run_both({"adam_mu_dtype": "bfloat16"}, (1.0, 1.0)):
        for k in NAMED:
            np.testing.assert_allclose(_np(tparams[k]), np.asarray(tree[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        adam = _adam_states(state)
        for g, names in opt.names.items():
            for j, k in enumerate(names):
                mu, want = opt.mu[g][j], adam[g].mu[k]
                assert mu.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
                # the same fp32 moment rounded once to bf16: equal, or one
                # bf16 step apart where the fp32 values differ in the last ulp
                np.testing.assert_allclose(mu.float().numpy(),
                                           np.asarray(want, np.float32), rtol=2 ** -7,
                                           err_msg=k)
    assert opt.count == 2
