"""The port's training run against the JAX package's over many updates on
the CPU, fp32: both packages' mini-COCO loaders (seed 0, LSJ, masks, bs=2)
feed both packages' train steps from the same weights for 24 updates, with
the fixture run's schedule in small (a 10x decay at 80% of the steps; the
warm-up factor is 1.0, as in every config) and its clip. At every step the loaders' batches must be
bit-equal (six passes over the 8 training images) and the two schedules
give the same learning rate.

The losses of two such runs cannot stay equal to the end: at a near-tie
the matchers' assignments flip on rounding, and Adam turns the rounding
noise of gradients that are zero in exact arithmetic (key biases) into
steps of the full learning rate. On this test's data the runs agree to
~1e-5 for three steps and the fourth step's matching flips. A second port
run shows what that costs: it starts from JAX's weights moved by 1e-6
relative, and lands as far from JAX as the first. Both port runs are held
to the one JAX run: the first three losses to 2e-5 and the mean loss of
each window of 8 steps to 3%.

This is the witness that the port's fixture run is JAX's run on the same
data and schedule: one step's losses and gradients, two optimizer updates
and the evaluator on fixed weights are held in `test_torch_losses.py` and
`test_torch_engine.py`; here the steps follow one another.

The small ViT config of `tests/torch_port_common.py` on a 64 x 64 LSJ
canvas. The JAX side is `jax.value_and_grad` of `model.apply(...,
train=True)` with its DN key pinned and optax's `build_optimizer` chain,
never `make_train_step` or `Trainer`; the port's DN noise is drawn from the
same key.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (detection_inputs, detection_targets, dn_noise,
                                     jax_train_init, one_torch_thread, perturb,
                                     tiny_vit_config)
from uninext_tpu.config import DataConfig as JDataConfig
from uninext_tpu.config import SolverConfig as JSolverConfig
from uninext_tpu.data import coco as jcoco
from uninext_tpu.data import loader as jloader
from uninext_tpu.data.tokenizer import BertTokenizer as JTokenizer
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.train import loss_weights as jloss_weights
from uninext_tpu.engine.train import weighted_total as jweighted_total
from uninext_tpu_torch.data.coco import UniDatasetMapper, load_coco_json
from uninext_tpu_torch.data.loader import MultiDatasetLoader
from uninext_tpu_torch.data.mini_coco import make_mini_coco
from uninext_tpu_torch.data.tokenizer import BertTokenizer
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine.train import build_train_state, loss_and_grads, loss_weights
from uninext_tpu_torch.engine.trainer import to_device
from uninext_tpu_torch.models import detr

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STEPS = 24
EXACT_STEPS = 3     # steps before the first flip of the matching
WINDOW = 8
DN_KEY = jax.random.PRNGKey(91)
LSJ = dict(lsj=True, lsj_size=64, lsj_min_scale=0.6, lsj_max_scale=1.4)


def _cfg():
    """The small ViT config with the tiny fixture run's solver
    (`tools/ap_check.py:build_cfg(flagship=False)`: one lr, clip 1.0) and the
    flagship's proportions of warm-up and decay over STEPS updates. The
    decay acts on the last 5 updates, where the runs already differ by
    their chaos: `test_torch_losses.py` holds the schedule over 1500
    updates."""
    cfg = tiny_vit_config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, max_insts=8, max_text_len=32),
        solver=dataclasses.replace(cfg.solver, base_lr=3e-4, lang_lr=3e-4, vl_lr=3e-4,
                                   backbone_multiplier=1.0, warmup_iters=4,
                                   grad_clip=1.0, max_iter=STEPS,
                                   steps=(int(STEPS * 0.8),)))


def _loaders(root, cfg):
    """Both packages' seeded loaders over one mini-COCO of 8 images."""
    paths = make_mini_coco(str(root), n_train=8, n_val=1)
    recs, cats = load_coco_json(paths["train_json"], paths["train_root"])
    jrecs, jcats = jcoco.load_coco_json(paths["train_json"], paths["train_root"])
    m = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=True, with_masks=True,
                         **LSJ)
    jm = jcoco.UniDatasetMapper(JDataConfig(**dataclasses.asdict(cfg.data)), jcats,
                                JTokenizer(), is_train=True, with_masks=True, **LSJ)
    return (iter(MultiDatasetLoader([(recs, m, 2)], [1.0], seed=0, num_workers=2)),
            iter(jloader.MultiDatasetLoader([(jrecs, jm, 2)], [1.0], seed=0,
                                            num_workers=2)))


def _jax_grad_fn(jm, cfg, monkeypatch):
    """jit of value_and_grad of the weighted total, the DN key pinned."""
    real = jdetr.prepare_dn_static

    def pinned(gt_boxes, gt_valid, label_enc, rng, box_noise_scale, **kw):
        return real(gt_boxes, gt_valid, label_enc, DN_KEY, box_noise_scale, **kw)

    monkeypatch.setattr(jdetr, "prepare_dn_static", pinned)
    weights = jloss_weights(cfg)

    def loss_fn(p, batch):
        tgt = dict(batch["targets"], has_masks=True)
        losses = jm.apply({"params": p}, batch["images"], batch["img_mask"],
                          batch["image_sizes"], batch["text_ids"], batch["text_mask"],
                          task="detection", targets=tgt, train=True,
                          rngs={"dn": jax.random.PRNGKey(0)})
        return jweighted_total(losses, weights), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _moved(params, rel):
    """Every leaf times (1 + rel * N(0, 1)), seeded; `up_res3/bias` (four
    copies that must stay equal) as it is."""
    rng = np.random.RandomState(123)

    def one(path, x):
        if "up_res3" in jax.tree_util.keystr(path):
            return x
        return (x * (1 + rel * rng.randn(*x.shape))).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(one, params)


def test_training_run_matches_jax(tmp_path, monkeypatch):
    cfg = _cfg()
    jm = jdetr.UninextDETR(cfg)
    params = perturb(jax_train_init(jm, detection_inputs(3, H=64, W=64),
                                    detection_targets(4, G=cfg.data.max_insts)))
    runs = {}
    for name, tree in (("same weights", params), ("moved by 1e-6", _moved(params, 1e-6))):
        runs[name] = build_train_state(cfg, "cpu", seed=0)
        convert.load_jax_params(runs[name].model, tree)
    weights = loss_weights(cfg)
    noise = dn_noise(DN_KEY, 2, min(detr.DN_SINGLE_PAD, cfg.data.max_insts))

    grad_fn = _jax_grad_fn(jm, cfg, monkeypatch)
    jsolver = JSolverConfig(**dataclasses.asdict(cfg.solver))
    tree = jax.tree.map(jnp.asarray, params["params"])
    tx = joptim.build_optimizer(jsolver, tree)
    jstate, update = tx.init(tree), jax.jit(tx.update)
    jsched = joptim.lr_schedule(jsolver)

    it, jit_ = _loaders(tmp_path, cfg)
    want, got = [], {name: [] for name in runs}
    try:
        for step in range(STEPS):
            b, jb = next(it), next(jit_)
            for k in ("images", "img_mask", "image_sizes", "text_ids", "text_mask"):
                assert np.array_equal(b[k], jb[k]), (step, k)
            assert set(b["targets"]) == set(jb["targets"])
            for k, v in jb["targets"].items():
                assert np.array_equal(b["targets"][k], v), (step, k)
            # one update on each side
            (jtotal, _), grads = grad_fn(tree, jb)
            updates, jstate = update(grads, jstate, tree)
            tree = optax.apply_updates(tree, updates)
            want.append(float(jtotal))
            batch = to_device(b, torch.device("cpu"), True)
            for name, state in runs.items():
                opt = state.optimizer
                assert opt.schedule(opt.count) == pytest.approx(float(jsched(step)), rel=1e-6)
                total, _ = loss_and_grads(state.model, batch, weights, dn_noise=noise)
                opt.step()
                got[name].append(total.item())
    finally:
        it.close()
        jit_.close()
    assert float(jsched(STEPS - 1)) == pytest.approx(0.1)
    want = np.array(want)
    for name, losses in got.items():
        assert runs[name].optimizer.count == STEPS
        losses = np.array(losses)
        print(f"{name}: total loss per step, port / JAX: "
              + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in zip(losses, want)))
        # the whole model, matching and losses in fp32 with one forward
        # agreeing to ~1e-6 relative, after at most two updates
        np.testing.assert_allclose(losses[:EXACT_STEPS], want[:EXACT_STEPS], rtol=2e-5,
                                   err_msg=name)
        means = losses.reshape(-1, WINDOW).mean(1), want.reshape(-1, WINDOW).mean(1)
        print(f"{name}: mean loss of each 8 steps, port / JAX - 1: "
              + ", ".join(f"{x:+.5f}" for x in means[0] / means[1] - 1))
        np.testing.assert_allclose(*means, rtol=3e-2,
                                   err_msg=f"{name}: mean loss of each 8 steps")
