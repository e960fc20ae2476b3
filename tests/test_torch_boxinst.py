"""BoxInst in the port against the JAX package on the CPU: the host-side
targets (`data/boxinst.py`: LAB conversion, the dilated neighbours, the
colour similarity with and without the bottom band, the box bitmasks) and
the BoxInst mapper bit-equal, `collate` carrying the two keys;
`loss_masks_boxinst` and its gradient against `jax.value_and_grad` in fp32
over valid patterns and warm-up factors; one whole BoxInst train step of
`tiny_test_config` with the small ViT of `tests/test_torch_losses.py`
against `jax.value_and_grad(model.apply)` past the warm-up, every loss and
every gradient at that file's tolerances (the R50 config's BoxInst step is
`tests/test_torch_r50.py::test_r50_boxinst_train_step_matches_jax`: at
these inputs one of R50's fp32 pre-activations sits on a ReLU's tie,
ROADMAP §3.24). Images with flat colour
patches make most neighbours pass the 0.3 similarity threshold, so the
pairwise term is checked on many pixels.
"""
import copy
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import (boxinst_targets, detection_inputs, detection_targets,
                                     dn_noise, jax_loss_and_grads, jax_train_init,
                                     one_torch_thread, patch_image, perturb, tiny_vit_config)
from uninext_tpu.config import DataConfig as JDataConfig
from uninext_tpu.data import boxinst as jbox
from uninext_tpu.data import coco as jcoco
from uninext_tpu.data import loader as jloader
from uninext_tpu.data.tokenizer import BertTokenizer as JTokenizer
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.models import criterion as jcrit
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu_torch.config import DataConfig
from uninext_tpu_torch.data import boxinst, coco, loader, mini_coco
from uninext_tpu_torch.data.tokenizer import BertTokenizer
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.engine.trainer import to_device
from uninext_tpu_torch.models import criterion as crit
from uninext_tpu_torch.models import detr
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DN_KEY = jax.random.PRNGKey(91)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _valid_mask(H, W, h, w, h0, bottom):
    """The mapper's usable-pixel mask: the image area minus the bottom rows,
    `bottom` scaled by the resized over the original height."""
    vm = np.zeros((H, W), np.float32)
    vm[:h, :w] = 1.0
    pr = int(bottom * float(h) / float(h0))
    if pr > 0:
        vm[h - pr:h] = 0.0
    return vm


# ---- the host-side targets --------------------------------------------------------

@pytest.mark.parametrize("bottom", [0, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxinst_data_functions_are_bit_equal(seed, bottom):
    rng = np.random.RandomState(seed)
    H, W = 64 + 32 * seed, 96
    h, w = H - 8 * (seed + 1), W - 16
    img = patch_image(rng, H, W)
    vm = _valid_mask(H, W, h, w, h0=2 * h, bottom=bottom)
    assert np.array_equal(boxinst.rgb_to_lab(img), jbox.rgb_to_lab(img))
    x = rng.randn(3, 12, 16).astype(np.float32)
    for k, d in ((3, 2), (3, 1)):
        assert np.array_equal(boxinst._unfold_wo_center_np(x, k, d),
                              jbox._unfold_wo_center_np(x, k, d))
    lab = boxinst.downsample_to_lab(img)
    assert np.array_equal(lab, jbox.downsample_to_lab(img))
    valid_s = vm[2::4, 2::4]
    assert np.array_equal(boxinst.color_similarity_from_lab(lab, valid_s),
                          jbox.color_similarity_from_lab(lab, valid_s))
    sim = boxinst.color_similarity(img, vm)
    assert sim.shape == (8, H // 4, W // 4) and np.array_equal(
        sim, jbox.color_similarity(img, vm))
    assert (sim >= 0.3).mean() > 0.3                     # the patches pass the threshold
    boxes = np.stack([rng.uniform(0, w / 2, 6), rng.uniform(0, h / 2, 6),
                      rng.uniform(w / 2, w, 6), rng.uniform(h / 2, h, 6)], -1)
    valid = rng.rand(6) > 0.3
    bits = boxinst.boxes_to_bitmasks(boxes, valid, H, W)
    assert np.array_equal(bits, jbox.boxes_to_bitmasks(boxes, valid, H, W))
    assert bits[valid].sum() > 0 and bits[~valid].sum() == 0


@pytest.fixture(scope="module")
def coco_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("boxinst_coco")
    paths = mini_coco.make_mini_coco(str(root), n_train=3, n_val=1)
    jr, jc = jcoco.load_coco_json(paths["train_json"], paths["train_root"])
    r, c = coco.load_coco_json(paths["train_json"], paths["train_root"])
    assert r == jr and c == jc
    return jr, r, c


DATA = dict(max_insts=8, max_text_len=32, min_size_train=(96,), max_size_train=160,
            min_size_test=96, max_size_test=160)
LSJ = dict(lsj=True, lsj_size=128, lsj_min_scale=0.6, lsj_max_scale=1.4)


@pytest.mark.parametrize("bottom", [0, 10])
def test_boxinst_mapper_and_collate_match_jax(coco_records, bottom):
    """The BoxInst mapper (LSJ, no gt masks) on mini-COCO records at three
    seeds: every field, the box bitmasks and the colour similarity
    bit-equal; `collate` stacks the two into the targets, and `to_device`
    marks the batch as one with mask targets."""
    jr, r, cats = coco_records
    kw = dict(is_train=True, with_masks=False, boxinst=True, boxinst_bottom_pixels=bottom,
              **LSJ)
    jm = jcoco.UniDatasetMapper(JDataConfig(**DATA), cats, JTokenizer(), **kw)
    m = coco.UniDatasetMapper(DataConfig(**DATA), cats, BertTokenizer(), **kw)
    samples, jsamples = [], []
    for rec_j, rec in zip(jr, r):
        for seed in range(3):
            a, b = m(rec, random.Random(seed)), jm(rec_j, random.Random(seed))
            for f in ("image", "img_mask", "image_size", "text_ids", "text_mask", "boxes",
                      "valid", "positive_map", "labels", "box_bitmasks", "color_similarity"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert a.masks is None and b.masks is None and a.bucket == b.bucket
            assert a.box_bitmasks.shape == (8, 32, 32) and a.color_similarity.shape == (8, 32, 32)
            samples.append(a)
            jsamples.append(b)
    batch, jbatch = loader.collate(samples[:2]), jloader.collate(jsamples[:2])
    assert set(batch["targets"]) == set(jbatch["targets"]) >= {"box_bitmasks",
                                                               "color_similarity"}
    for k, v in jbatch["targets"].items():
        assert np.array_equal(batch["targets"][k], v), k
    dev = to_device(batch, torch.device("cpu"), has_masks=True)
    assert dev["targets"]["has_masks"] and dev["targets"]["box_bitmasks"].shape == (2, 8, 32, 32)
    eval_mapper = coco.UniDatasetMapper(DataConfig(**DATA), cats, BertTokenizer(),
                                        is_train=False, with_masks=True, boxinst=True)
    assert eval_mapper(r[0], random.Random(0)).box_bitmasks is None   # training only


# ---- the losses -------------------------------------------------------------------

def _loss_inputs(seed, pattern):
    rng = np.random.RandomState(seed)
    B, N, H, W = 2, 6, 12, 16
    logits = (rng.randn(B, N, H, W) * 2.5).astype(np.float32)
    bits = np.zeros((B, N, H, W), np.float32)
    for b in range(B):
        for n in range(N):
            y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
            bits[b, n, y0:y0 + rng.randint(2, H // 2), x0:x0 + rng.randint(2, W // 2)] = 1
    img = patch_image(rng, H * 4, W * 4)
    vm = _valid_mask(H * 4, W * 4, H * 4 - 8, W * 4, H * 4, 10)
    sim = np.stack([jbox.color_similarity(img, vm) for _ in range(B)])
    sim[1] *= rng.rand(8, H, W).astype(np.float32)      # some neighbours below the threshold
    valid = {"all": np.ones((B, N), bool), "some": rng.rand(B, N) > 0.4,
             "none": np.zeros((B, N), bool)}[pattern]
    return logits, bits, sim, valid


def _jax_boxinst_value_and_grad(key):
    """JAX's loss `key` and its gradient with respect to the logits,
    compiled once for every pattern and warm-up factor."""
    return jax.jit(jax.value_and_grad(
        lambda lg, bits, sim, valid, wf: jcrit.loss_masks_boxinst(lg, bits, sim, valid,
                                                                  wf)[key]))


JAX_BOXINST = {key: _jax_boxinst_value_and_grad(key) for key in ("loss_prj", "loss_pairwise")}


@pytest.mark.parametrize("warmup", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("pattern", ["all", "some", "none"])
def test_loss_masks_boxinst_and_its_gradient_match_jax(pattern, warmup):
    """Both losses, and the gradient of each with respect to the mask
    logits, against `jax.value_and_grad` of JAX's function, in fp32 within
    1e-5 (of the value; of the gradient's largest element)."""
    logits, bits, sim, valid = _loss_inputs(3, pattern)
    wf = np.float32(warmup)
    x = _t(logits).requires_grad_(True)
    got = crit.loss_masks_boxinst(x, _t(bits), _t(sim), _t(valid), torch.tensor(wf))
    for key in ("loss_prj", "loss_pairwise"):
        want, jgrad = JAX_BOXINST[key](logits, bits, sim, valid, wf)
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
        (g,) = torch.autograd.grad(got[key], x, retain_graph=True)
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(g.numpy(), jgrad, rtol=0,
                                   atol=1e-5 * max(float(np.abs(jgrad).max()), 1e-6),
                                   err_msg=key)
    if pattern != "none" and warmup:
        assert float(got["loss_pairwise"].detach()) > 0 and float(got["loss_prj"].detach()) > 0


def test_unfold_wo_center_matches_jax():
    """The neighbours the pairwise term walks (`criterion._neighbours`), in
    their order, against JAX's `unfold_wo_center`."""
    x = np.random.RandomState(4).randn(2, 3, 9, 11).astype(np.float32)
    np.testing.assert_array_equal(torch.stack(list(crit._neighbours(_t(x))), -3).numpy(),
                                  np.asarray(jcrit.unfold_wo_center(x)))


# ---- one whole step ---------------------------------------------------------------

def test_boxinst_train_step_matches_jax(monkeypatch):
    """`tiny_vit_config` (`tiny_test_config` with a 2-block ViT, the mask
    head) with `loss.boxinst`, past the pairwise term's warm-up: every loss
    (`loss_prj` and `loss_pairwise` of every decoder layer in place of the
    mask and dice losses) and every gradient against `jax.value_and_grad`
    of `model.apply`, at `tests/test_torch_losses.py`'s tolerances."""
    base = tiny_vit_config()
    cfg = dataclasses.replace(base, loss=dataclasses.replace(
        base.loss, boxinst=True, boxinst_warmup_iters=4))
    inputs = detection_inputs(6)
    targets = detection_targets(7, G=cfg.data.max_insts)
    jm = JaxDETR(cfg)
    # initialised through the gt-mask path (the same tree: BoxInst adds no
    # parameter)
    params = perturb(jax_train_init(JaxDETR(base), inputs, targets))
    model = build_model(cfg, "cpu", seed=0).train()
    convert.load_jax_params(model, params)
    extra = boxinst_targets(8, inputs, targets, step=6)
    B, sim = inputs[0].shape[0], extra["color_similarity"]
    boxes, valid = targets[0], targets[1]
    total, jlosses, jgrads = jax_loss_and_grads(jm, params, inputs, targets, cfg,
                                                monkeypatch, DN_KEY, boxinst=extra)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(boxes), "valid": _t(valid),
                         "positive_map": _t(targets[2]), "has_masks": True,
                         "box_bitmasks": _t(extra["box_bitmasks"]), "color_similarity": _t(sim),
                         "step": 6}}
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg),
                                       dn_noise=dn_noise(DN_KEY, B, single_pad))
    assert set(losses) == set(jlosses)
    assert {f"loss_{k}{s}" for k in ("prj", "pairwise")
            for s in [""] + [f"_{i}" for i in range(cfg.transformer.dec_layers - 1)]} \
        <= set(losses)
    assert not any(k.startswith(("loss_mask", "loss_dice")) for k in losses)
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    assert float(losses["loss_pairwise"].detach()) > 0 and float(losses["loss_prj"].detach()) > 0
    np.testing.assert_allclose(got_total.detach().numpy(), np.asarray(total), rtol=2e-5)
    grad_sd = {k: p.grad if p.grad is not None else torch.zeros_like(p)
               for k, p in model.named_parameters()}
    zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
    got, report = convert_checkpoint(grad_sd, copy.deepcopy(zeros))
    assert report["missing_target"] == [] and report["unused_source"] == []
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        g, want = np.asarray(got_leaves[path]), np.asarray(want)
        if jax.tree_util.keystr(path).endswith("['up_res3']['bias']"):
            want = np.tile(want.reshape(4, -1).sum(0), 4)   # one bias, four sub-pixels
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    mask_head = [v for p, v in got_leaves.items()
                 if jax.tree_util.keystr(p).startswith("['mask_head']")]
    assert mask_head and all(np.abs(v).max() > 0 for v in mask_head)
