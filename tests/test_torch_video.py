"""The video family of the port against the JAX package on the CPU, fp32:
the reid embeddings of the forward (`compute_reid` through the deformable
reid head), the VIS frame step's valid slots, the two-frame training
losses and every gradient (`forward_video_train` against
`jax.value_and_grad`; the grounding task's losses), AdamW's step on the
frozen BERT, `loss_reid_static`
on each kind of row, the weight bridge of the reid leaves and of a tree
with the template branch, and the optimizer groups.

Config: `tiny_video_test_config()` (R50 at full width, 2 + 2 transformer
layers of width 64, 60 queries, the reid head) with what `video_joint_r50`
adds to the reid path: the deformable reid head (2 layers), `detach_reid`
and a frozen language model. Inputs at 64x96, bs=2. The JAX tree is
initialised through `forward_video_train` with mask targets (so it holds
the mask head and the reid head, and no DN label encoder, as a video
training run's) and perturbed by 0.02 (the R50 trunk's scale,
tests/test_torch_r50.py). The video step makes no DN queries, so no DN
noise is drawn on either side.
"""
import copy
import dataclasses
import re

import jax
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_common import (bridge_sources, class_token_map, detection_inputs,
                                     detection_targets, one_torch_thread, perturb,
                                     shared_across_workers)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.engine.train import loss_weights as jax_loss_weights
from uninext_tpu.engine.train import weighted_total as jax_weighted_total
from uninext_tpu.engine.video_inference import make_vis_frame_step as jax_frame_step
from uninext_tpu.models import criterion as jcrit
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import init_all_paths
from uninext_tpu_torch.config import tiny_video_test_config
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.engine.video_inference import make_vis_frame_step
from uninext_tpu_torch.models import criterion as crit
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REID = "detr.reid_embed_head."


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def video_config():
    cfg = tiny_video_test_config()
    return dataclasses.replace(cfg, use_deformable_reid=True, detach_reid=True,
                               language=dataclasses.replace(cfg.language, freeze=True))


def _video_batch(G):
    """Key and ref frames of two videos (image 0 valid on 48x80 in both),
    slot-aligned targets with masks: in the ref frame the boxes move a
    little, object 0 of video 0 is gone and one object appears."""
    images, img_mask, sizes, ids, tmask = detection_inputs(0)
    images_ref = detection_inputs(1)[0] * (~img_mask[..., None])
    boxes, valid, pm = detection_targets(2, G=G)
    rng = np.random.RandomState(9)
    boxes_r = boxes.copy()
    boxes_r[..., :2] += rng.uniform(-0.03, 0.03, boxes[..., :2].shape).astype(np.float32)
    valid_r = valid.copy()
    valid_r[0, 0] = False
    n = valid[1].sum()
    valid_r[1, n] = True
    boxes_r[1, n] = [0.4, 0.6, 0.2, 0.25]
    pm_r = pm.copy()
    pm_r[1, n, 3] = True
    masks = (rng.rand(2, G, 16, 24) > 0.6).astype(np.float32)
    tk = {"boxes": boxes, "valid": valid, "positive_map": pm,
          "masks": masks * valid[..., None, None]}
    tr = {"boxes": boxes_r, "valid": valid_r, "positive_map": pm_r,
          "masks": masks * valid_r[..., None, None]}
    return (images, img_mask, sizes, ids, tmask), images_ref, tk, tr


def _jax_targets(t):
    return {**t, "has_masks": True}


def _port_targets(t):
    return {**{k: _t(v) for k, v in t.items()}, "has_masks": True}


@pytest.fixture(scope="module")
def pair(tmp_path_factory, worker_id):
    cfg = video_config()
    inputs, images_ref, tk, tr = _video_batch(cfg.data.max_insts)
    jm = JaxDETR(cfg)

    def init():
        params = jax.jit(lambda r: jm.init(
            {"params": r, "dn": jax.random.fold_in(r, 1)}, *inputs, _jax_targets(tk),
            _jax_targets(tr), images_ref, method=JaxDETR.forward_video_train))(
            jax.random.PRNGKey(0))
        params = perturb(jax.tree.map(np.asarray, params), scale=0.02)
        # the last layer's boxes e^2 times wider and taller, so that they
        # overlap and NMS suppresses (at 64x96 the proposals are a few pixels)
        params["params"]["bbox_embed_1"]["layer_2"]["bias"][2:] += 2.0
        return params

    # the init compiles the whole video training path: once per session
    params = shared_across_workers("video_pair_params", init, tmp_path_factory, worker_id)
    model = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return cfg, inputs, images_ref, tk, tr, jm, params, model


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def test_reid_tree_fills_the_port_and_round_trips(pair):
    """The video-detection tree holds `reid_dec_{0,1}`,
    `reid_ref_point_head` and `reid_embed` and no `dn_resizer`; the bridge
    consumes every leaf (`load_jax_params` raised otherwise), and the
    port's state_dict under the reference keys (`detr.reid_embed_head.0.*`,
    `.1.*`) goes back through `convert_checkpoint` to every leaf exactly."""
    *_, params, model = pair
    top = set(params["params"])
    assert {"reid_dec_0", "reid_dec_1", "reid_ref_point_head", "reid_embed",
            "controller", "mask_head"} <= top
    assert "dn_resizer" not in top and "adjust_layer" not in top
    sd = {k: v for k, v in model.state_dict().items() if not k.startswith("detr.resizer.")}
    assert REID + "0.layers.1.cross_attn.sampling_offsets.weight" in sd
    assert REID + "0.ref_point_head.layers.1.bias" in sd and REID + "1.layers.2.weight" in sd
    back, report = convert_checkpoint(sd, copy.deepcopy(jax.tree.map(np.zeros_like, params)))
    assert report["missing_target"] == [] and report["shape_mismatch"] == []
    assert report["unused_source"] == []
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_bridge_refuses_the_template_branch(pair):
    """A tree of `init_all_paths` (every branch, the SOT/VOS template
    branch included; its shapes, by `jax.eval_shape`) is refused by a model
    built without the template branch, with an error that names the
    template parameters it does not have, and loads whole into one built
    with it (`build_model(..., template=True)`)."""
    cfg, *_, jm, _, model = pair
    shapes = jax.eval_shape(lambda r: init_all_paths(jm, r, H=64, W=96),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert {"template_backbone", "sot_fuser", "adjust_layer"} <= set(tree["params"])
    with pytest.raises(RuntimeError) as err:
        convert.load_jax_params(build_model(cfg, "cpu", seed=1), tree)
    for name in ("detr.detr.ref_backbone.", "detr.sot_fuser.", "detr.adjust_layer."):
        assert name in str(err.value)
    convert.load_jax_params(build_model(cfg, "cpu", seed=1, template=True), tree)


def test_reid_embeds_match_jax(pair):
    """`pred_embeds` of the inference forward (the deformable reid decoder
    over the memory for all 60 queries, then the MLP) and the outputs it
    rides on."""
    _, inputs, *_, jm, params, model = pair
    want = jax.jit(lambda p: jm.apply(p, *inputs, task="detection"))(params)
    with torch.inference_mode():
        got = model(*map(_t, inputs))
    assert got["pred_embeds"].shape == (2, 60, 64)
    for key in ("pred_logits", "pred_boxes", "pred_embeds"):
        # fp32 through R50, BERT, 2 + 2 transformer layers, 2 reid layers
        _close(got[key].float().numpy(), want[key], 1e-4, key)


def test_vis_frame_step_matches_jax(pair):
    """One frame (image 0, padded) through the VIS frame step of both
    packages, NMS at 0.3 over a selection threshold at the lower quartile
    of the scores (so that `valid` is partly false and NMS suppresses some
    selected queries): the same valid slots
    in the same order (a stable top-k: the lower query first among equal
    scores) with their labels, and their boxes, scores, masks and
    embeddings within 1e-4 of each tensor's largest value."""
    cfg, inputs, *_, jm, params, model = pair
    cmap = class_token_map()
    image, pad, sizes, ids, tmask = (x[:1] for x in inputs)
    with torch.inference_mode():
        out = model(*map(_t, (image, pad, sizes, ids, tmask)))
        prob = (torch.einsum("bqt,ct->bqc", out["pred_logits"], _t(cmap).float())
                / _t(cmap).sum(-1)).sigmoid()
        prob = (prob * out["pred_boxious"].sigmoid()).sqrt().amax(-1)
    thr = float(prob.quantile(0.25))
    n_selected = int((prob > thr).sum())
    jstep = jax_frame_step(jm, cfg, cmap, 64, 96, select_thr=thr, nms_thr=0.3)
    want = {k: np.asarray(v) for k, v in
            jstep(params["params"], image, pad, sizes, ids, tmask).items()}
    step = make_vis_frame_step(model, _t(cmap), select_thr=thr, nms_thr=0.3)
    with torch.inference_mode():
        lang = model.encode_text(_t(ids).long(), _t(tmask))
        got = {k: v.numpy() for k, v in step(*map(_t, (image, pad, sizes)), lang).items()}
    v = want["valid"]
    assert 5 < v.sum() < n_selected, (v.sum(), n_selected)   # NMS suppressed some
    np.testing.assert_array_equal(got["valid"], v)
    for key in ("query_idx", "labels"):
        np.testing.assert_array_equal(got[key][v], want[key][v], key)
    for key in ("boxes", "boxes_cxcywh", "max_scores", "scores_full", "mask_logits",
                "embeds"):
        assert got[key].shape == want[key].shape, key
        _close(got[key][v], want[key][v], 1e-4, key)


def test_video_train_step_matches_jax(pair):
    """`forward_video_train` (detection): every loss (the key frame's
    detection and mask losses per layer, the encoder's, `loss_reid`,
    `loss_reid_aux`) and every gradient against `jax.value_and_grad` of the
    weighted total, the encoder's included (the reid head's attention to
    both frames' memories reaches it), BERT's zero (frozen); then AdamW's
    step decays the frozen BERT as optax's chain does."""
    cfg, inputs, images_ref, tk, tr, jm, params, _ = pair
    model = build_model(cfg, "cpu", seed=0).train()
    convert.load_jax_params(model, params)
    weights = jax_loss_weights(cfg)

    def loss_fn(p):
        losses = jm.apply({"params": p}, *inputs, _jax_targets(tk), _jax_targets(tr),
                          images_ref, method=JaxDETR.forward_video_train)
        return jax_weighted_total(losses, weights), losses

    (total, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"])
    batch = {"images_key": _t(inputs[0]), "images_ref": _t(images_ref),
             "img_mask": _t(inputs[1]), "image_sizes": _t(inputs[2]),
             "text_ids": _t(inputs[3]).long(), "text_mask": _t(inputs[4]),
             "targets_key": _port_targets(tk), "targets_ref": _port_targets(tr)}
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg))
    assert {"loss_reid", "loss_reid_aux", "loss_mask", "loss_dice_0"} <= set(losses)
    assert set(losses) == set(jlosses)
    assert float(jlosses["loss_reid"]) > 0.1
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(jlosses[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_total.detach().numpy(), np.asarray(total), rtol=2e-5)

    def as_tree(tensors):
        tensors = {k: v for k, v in tensors.items() if not k.startswith("detr.resizer.")}
        zeros = jax.tree.map(np.zeros_like, {"params": params["params"]})
        tree, report = convert_checkpoint(tensors, copy.deepcopy(zeros))
        assert report["missing_target"] == [] and report["unused_source"] == []
        return dict(jax.tree_util.tree_leaves_with_path(tree["params"]))

    named = dict(model.named_parameters())
    assert all(named[n].grad is None for n in named if n.startswith("text_encoder."))
    grads = as_tree({k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in named.items()})
    checked = set()
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-2)
        np.testing.assert_allclose(grads[path], want, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)
        if np.abs(want).max() > 0:
            checked.add(name.split("'")[1])
    # the encoder, the reid decoder and the reid MLP learn; BERT does not
    assert {"transformer", "reid_dec_0", "reid_dec_1", "reid_embed", "backbone"} <= checked
    assert "bert" not in checked
    enc = grads[next(p for p, _ in jax.tree_util.tree_leaves_with_path(jgrads)
                     if "encoder_scan" in jax.tree_util.keystr(p)
                     and "value_proj" in jax.tree_util.keystr(p))]
    assert np.abs(enc).max() > 0

    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    opt.step()
    tx = joptim.build_optimizer(cfg.solver, params["params"])
    # optax over the whole tree under one jit each (eagerly: a compile per leaf shape)
    updates, _ = jax.jit(tx.update)(jgrads, jax.jit(tx.init)(params["params"]),
                                    params["params"])
    jnew = jax.jit(optax.apply_updates)(params["params"], updates)
    new = as_tree(dict(model.named_parameters()))
    lr = cfg.solver.lang_lr * optim.lr_schedule(cfg.solver)(0)
    bert = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jnew):
        if "bert" in jax.tree_util.keystr(path):
            # a zero gradient: Adam's update is 0, the weight decay shrinks
            # the leaf by (1 - lr_lang * schedule * wd) = 1 - 5e-7, in fp32
            # as optax: within 2.5e-7 of optax's, half that step
            np.testing.assert_allclose(new[path], np.asarray(want), rtol=2.5e-7, atol=0,
                                       err_msg=jax.tree_util.keystr(path))
            bert += 1
    assert bert > 10 and lr > 0
    emb = "text_encoder.body.model.embeddings.word_embeddings.weight"
    before = params["params"]["bert"]["word_embeddings"]["embedding"]
    got = named[emb].detach().numpy()
    np.testing.assert_allclose(got, before * np.float32(1 - lr * cfg.solver.weight_decay),
                               rtol=2.5e-7, atol=0)
    assert (got != before).mean() > 0.5            # the decay moved most entries


def test_video_grounding_losses_match_jax(pair):
    """`forward_video_train(task="grounding")`: the key frame aligned with
    the pooled expression, the ref frame's simOTA costs from the last
    layer's logits against it (`uninext_tpu/models/detr.py:727-735`);
    every loss against the JAX package's (values only)."""
    cfg, inputs, images_ref, tk, tr, jm, params, model = pair
    want = jax.jit(lambda p: jm.apply(p, *inputs, _jax_targets(tk), _jax_targets(tr),
                                      images_ref, task="grounding",
                                      method=JaxDETR.forward_video_train))(params)
    with torch.no_grad():
        got = model.train().forward_video_train(
            *map(_t, inputs[:3]), _t(inputs[3]).long(), _t(inputs[4]), _port_targets(tk),
            _port_targets(tr), _t(images_ref), task="grounding")
    model.eval()
    assert set(got) == set(want) and "loss_reid" in got
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["mixed", "no_positive", "no_negative", "row_invalid"])
def test_loss_reid_static_matches_jax(case):
    """The port's form (softplus of two LSEs, no (R, Q*Q) tensor) against the
    JAX loss and its gradients w.r.t. contrast and cos, on rows with
    positives and negatives, rows without a positive, rows without a
    negative and rows not valid; every case mixes in ordinary rows."""
    rng = np.random.RandomState(3)
    R, Q = 6, 40
    contrast = (rng.randn(R, Q) * 4).astype(np.float32)
    cos = rng.uniform(-1, 1, (R, Q)).astype(np.float32)
    labels = rng.choice([1, 0, 0, 0, -1], (R, Q)).astype(np.int32)
    row_valid = np.ones(R, np.float32)
    if case == "no_positive":
        labels[1] = np.where(labels[1] == 1, 0, labels[1])
        labels[4] = -1
    elif case == "no_negative":
        labels[2] = np.where(labels[2] == 0, -1, labels[2])
    elif case == "row_invalid":
        row_valid[[0, 5]] = 0
    jfn = lambda c, s: jcrit.loss_reid_static(c, labels, row_valid, s)
    jl = jax.jit(jfn)(contrast, cos)
    c, s = _t(contrast).requires_grad_(), _t(cos).requires_grad_()
    got = crit.loss_reid_static(c, _t(labels), _t(row_valid), s)
    sum(got.values()).backward()
    jgrad = jax.jit(jax.grad(lambda c, s: sum(jfn(c, s).values()), argnums=(0, 1)))(contrast,
                                                                                      cos)
    for k in ("loss_reid", "loss_reid_aux"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(jl[k]), rtol=1e-5,
                                   err_msg=k)
    assert torch.isfinite(c.grad).all() and torch.isfinite(s.grad).all()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgrad[0]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrad[1]), rtol=1e-5, atol=1e-8)


def test_reid_optimizer_groups_match_classify_param(pair):
    """Every port parameter's group equals JAX's `classify_param` of the
    leaves it is built from: the reid decoder's `sampling_offsets` in
    "linear_proj", the rest of the reid head in "base"."""
    cfg, *_, params, model = pair
    sources = bridge_sources(params)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    groups = {n: g for g, names in opt.names.items() for n in names}
    assert set(sources) == set(groups) - {n for n in groups if n.startswith("detr.resizer.")}
    seen = set()
    for key, paths in sources.items():
        for p in paths:
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert groups[key] == joptim.classify_param(tuple(p_jax.split("/"))), key
            seen.add(p_jax)
    assert len(seen) == len(jax.tree_util.tree_leaves(params))
    assert groups[REID + "0.layers.0.cross_attn.sampling_offsets.weight"] == "linear_proj"
    assert groups[REID + "0.layers.1.self_attn.in_proj_weight"] == "base"
    assert groups[REID + "0.ref_point_head.layers.0.weight"] == "base"
    assert groups[REID + "1.layers.2.bias"] == "base"
