"""The reference's transformer options that no preset sets, port vs the JAX
package on the CPU, fp32, at the small ViT config
(`torch_port_common.tiny_vit_config`):

  G1  use_additional_bert (MODEL.USE_ADDITIONAL_BERT: a BERT layer on the
      language stream after every encoder layer), still_cls_for_encoder
      False (the encoder's proposal head a VLAlign), use_iou_branch False
      (no IoU heads, scores from the class alone);
  G2  still_tgt_for_both False (grounding's target is the pooled prompt);
  G3  decouple_tgt False (every target the pooled prompt, the DN rows
      too), look_forward_twice False (detached references: only the
      gradients differ).

For each group: the forward and its postprocess (G1, G3 detection; G2
grounding), one train step's losses and every gradient against
`jax.jit(jax.value_and_grad(...))` of `model.apply` (the gradients mapped
by the port's bridge, `engine/convert.py`, which JAX's `convert_checkpoint`
cannot do for `lang_layer_i` or a VLAlign `enc_class_embed`), and the
bridge's round trip. Then port-only checks: each option alone changes what
it should, G1's optimizer groups and its tensor-parallel cut, and the
one-stage transformer still refused.

G2's and G3's parameter trees are the small config's tree of the whole
pytest run (`tiny_vit_init`: the options add no parameter). G1's is built from it
without compiling JAX's init: the scan-stacked encoder unstacked, each
`lang_layer_i` a copy of `bert/layer_i`, `enc_class_embed` a copy of the
last layer's VLAlign, the IoU heads dropped; its layout is held to
`jax.eval_shape` of G1's init. Every JAX result is compiled once per
pytest run (`shared_across_workers`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (FakeMesh, bridge_sources, class_token_map, detection_inputs,
                                     detection_targets, dn_noise, jax_loss_and_grads,
                                     one_torch_thread, perturb, shared_across_workers,
                                     tiny_vit_config, tiny_vit_init)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.sot_inference import make_sot_frame_step as jax_sot_step
from uninext_tpu.models.detr import feature_shapes
from uninext_tpu.models.postprocess import postprocess_detection as jax_post
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.engine.sot_inference import make_sot_frame_step
from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
from uninext_tpu_torch.models import detr
from uninext_tpu_torch.models.bert import BertLayer
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.models.heads import VLAlign
from uninext_tpu_torch.models.postprocess import (grounding_to_od_logits, postprocess_detection,
                                                  postprocess_rec)
from uninext_tpu_torch.parallel import sharding

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

GROUPS = {
    "G1": dict(use_additional_bert=True, still_cls_for_encoder=False, use_iou_branch=False),
    "G2": dict(still_tgt_for_both=False),
    "G3": dict(decouple_tgt=False, look_forward_twice=False),
}
TASK = {"G1": "detection", "G2": "grounding", "G3": "detection"}
DN_KEY = jax.random.PRNGKey(123)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def options_config(**opts):
    cfg = tiny_vit_config()
    return dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, **opts))


def _g1_tree(base, shapes):
    """G1's layout from the small config's tree (numpy leaves), without an
    init compile: the encoder unstacked (G1 takes JAX's unrolled path), each
    `transformer/lang_layer_i` a copy of `bert/layer_i`, `enc_class_embed`
    a copy of the last `class_embed_i`, no `iou_head_i`."""
    p = {k: v for k, v in base["params"].items() if not k.startswith("iou_head_")}
    tr = dict(p["transformer"])
    scan = tr.pop("encoder_scan")["layer"]
    n = jax.tree.leaves(scan)[0].shape[0]
    for i in range(n):
        tr[f"encoder_layer_{i}"] = jax.tree.map(lambda x, i=i: x[i], scan)
        tr[f"lang_layer_{i}"] = p["bert"][f"layer_{i}"]
    p["transformer"] = tr
    dec = sum(k.startswith("class_embed_") for k in p)
    p["enc_class_embed"] = p[f"class_embed_{dec - 1}"]
    tree = jax.tree.map(np.copy, {"params": p})
    want = jax.tree.map(lambda s: s.shape, shapes)
    assert jax.tree.map(np.shape, tree) == want
    return tree


def _jax_g1_shapes(inputs, targets):
    jm = jdetr.UninextDETR(options_config(**GROUPS["G1"]))
    boxes, valid, pm = targets
    B, H, W = inputs[0].shape[:3]
    tgt = {"boxes": boxes, "valid": valid, "positive_map": pm, "has_masks": True,
           "masks": np.zeros((B, valid.shape[1], H // 4, W // 4), np.float32)}
    return jax.eval_shape(lambda r: jm.init({"params": r, "dn": r}, *inputs, targets=tgt,
                                            train=True), jax.random.PRNGKey(0))


def _jax_forward(jm, params, inputs, task):
    """JAX's serving outputs of `task` and what the port's postprocess is held
    to: `postprocess_detection` (five classes), or for grounding the
    evaluator's inline top-1 (sqrt(cls * iou), or cls alone) and that
    query's mask (`predict_masks`)."""
    out = jax.tree.map(np.asarray, jax.jit(lambda p: jm.apply(p, *inputs, task=task))(params))
    if task == "detection":
        post = jax.jit(lambda o: jax_post(o, class_token_map()))(
            {k: out[k] for k in ("pred_logits", "pred_boxes", "pred_boxious") if k in out})
        return out, jax.tree.map(np.asarray, post)
    prob = jax.nn.sigmoid(out["pred_logits"][..., 0])
    if "pred_boxious" in out:
        prob = jnp.sqrt(prob * jax.nn.sigmoid(out["pred_boxious"][..., 0]))
    best = np.asarray(prob).argmax(-1)[:, None]
    take = lambda x: np.take_along_axis(x, best[..., None], axis=1)
    shapes = feature_shapes(4, *inputs[0].shape[1:3])
    mask = jax.jit(lambda p, m, h, r, s: jm.apply(
        p, m, shapes, h, r, s, method=jdetr.UninextDETR.predict_masks))(
        params, out["memory"], take(out["hs"]), take(out["base_reference"]), inputs[2])
    return out, {"query_idx": best[:, 0], "box": take(out["pred_boxes"])[:, 0],
                 "mask_logits": np.asarray(mask)}


def _jax_step(jm, params, inputs, targets, task):
    """JAX's losses and gradients (numpy), the DN key pinned to DN_KEY."""
    with pytest.MonkeyPatch.context() as mp:
        total, losses, grads = jax_loss_and_grads(jm, params, inputs, targets, jm.cfg, mp,
                                                  DN_KEY, task=task)
    return jax.tree.map(np.asarray, (total, losses, grads))


@pytest.fixture(scope="module")
def groups(tmp_path_factory, worker_id):
    """group -> (config, JAX model, perturbed tree, the port's model loaded
    from it), and `jax_result(what, group)`: JAX's forward or step of the
    group, compiled once per pytest run."""
    inputs, targets = detection_inputs(0), detection_targets(0)
    base = tiny_vit_init(tmp_path_factory, worker_id)
    trees = {"G1": shared_across_workers("options_g1_tree", lambda: perturb(_g1_tree(
        base, _jax_g1_shapes(inputs, targets)), seed=5), tmp_path_factory, worker_id),
             "G2": perturb(base), "G3": perturb(base)}
    made, cache = {}, {}
    for g, opts in GROUPS.items():
        cfg = options_config(**opts)
        model = build_model(cfg, "cpu", seed=0)
        convert.load_jax_params(model, trees[g])
        made[g] = (cfg, jdetr.UninextDETR(cfg), trees[g], model)

    def jax_result(what, g):
        if (what, g) not in cache:
            _, jm, params, _ = made[g]
            make = {"forward": lambda: _jax_forward(jm, params, inputs, TASK[g]),
                    "step": lambda: _jax_step(jm, params, inputs, targets, TASK[g])}[what]
            cache[what, g] = shared_across_workers(f"options_{what}_{g}", make,
                                                   tmp_path_factory, worker_id)
        return cache[what, g]

    return made, inputs, targets, jax_result


@pytest.mark.parametrize("g", list(GROUPS))
def test_forward_and_postprocess_match_jax(groups, g):
    made, inputs, _, jax_result = groups
    cfg, _, _, model = made[g]
    want, jpost = jax_result("forward", g)
    with torch.inference_mode():
        got = model(*map(_t, inputs), task=TASK[g])
    keys = ["pred_logits", "pred_boxes", "hs", "memory"]
    if cfg.transformer.use_iou_branch:
        keys.append("pred_boxious")
    assert ("pred_boxious" in got) == ("pred_boxious" in want) == cfg.transformer.use_iou_branch
    for key in keys:
        assert got[key].shape == want[key].shape, key
        # fp32 through backbone, BERT (and G1's BERT layers), 2 + 2
        # transformer layers and heads
        np.testing.assert_allclose(_np(got[key]), want[key], atol=1e-4, err_msg=key)
    with torch.inference_mode():
        if TASK[g] == "detection":
            post = postprocess_detection(got, _t(class_token_map()))
            for key in ("query_idx", "classes"):
                np.testing.assert_array_equal(_np(post[key]), jpost[key], key)
            keys = ("boxes", "scores")
        else:
            post = postprocess_rec(model, got, _t(inputs[2]))
            np.testing.assert_array_equal(_np(post["query_idx"]), jpost["query_idx"])
            keys = ("box", "mask_logits")
    for key in keys:
        # the same selections of values that agree to ~1e-6; the mask logits
        # (up to ~80) within 1e-4 of their largest, as tests/test_torch_r50.py
        atol = 1e-4 * (np.abs(jpost[key]).max() if key == "mask_logits" else 1.0)
        np.testing.assert_allclose(_np(post[key]), jpost[key], atol=atol, err_msg=key)


@pytest.mark.parametrize("g", list(GROUPS))
def test_train_step_matches_jax(groups, g):
    """One step (G2 a grounding step): every loss key, and every gradient
    leaf against JAX's, mapped to the port's parameters by the bridge
    (`convert.state_dict_from_jax` of the gradient tree: every JAX leaf taken,
    every port parameter met). G3's step is what holds
    look_forward_twice False: its forward equals the default's."""
    made, inputs, targets, jax_result = groups
    cfg, _, _, model = made[g]
    total, jlosses, jgrads = jax_result("step", g)
    model.zero_grad(set_to_none=True)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(targets[0]), "valid": _t(targets[1]),
                         "positive_map": _t(targets[2])}}
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    got_total, losses = loss_and_grads(model, batch, loss_weights(cfg), task=TASK[g],
                                       dn_noise=dn_noise(DN_KEY, 2, single_pad))
    assert set(losses) == set(jlosses)
    assert ("loss_boxiou" in losses) == cfg.transformer.use_iou_branch
    for k in losses:
        # as tests/test_torch_train.py: the forward agrees to ~1e-6 relative
        np.testing.assert_allclose(_np(losses[k]), jlosses[k], rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(got_total), total, rtol=2e-5)

    grads = jax.tree_util.tree_map_with_path(
        # one ConvTranspose2d bias for JAX's four sub-pixel copies: the
        # port's gradient is their sum
        lambda p, x: (np.tile(x.reshape(4, -1).sum(0), 4)
                      if jax.tree_util.keystr(p).endswith("['up_res3']['bias']") else np.array(x)),
        {"params": jgrads})
    want = convert.state_dict_from_jax(grads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, w in want.items():
        p = params[name]
        gr = _np(p.grad) if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        w = _np(w)
        # as tests/test_torch_train.py: 2e-4 of the leaf's largest gradient,
        # at least 2e-6
        scale = max(float(np.abs(w).max()), 1e-2)
        np.testing.assert_allclose(gr, w, rtol=0, atol=2e-4 * scale, err_msg=name)
    if g == "G3":
        # the coupled target replaces the learnt one and the DN rows (their
        # label encoder gets no gradient), in both packages
        for name in ("detr.detr.transformer.tgt_embed.weight", "detr.resizer.fc.weight"):
            assert not np.abs(_np(want[name])).any() and params[name].grad is None, name


def _leaf_layout(path, port_value):
    """The port's tensor in the layout of the JAX leaf at `path`: Linear
    weights transposed, convolutions (out, in, kh, kw) -> (kh, kw, in, out),
    the ViT's `up_res3` ConvTranspose2d back to JAX's Dense (in, 4 * out)
    with its bias as four copies."""
    v = _np(port_value)
    if path.endswith("up_res3/kernel"):
        return v.transpose(0, 2, 3, 1).reshape(v.shape[0], -1)
    if path.endswith("up_res3/bias"):
        return np.tile(v, 4)
    if v.ndim == 2 and path.endswith("/kernel"):
        return v.T
    if v.ndim == 4:
        return v.transpose(2, 3, 1, 0)
    return v


@pytest.mark.parametrize("g", list(GROUPS))
def test_bridge_round_trip(groups, g):
    """JAX tree -> port (`load_jax_params`, strict both ways) -> the port's
    state dict, leaf by leaf back to the JAX tree: every port tensor that the
    bridge builds from one leaf equals it (in its layout); G1's BERT layers
    and VLAlign encoder head by their names (`sharding.jax_leaf`, the
    optimizer's `jax_module_path`), and no IoU head on either side."""
    made, _, _, _ = groups
    cfg, _, params, model = made[g]
    flat = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params["params"])}
    sd = model.state_dict()
    sources = bridge_sources(params)
    assert set(sources) == set(sd)
    compared = set()
    for key, paths in sources.items():
        if len(paths) == 1 and paths[0] in flat:
            np.testing.assert_array_equal(_leaf_layout(paths[0], sd[key]), flat[paths[0]],
                                          err_msg=key)
            compared.add(paths[0])
    # the rest: the decoder self-attention's q, k, v (one in_proj) and the
    # scan-stacked encoder of G2's and G3's tree (unstacked by the bridge)
    rest = set(flat) - compared
    assert all("/encoder_scan/" in p or p.split("/")[-2] in ("q_proj", "k_proj", "v_proj")
               for p in rest), sorted(rest)[:5]
    t = cfg.transformer
    lang = [k for k in sd if ".encoder.lang_layers." in k]
    assert bool(lang) == t.use_additional_bert
    for key in lang:
        leaf = sharding.jax_leaf(key)
        assert sources[key] == [leaf], key
        assert convert.jax_module_path(key).startswith("transformer/lang_layer_")
        np.testing.assert_array_equal(_leaf_layout(leaf, sd[key]), flat[leaf])
    enc = f"detr.detr.class_embed.{t.dec_layers}."
    enc_keys = sorted(k[len(enc):] for k in sd if k.startswith(enc))
    if t.still_cls_for_encoder:
        assert enc_keys == ["body.bias", "body.weight"]
    else:
        assert enc_keys == ["bias0", "bias_lang", "dot_product_projection_text.bias",
                            "dot_product_projection_text.weight", "log_scale"]
        for k in enc_keys:
            assert sources[enc + k][0].startswith("enc_class_embed/")
    assert any(".iou_head." in k for k in sd) == t.use_iou_branch
    assert any(p.startswith("iou_head_") for p in flat) == t.use_iou_branch


def test_sot_frame_step_without_iou_branch_scores_as_jax(groups):
    """The SOT frame step of G1 (task grounding with a template-like prompt,
    the additional BERT layers over it, no IoU head): the argmax query's box
    and its score sigmoid(cls) against JAX's `make_sot_frame_step`, where
    sqrt(cls * iou) would be KeyError before."""
    made, inputs, _, _ = groups
    cfg, jm, params, model = made["G1"]
    rng = np.random.RandomState(3)
    N, H, W = 24, inputs[0].shape[1], inputs[0].shape[2]
    hidden = rng.randn(1, N, cfg.language.hidden_dim).astype(np.float32)
    mask = np.ones((1, N), np.int32)
    mask[:, -4:] = 0
    args = (inputs[0][1:], inputs[1][1:], inputs[2][1:], hidden, mask)
    want = jax.tree.map(np.asarray, jax_sot_step(jm, cfg, H, W)(params["params"], *args))
    got = make_sot_frame_step(model)(*map(_t, args))
    np.testing.assert_allclose(_np(got["score"]), want["score"], atol=1e-5)
    np.testing.assert_allclose(_np(got["box_cxcywh"]), want["box_cxcywh"], atol=1e-5)
    with torch.inference_mode():
        out = model(*map(_t, args[:3]), None, _t(mask), task="grounding",
                    lang_dict={"hidden": _t(hidden), "masks": _t(mask)}, reid=False)
    assert "pred_boxious" not in out
    assert torch.equal(got["score"], out["pred_logits"][..., 0].sigmoid().amax(-1))


# ---- port-only checks ---------------------------------------------------------------

OPTIONS = {"use_additional_bert": True, "still_cls_for_encoder": False,
           "use_iou_branch": False, "still_tgt_for_both": False, "decouple_tgt": False,
           "look_forward_twice": False}


@pytest.fixture(scope="module")
def default_model(groups):
    """The small config without options, on G2's weights (the default tree)."""
    made, inputs, targets, _ = groups
    model = build_model(tiny_vit_config(), "cpu", seed=0)
    convert.load_jax_params(model, made["G2"][2])
    return model, inputs, targets


def _outputs(model, inputs, task):
    with torch.inference_mode():
        return model(*map(_t, inputs), task=task)


def _step_grads(model, inputs, targets):
    model.zero_grad(set_to_none=True)
    batch = {"images": _t(inputs[0]), "img_mask": _t(inputs[1]),
             "image_sizes": _t(inputs[2]), "text_ids": _t(inputs[3]).long(),
             "text_mask": _t(inputs[4]),
             "targets": {"boxes": _t(targets[0]), "valid": _t(targets[1]),
                         "positive_map": _t(targets[2])}}
    _, losses = loss_and_grads(model, batch, loss_weights(model.cfg),
                               dn_noise=dn_noise(DN_KEY, 2, min(20, model.cfg.data.max_insts)))
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})


@pytest.mark.parametrize("option", list(OPTIONS))
def test_each_option_alone_changes_what_it_should(default_model, option):
    """One option on the default weights (its new modules at their random
    init): USE_ADDITIONAL_BERT changes the logits (the boxes stay: the
    small config fuses the streams only before the first BERT layer), the
    encoder's VLAlign and the coupled target change the logits and the
    boxes; without the IoU branch the logits
    and boxes stay bit-equal and the scores are the class's alone; the
    grounding target changes grounding only; look_forward_twice off keeps
    the forward and the losses bit-equal and changes the gradients of the
    box heads."""
    base, inputs, targets = default_model
    cfg = options_config(**{option: OPTIONS[option]})
    model = build_model(cfg, "cpu", seed=0)
    missing, unexpected = model.load_state_dict(base.state_dict(), strict=False)
    new = {"use_additional_bert": ".encoder.lang_layers.",
           "still_cls_for_encoder": f".class_embed.{cfg.transformer.dec_layers}."}
    assert all(new.get(option, "-") in k for k in missing), missing
    gone = {"use_iou_branch": ".iou_head.",
            "still_cls_for_encoder": f".class_embed.{cfg.transformer.dec_layers}.body."}
    assert all(gone.get(option, "-") in k for k in unexpected), unexpected
    det, ref = _outputs(model, inputs, "detection"), _outputs(base, inputs, "detection")
    same = lambda a, b, k: torch.equal(a[k], b[k])
    if option in ("still_cls_for_encoder", "decouple_tgt"):
        assert not same(det, ref, "pred_logits") and not same(det, ref, "pred_boxes")
    elif option == "use_additional_bert":
        # the language stream changes; the image stream does not, as the
        # small config fuses only before the first BERT layer (num_vl_layers 1)
        assert not same(det, ref, "pred_logits") and same(det, ref, "pred_boxes")
    elif option == "use_iou_branch":
        assert same(det, ref, "pred_logits") and same(det, ref, "pred_boxes")
        assert "pred_boxious" not in det
        cmap = _t(class_token_map())
        post, post_ref = postprocess_detection(det, cmap), postprocess_detection(ref, cmap)
        assert not torch.equal(post["scores"], post_ref["scores"])
        prob = grounding_to_od_logits(det["pred_logits"].float(), cmap).sigmoid()
        want = torch.gather(prob.flatten(1), 1, post["query_idx"] * prob.shape[-1]
                            + post["classes"])
        kept = post["scores"] >= 0                  # not an entry NMS suppressed
        assert kept.any()
        np.testing.assert_allclose(_np(post["scores"][kept]), _np(want[kept]), rtol=1e-6)
    elif option == "still_tgt_for_both":
        assert same(det, ref, "pred_logits") and same(det, ref, "pred_boxes")
        g, g_ref = _outputs(model, inputs, "grounding"), _outputs(base, inputs, "grounding")
        assert not same(g, g_ref, "pred_logits")
    else:                                                     # look_forward_twice
        assert same(det, ref, "pred_logits") and same(det, ref, "pred_boxes")
        losses, grads = _step_grads(model, inputs, targets)
        losses_ref, grads_ref = _step_grads(base, inputs, targets)
        assert losses == losses_ref
        head = "detr.detr.bbox_embed.0.layers.2.weight"
        assert not torch.equal(grads[head], grads_ref[head])
        # the last decoder layer's box head feeds no later layer's reference
        last = f"detr.detr.bbox_embed.{cfg.transformer.dec_layers - 1}.layers.2.weight"
        torch.testing.assert_close(grads[last], grads_ref[last], rtol=1e-5, atol=1e-8)


def test_g1_optimizer_groups_match_classify_param(groups):
    """Every G1 parameter's group is JAX's `classify_param` of each leaf the
    bridge builds it from; the additional BERT layers fall in "base" (their
    path has no "bert"), BERT itself in "lang"."""
    made, _, _, _ = groups
    cfg, _, params, model = made["G1"]
    sources = bridge_sources(params)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    group_of = {n: g for g, names in opt.names.items() for n in names}
    assert set(group_of) == set(sources)
    for key, paths in sources.items():
        for p in paths:
            assert group_of[key] == joptim.classify_param(tuple(p.split("/"))), (key, p)
    lang = [k for k in group_of if ".encoder.lang_layers." in k]
    assert lang and {group_of[k] for k in lang} == {"base"}
    assert {group_of[k] for k in group_of if k.startswith("text_encoder.")} == {"lang"}


def test_g1_lang_layers_stay_replicated_under_tp(groups):
    """G1 on a 1 x 2 mesh (tensor parallelism over 2 ranks): BERT's layers are
    cut, the transformer's additional BERT layers stay whole on every rank
    (JAX's TP_ROOTS has no "transformer"), with all their heads and no model
    group; the load from the whole tree gives each rank the whole layers."""
    made, _, _, _ = groups
    cfg, _, params, full = made["G1"]
    whole = dict(full.named_parameters())
    for r in range(2):
        mesh = FakeMesh(2, r)
        model = sharding.shard_module(build_model(cfg, "cpu", seed=1), mesh)
        convert.load_jax_params(model, params, mesh=mesh)
        enc = model.core.transformer.encoder
        for layer in enc.lang_layers:
            assert isinstance(layer, BertLayer)
            assert layer.model_group is None and layer.num_heads == cfg.language.num_heads
        for name, p in model.named_parameters():
            if ".encoder.lang_layers." in name:
                assert p.tp_kind == "replicated" and torch.equal(p, whole[name]), name
        bert = model.bert.encoder.layer[0]
        assert bert.num_heads == cfg.language.num_heads // 2
        assert bert.attention.self.query.weight.tp_kind == "sharded"
        assert isinstance(model.core.class_embed[cfg.transformer.dec_layers], VLAlign)


def test_one_stage_transformer_still_raises():
    """two_stage False has no path in the JAX package either."""
    with pytest.raises(NotImplementedError, match="two_stage"):
        build_model(options_config(two_stage=False), "cpu")
