"""The eval protocol (`engine/protocol.py`) and batched serving of the port
against the JAX package on the CPU, fp32, and the protocol tools
(`tools/frontier_sweep.py`, `tools/frontier_merge.py`,
`tools/serve_throughput.py`).

The JAX trees are random trees of `init_all_paths`'s shapes (`jax.eval_shape`
and numpy, `tests/test_torch_sot.py:_random_tree`, no compiled init), so the
MSDA offset and weight projections are not zero and a cut changes numbers.
JAX's `adapt_params` is numpy: only the served request compiles.

Claims held here:
  * the port's cut of a model filled from the uncut tree equals, tensor for
    tensor, the port filled from JAX's cut of that tree, for
    `tiny_test_config` and for `tiny_video_test_config` with the deformable
    reid head, at (Q', enc P', dec P') = (16, 2, 2) and (Q, 3, 1);
  * an MSDA module cut from 4 to 2 points equals the full module with the
    dropped points masked out of the softmax (2-d reference points), and
    JAX's cut module (4-d reference points: the decoder's 1/P scaling);
  * `tiny_test_config` served under (16, 2, 2) matches JAX's;
  * the no-op is the identity, growing the query count raises, the input
    is not changed;
  * a batch of 2 served at once equals the two served alone, and a cached
    batch-1 prompt expanded to the batch equals the prompt encoded at it;
  * the merge and the promotion equal JAX's tools on synthetic halves; the
    tools run on the CPU at the tiny preset and write their schema.
"""
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.test_torch_sot import _random_tree
from tests.test_torch_video import video_config
from tests.torch_port_common import detection_inputs, one_torch_thread
from uninext_tpu import config as jconfig
from uninext_tpu.engine import protocol as jprotocol
from uninext_tpu.models.layers import MSDeformAttnModule
from uninext_tpu.models.postprocess import postprocess_detection as jax_post
from uninext_tpu_torch.config import tiny_test_config
from uninext_tpu_torch.engine import protocol
from uninext_tpu_torch.engine.convert import load_jax_params
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.models.layers import MSDeformAttn
from uninext_tpu_torch.models.postprocess import postprocess_detection
from uninext_tpu_torch.ops.msda import ms_deform_attn_plain
from uninext_tpu_torch.tools import frontier_merge, frontier_sweep, serve_throughput

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {"image": tiny_test_config, "video": video_config}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _replace_nested(jax_obj, port_obj):
    """`jax_obj` (a JAX package config) with every field of the port's
    `port_obj`."""
    return dataclasses.replace(jax_obj, **{
        f.name: (_replace_nested(getattr(jax_obj, f.name), getattr(port_obj, f.name))
                 if dataclasses.is_dataclass(getattr(port_obj, f.name))
                 else getattr(port_obj, f.name))
        for f in dataclasses.fields(port_obj)})


@functools.lru_cache(maxsize=None)
def _filled(kind):
    """(port config, JAX config, the random JAX tree of every path, the port
    model with the template branch filled from it) of `kind`."""
    cfg = KINDS[kind]()
    jcfg = _replace_nested(jconfig.tiny_test_config(), cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    shapes = jax.eval_shape(lambda r: jdetr.init_all_paths(jdetr.UninextDETR(jcfg), r),
                            jax.random.PRNGKey(0))
    tree = _random_tree(shapes, seed=31)
    model = build_model(cfg, "cpu", seed=0, template=True)
    load_jax_params(model, tree)
    return cfg, jcfg, tree, model


@pytest.mark.parametrize("served", ["16_2_2", "q_3_1"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_adapt_params_matches_jax_tensor_for_tensor(kind, served):
    """JAX's cut of the tree through the bridge == the port's cut of the
    port filled from the uncut tree, every tensor of the state dict; the
    configs equal; the reid head's decoder layers cut too; the cut state
    loads strictly into the new config's model."""
    cfg, jcfg, tree, model = _filled(kind)
    q, ep, dp = {"16_2_2": (16, 2, 2), "q_3_1": (cfg.transformer.num_queries, 3, 1)}[served]
    jtree, jcfg2 = jprotocol.adapt_params(tree, jcfg, num_queries=q, enc_n_points=ep,
                                          dec_n_points=dp)
    sd, cfg2 = protocol.adapt_params(model, cfg, num_queries=q, enc_n_points=ep,
                                     dec_n_points=dp)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    want_model = build_model(cfg2, "cpu", seed=1, template=True)
    load_jax_params(want_model, jtree)
    want = want_model.state_dict()
    assert sd.keys() == want.keys()
    differ = [k for k in want if not torch.equal(sd[k], want[k])]
    assert not differ, differ[:5]
    cut = [k for k in sd if k.endswith("sampling_offsets.weight")
           and sd[k].shape[0] != model.state_dict()[k].shape[0]]
    n_dec = cfg.transformer.dec_layers + (cfg.n_layer_deformable_reid if kind == "video" else 0)
    assert len(cut) == cfg.transformer.enc_layers + n_dec
    if kind == "video":
        assert sum(".reid_embed_head.0.layers." in k for k in cut) == 2
    got, cfg3 = protocol.adapted_model(model, cfg, num_queries=q, enc_n_points=ep,
                                       dec_n_points=dp, device="cpu", template=True)
    assert cfg3 == cfg2 and not got.training
    assert all(torch.equal(v, want[k]) for k, v in got.state_dict().items())


def _msda_weights(rng, mod):
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(_t(rng.randn(*p.shape).astype(np.float32) * 0.05 + p.detach().numpy()))


def test_msda_point_cut_matches_masked_reference_and_jax():
    """A port MSDA module cut from 4 to 2 points (`_slice_msda` on its state
    dict) == the full module's projections with the dropped points masked
    out of the softmax, with 2-d reference points (rtol, atol 1e-5); and ==
    JAX's `MSDeformAttnModule` with JAX's cut of the same weights, with 2-d
    and with 4-d reference points (the offsets divided by the kept P)."""
    rng = np.random.RandomState(1)
    B, Lq, C, M, L, P, Pn = 2, 7, 32, 4, 2, 4, 2
    shapes = ((8, 12), (4, 6))
    S = sum(h * w for h, w in shapes)
    query = rng.randn(B, Lq, C).astype(np.float32)
    value = rng.randn(B, S, C).astype(np.float32)
    ref2 = rng.rand(B, Lq, L, 2).astype(np.float32)
    ref4 = np.concatenate([ref2, 0.1 + 0.3 * rng.rand(B, Lq, L, 2).astype(np.float32)], -1)
    full = MSDeformAttn(C, L, M, P)
    full.init_weights(torch.Generator().manual_seed(0))
    _msda_weights(rng, full)
    sd = {k: v.clone() for k, v in full.state_dict().items()}
    cut_sd = dict(sd)
    protocol._slice_msda(cut_sd, "", M, L, P, Pn)
    small = MSDeformAttn(C, L, M, Pn)
    small.load_state_dict(cut_sd, strict=True)
    assert torch.equal(sd["sampling_offsets.weight"], full.state_dict()[
        "sampling_offsets.weight"])                 # the input is not changed

    with torch.no_grad():
        q, v = _t(query), _t(value)
        off = full.sampling_offsets(q).reshape(B, Lq, M, L, P, 2)[..., :Pn, :]
        aw = full.attention_weights(q).reshape(B, Lq, M, L, P)[..., :Pn]
        aw = aw.reshape(B, Lq, M, L * Pn).softmax(-1).reshape(B, Lq, M, L, Pn)
        val = full.value_proj(v).reshape(B, S, M, C // M)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        loc = _t(ref2)[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        want = full.output_proj(ms_deform_attn_plain(val, shapes, loc, aw))
        got = small(q, _t(ref2), v, None, shapes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    # JAX's module with JAX's cut of the same weights (flax kernels are (in, out))
    jtree = {name: {"kernel": sd[f"{name}.weight"].numpy().T.copy(),
                    "bias": sd[f"{name}.bias"].numpy().copy()}
             for name in ("sampling_offsets", "attention_weights", "value_proj",
                          "output_proj")}
    jprotocol._slice_msda(jtree, M, L, P, Pn)
    jsmall = MSDeformAttnModule(d_model=C, n_levels=L, n_heads=M, n_points=Pn)
    japply = jax.jit(lambda t, r: jsmall.apply({"params": t}, query, r, value, None, shapes))
    for ref in (ref2, ref4):
        jwant = japply(jtree, ref)
        with torch.no_grad():
            got = small(_t(query), _t(ref), _t(value), None, shapes)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5, atol=1e-5)


def _cmap(C=5, T=16):
    m = np.zeros((C, T), bool)
    for c in range(C):
        m[c, 1 + 2 * c: 2 + 2 * c + (c % 2)] = True
    return m


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def test_served_under_a_cut_protocol_matches_jax():
    """`tiny_test_config` at `detection_inputs` under (16, 2, 2), served by
    the port on the CPU and by JAX: logits, boxes and IoU logits within
    1e-4 of their largest magnitude (tests/test_torch_r50.py's detection
    tolerance), and `postprocess_detection`'s kept queries and classes
    equal."""
    cfg, jcfg, tree, model = _filled("image")
    inputs = detection_inputs(0)
    jtree, jcfg2 = jprotocol.adapt_params(tree, jcfg, num_queries=16, enc_n_points=2,
                                          dec_n_points=2)
    jm = jdetr.UninextDETR(jcfg2)
    cmap = _cmap()

    def jax_serve(p):
        out = jm.apply(p, *inputs, task="detection")
        return out, jax_post({k: out[k] for k in ("pred_logits", "pred_boxes",
                                                  "pred_boxious")}, cmap)

    want, jpost = jax.jit(jax_serve)(jtree)
    small, _ = protocol.adapted_model(model, cfg, num_queries=16, enc_n_points=2,
                                      dec_n_points=2, device="cpu", template=True)
    with torch.inference_mode():
        got = small(*map(_t, inputs), task="detection")
        post = postprocess_detection(got, _t(cmap))
    assert got["pred_logits"].shape == (2, 16, 16)
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        _close(got[key], want[key], 1e-4, key)
    for key in ("query_idx", "classes"):
        np.testing.assert_array_equal(post[key].numpy(), np.asarray(jpost[key]), key)
    _close(post["scores"], jpost["scores"], 1e-5, "scores")


def test_noop_is_identity_and_the_input_stays():
    """The no-op protocol returns the same tensors and config and serves
    bit-equal outputs; a cut leaves the input model's state as it was;
    more queries than trained, or points outside 1 <= P' < P, raise."""
    cfg, _, _, model = _filled("image")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd, cfg2 = protocol.adapt_params(model, cfg, num_queries=cfg.transformer.num_queries)
    assert cfg2 == cfg
    assert all(sd[k] is v or torch.equal(sd[k], v) for k, v in model.state_dict().items())
    same, _ = protocol.adapted_model(model, cfg, num_queries=cfg.transformer.num_queries,
                                     device="cpu", template=True)
    inputs = [_t(x) for x in detection_inputs(0)]
    with torch.inference_mode():
        a, b = model(*inputs), same(*inputs)
    for key in ("pred_logits", "pred_boxes", "pred_boxious", "memory"):
        assert torch.equal(a[key], b[key]), key
    protocol.adapt_params(model.state_dict(), cfg, num_queries=16, enc_n_points=2,
                          dec_n_points=1)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    with pytest.raises(AssertionError):
        protocol.adapt_params(model, cfg, num_queries=cfg.transformer.num_queries + 1)
    for bad in ({"enc_n_points": 5}, {"dec_n_points": 0}):
        with pytest.raises(AssertionError):
            protocol.adapt_params(model, cfg, **bad)


def test_batch_served_at_once_equals_each_alone():
    """A batch of 2 (image 0 padded) through forward and
    `postprocess_detection` == each image served alone at batch 1 (fp32,
    within 1e-5 of each output's largest magnitude; kept queries equal);
    and one prompt encoded at batch 1 and expanded to the batch without a
    copy serves what the prompt encoded at batch 2 serves."""
    cfg, _, _, model = _filled("image")
    images, img_mask, sizes, ids, tmask = detection_inputs(0)
    cmap = _t(_cmap())
    with torch.inference_mode():
        both = model(_t(images), _t(img_mask), _t(sizes), _t(ids).long(), _t(tmask))
        post = postprocess_detection(both, cmap)
        for b in range(2):
            one = model(*(_t(x[b:b + 1]) for x in (images, img_mask, sizes)),
                        _t(ids[b:b + 1]).long(), _t(tmask[b:b + 1]))
            post1 = postprocess_detection(one, cmap)
            for key in ("pred_logits", "pred_boxes", "pred_boxious", "memory"):
                _close(both[key][b:b + 1], one[key].numpy(), 1e-5, f"{key} of image {b}")
            for key in ("query_idx", "classes"):
                assert torch.equal(post[key][b:b + 1], post1[key]), key
        prompt_ids, prompt_mask = _t(ids[:1]).long(), _t(tmask[:1])
        lang = serve_throughput.expand_prompt(model.encode_text(prompt_ids, prompt_mask), 2)
        assert lang["hidden"].stride(0) == 0
        cached = model(_t(images), _t(img_mask), _t(sizes), None, lang["masks"],
                       lang_dict=lang)
        encoded = model(_t(images), _t(img_mask), _t(sizes), prompt_ids.expand(2, -1),
                        prompt_mask.expand(2, -1))
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        _close(cached[key], encoded[key].numpy(), 1e-5, f"{key} with the cached prompt")


def _jax_tool(name):
    """The JAX package's `tools/<name>.py` as a module (sys.path restored)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _halves():
    """Synthetic FPS and AP halves over the 14 protocols: FPS rising as the
    protocol gets cheaper, AP falling; the AP half names a protocol the FPS
    half lacks and misses one it has."""
    rng = np.random.RandomState(4)
    fps, apd = {}, {}
    for i, (name, q, ep, dp, scale) in enumerate(frontier_sweep.PROTOCOLS):
        ident = {"num_queries": q, "enc_points": ep, "dec_points": dp, "res_scale": scale}
        fps[name] = {**ident, "fps_det": round(20 + 3 * i + rng.rand(), 3),
                     "serving_shape": list(frontier_sweep.serving_shape(scale))}
        if i != 3:
            apd[name] = {**ident, "ap_bbox": round(0.4 - 0.004 * i - 0.01 * rng.rand(), 4),
                         "ap50_bbox": round(0.6 - 0.01 * i, 4),
                         "fixture_eval_res": list(frontier_sweep.fixture_res(scale))}
    apd["extra"] = {"num_queries": 100, "enc_points": 1, "dec_points": 1,
                    "res_scale": 0.5, "ap_bbox": 0.2}
    apd["base_900q_p44_800px"]["ap_segm"] = 0.31
    return ({"train_steps": 0, "device": "card", "partial": True, "protocols": fps},
            {"train_steps": 2000, "device": "card", "partial": False, "protocols": apd})


def test_merge_and_promotion_match_the_jax_tools(tmp_path, monkeypatch):
    """`frontier_merge` on two synthetic halves writes what JAX's
    `tools/frontier_merge.py` writes and prints its table; `frontier_sweep.
    save`'s deltas and promoted point equal JAX's `save`'s on the same
    results (host only)."""
    fps, apd = _halves()
    for name, d in (("fps.json", fps), ("ap.json", apd)):
        (tmp_path / name).write_text(json.dumps(d))
    outs = {}
    for who, run in (("jax", lambda argv: _jax_tool("frontier_merge").main()),
                     ("port", lambda argv: frontier_merge.main(argv))):
        argv = ["--fps", str(tmp_path / "fps.json"), "--ap", str(tmp_path / "ap.json"),
                "--out", str(tmp_path / f"{who}.json")]
        monkeypatch.setattr(sys, "argv", ["frontier_merge"] + argv)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            run(argv)
        outs[who] = (json.loads((tmp_path / f"{who}.json").read_text()),
                     text.getvalue().split("[done]")[0])
    assert outs["port"] == outs["jax"]
    merged = outs["port"][0]
    assert merged["promoted"]["name"] != "base_900q_p44_800px"
    assert merged["protocols"]["res608"].get("ap_bbox") is None

    jsweep = _jax_tool("frontier_sweep")
    results = {k: dict(v) for k, v in fps["protocols"].items()}
    for k, v in apd["protocols"].items():
        results.setdefault(k, {}).update(v)
    args = dict(steps=2000, n_train=32, n_val=48, device="card", card="card", seed=0,
                requests=20, smoke=False)
    payloads = {}
    for who, save in (("jax", jsweep.save), ("port", frontier_sweep.save)):
        out = tmp_path / f"save_{who}.json"
        res = copy.deepcopy(results)
        save(type("Args", (), {**args, "out": str(out)}), res)
        payloads[who] = json.loads(out.read_text())
    for key in ("promoted", "protocols", "train_steps", "n_train", "n_val", "partial"):
        assert payloads["port"][key] == payloads["jax"][key], key
    assert [p[0] for p in jsweep.PROTOCOLS] == [p[0] for p in frontier_sweep.PROTOCOLS]
    assert jsweep.PROTOCOLS == frontier_sweep.PROTOCOLS
    for scale in {p[4] for p in jsweep.PROTOCOLS}:
        assert jsweep.serving_shape(scale) == frontier_sweep.serving_shape(scale)
        assert jsweep.fixture_res(scale) == frontier_sweep.fixture_res(scale)


def test_serve_throughput_runs_on_the_cpu(tmp_path):
    out = serve_throughput.main(["--config", "tiny", "--hw", "64", "96", "--sizes", "1", "2",
                                 "--requests", "2",
                                 "--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(json.dumps(out))
    assert [r["bs"] for r in out["rows"]] == [1, 2] and out["device"] == "cpu"
    for row in out["rows"]:
        assert row["requests"] == 2 and row["step_ms_min"] <= row["step_ms"] <= row[
            "step_ms_max"]
        assert row["msda_launches_per_step"] == 0 and row["nms_launches_per_step"] == 0
        assert row["img_per_s"] == pytest.approx(row["bs"] * 1e3 / row["step_ms"])
    assert {"config", "resolution", "card", "rows", "throughput_gain_at_max_bs"} <= set(out)


def test_frontier_sweep_smoke_runs_on_the_cpu(tmp_path):
    """`--smoke` on both halves: 2 training steps of the tiny preset, the
    three smoke protocols evaluated and served at 64x96."""
    out = frontier_sweep.main(["--smoke", "--steps", "2", "--n-train", "2", "--n-val", "1",
                               "--requests", "1", "--hw", "64", "96",
                               "--device", "cpu", "--out", str(tmp_path / "f.json")])
    assert json.loads((tmp_path / "f.json").read_text()) == json.loads(json.dumps(out))
    assert out["partial"] is False and set(out["protocols"]) == {
        p[0] for p in frontier_sweep.SMOKE_PROTOCOLS}
    for name, v in out["protocols"].items():
        assert v["fps_det"] > 0 and v["serving_shape"] == [64, 96]
        assert v["ap_bbox"] is not None and v["ap_delta_vs_base"] is not None
        assert v["request_ms"]["requests"] == 1
    assert out["promoted"]["name"] in out["protocols"]
    assert out["protocols"]["base_900q_p44_800px"]["ap_segm"] is not None


@pytest.mark.parametrize("tool", ["serve_throughput", "frontier_sweep"])
def test_tools_refuse_cuda_without_a_card(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"serve_throughput": serve_throughput, "frontier_sweep": frontier_sweep}[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
