"""The port's data and tensor parallelism (`uninext_tpu_torch/parallel/`) on
the CPU: ranks are new processes started with `spawn` that meet over gloo
(`parallel/mesh.py:launch`); the JAX side runs on the 8-device CPU mesh of
`tests/conftest.py`.

- `param_pspec` of every ViT and BERT leaf against JAX's, and the head cut
  of qkv (which differs from JAX's contiguous cut, by design);
- A′ on each rank's heads against JAX `flash_rel_pos_attention_tp` on a
  1x2 mesh (the stock Pallas kernel replaced by a plain einsum, as
  `tests/test_tp_sharding.py` does), and its gradients;
- a 2 dp x 2 tp step of the small ViT config against JAX's
  `make_train_step(mesh 2x2, tp=True)` on the same weights, batch and DN
  noise, and the checkpoint those ranks write loaded into one process;
- a 2 dp step of `tiny_test_config` (R50) against the one-process step on
  the whole batch, its random draws included;
- the `multihost_smoke` tool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (bridge_sources, detection_inputs, detection_targets,
                                     dn_noise, one_torch_thread, parallel_step_rank,
                                     tiny_vit_config)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.engine.train import TrainState, make_train_step
from uninext_tpu.parallel import sharding as jsharding
from uninext_tpu.parallel.mesh import create_mesh as jax_mesh
from uninext_tpu.parallel.mesh import shard_batch as jax_shard_batch
from uninext_tpu_torch.config import tiny_test_config
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine.checkpoint import CheckpointManager
from uninext_tpu_torch.engine.train import build_train_state, train_step
from uninext_tpu_torch.models import detr, vit
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.parallel import sharding
from uninext_tpu_torch.parallel.mesh import launch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DN_KEY = jax.random.PRNGKey(123)


def _random_tree(shapes, seed=0, scale=0.05):
    """Weights for a tree of these shapes from a seed, without compiling the
    init: kernels N(0, 1/fan_in), norm scales 1 + noise, the rest noise
    (`up_res3`'s bias as four equal copies)."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name.endswith("['up_res3']['bias']"):
            return np.tile(rng.randn(s.shape[0] // 4) * scale, 4).astype(np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return (base + rng.randn(*s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def vit_tree():
    """The small ViT config (2 heads; BERT with 4), its JAX model, a
    parameter tree of the training path's shapes (with mask targets, so
    that it holds the mask head the port builds) and a batch."""
    cfg = tiny_vit_config()
    inputs = detection_inputs(1)
    targets = detection_targets(2, G=cfg.data.max_insts)
    jm = jdetr.UninextDETR(cfg)
    B, H, W = inputs[0].shape[:3]
    tgt = {"boxes": targets[0], "valid": targets[1], "positive_map": targets[2],
           "masks": np.zeros((B, targets[1].shape[1], H // 4, W // 4), np.float32),
           "has_masks": True}
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dn": r}, *inputs, targets=tgt,
                                              train=True), jax.random.PRNGKey(0))
    return cfg, jm, _random_tree(shapes), inputs, targets


class _FakeMesh:
    """A model group of k ranks seen from rank `r`, with no process group:
    `shard_module` cuts without a collective."""

    def __init__(self, k, r):
        self.model_size, self.model_rank, self.model_group = k, r, None


def test_param_pspec_matches_jax(vit_tree):
    """Every ViT and BERT parameter's JAX leaf is the one the bridge fills
    it from, and its PartitionSpec is JAX's `param_pspec` of that leaf;
    the cut covers exactly the column- and row-parallel leaves."""
    cfg, _, params, _, _ = vit_tree
    sources = bridge_sources(params)
    jax_specs = {"/".join(p.key for p in path): tuple(jsharding.param_pspec(path, leaf))
                 for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"])}
    model = build_model(cfg, "cpu", seed=0)
    cut = set()
    for name, p in model.named_parameters():
        if not sharding._in_towers(name):
            assert sharding.param_pspec(sharding.jax_leaf(name), p.dim()) == ()
            continue
        leaf = sharding.jax_leaf(name)
        assert sources[name] == [leaf], name
        spec = sharding.param_pspec(leaf, p.dim())
        assert spec == jax_specs[leaf], (name, spec, jax_specs[leaf])
        if spec:
            cut.add(leaf.split("/")[-2])
    assert cut == jsharding.COLUMN_PARALLEL | jsharding.ROW_PARALLEL


def test_qkv_is_cut_by_heads(vit_tree):
    """The documented difference from JAX: rank r's qkv holds heads r*nh/k
    ... (r+1)*nh/k of q, of k and of v (JAX cuts the 3*dim outputs
    contiguously); `join` inverts `cut`; a cut model's attention and BERT
    layers hold nh / k heads and mark their rel-pos tables partial, and
    `load_jax_params` fills it from the whole JAX tree, cut."""
    nh, hd, dim, k = 4, 3, 12, 2
    w = torch.arange(3 * dim * dim, dtype=torch.float32).reshape(3 * dim, dim)
    shards = [sharding.cut(w, ("qkv",), r, k) for r in range(k)]
    for r, s in enumerate(shards):
        want = w.reshape(3, nh, hd, dim)[:, r * nh // k:(r + 1) * nh // k]
        assert torch.equal(s, want.reshape(-1, dim))
    assert torch.equal(sharding.join(shards, ("qkv",)), w)
    cfg, _, params, _, _ = vit_tree
    full = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(full, params)
    whole = dict(full.named_parameters())
    for r in range(k):
        mesh = _FakeMesh(k, r)
        model = sharding.shard_module(build_model(cfg, "cpu", seed=1), mesh)
        convert.load_jax_params(model, params, mesh=mesh)
        name = "detr.detr.backbone.0.backbone.blocks.1.attn.qkv.weight"
        got = dict(model.named_parameters())[name]
        assert torch.equal(got, sharding.cut(whole[name], ("qkv",), r, k))
        for n, p in model.named_parameters():
            assert torch.equal(p, sharding.cut_like(whole[n], p, mesh)), n
        attn = model.core.backbone[0].backbone.blocks[1].attn
        assert attn.num_heads == cfg.backbone.vit_num_heads // k
        assert attn.rel_pos_h.tp_kind == "partial" and got.tp_kind == "sharded"
        assert model.bert.encoder.layer[0].num_heads == cfg.language.num_heads // k
        assert attn.proj.reduce_group is None and attn.proj.weight.tp_cut == ("cols",)


def test_drop_path_and_dn_draws_are_rows_of_the_whole_draw():
    """Under data parallelism a rank draws the whole batch's drop-path masks
    and DN noise and keeps its rows."""
    g = torch.Generator().manual_seed(0)
    whole = vit.drop_path_masks(4, 0.3, g, "cpu")
    boxes = torch.rand(4, 6, 4, generator=torch.Generator().manual_seed(1)) * 0.5 + 0.25
    valid = torch.ones(4, 6, dtype=torch.bool)
    enc = torch.randn(4, 8)
    dn_whole = detr.prepare_dn_static(boxes, valid, enc, 1.0,
                                      generator=torch.Generator().manual_seed(2),
                                      single_pad=3, groups=2)
    for r in range(2):
        mesh = dataclasses.make_dataclass("M", ["data_size", "data_rank"])(2, r)
        g = torch.Generator().manual_seed(0)
        assert torch.equal(vit.drop_path_masks(2, 0.3, g, "cpu", mesh), whole[:, 2 * r:2 * r + 2])
        rows = slice(2 * r, 2 * r + 2)
        got = detr.prepare_dn_static(boxes[rows], valid[rows], enc[rows], 1.0,
                                     generator=torch.Generator().manual_seed(2),
                                     single_pad=3, groups=2, mesh=mesh)
        for a, b in zip(got, dn_whole):
            assert torch.equal(a, b[rows])


def _plain_flash(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0,
                 block_sizes=None, debug=False):
    attn = jnp.einsum("bhqd,bhkd->bhqk", q * sm_scale, k)
    attn = jax.nn.softmax(attn.astype(jnp.float32), -1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", attn, v)


def test_a_prime_matches_jax_tp(monkeypatch):
    """A′ on each of 2 ranks' heads, joined, against JAX's
    `flash_rel_pos_attention_tp` on a 1x2 mesh, fp32, within 1e-5; the
    gradients of q, k, v (joined over the ranks) and of Rh, Rw (summed over
    them, as `comm.sync_grads` sums the partial tables) against the port's
    one-process plain path."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa_mod
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from uninext_tpu.models.vit import flash_rel_pos_attention_tp as jax_a_prime

    monkeypatch.setattr(fa_mod, "flash_attention", _plain_flash)
    Hh, Ww, nh, hd, k = 6, 8, 4, 8, 2
    S = Hh * Ww
    rng = np.random.RandomState(0)
    q, kk, v = (rng.randn(2, Hh, Ww, nh, hd).astype(np.float32),
                rng.randn(2, S, nh, hd).astype(np.float32),
                rng.randn(2, S, nh, hd).astype(np.float32))
    Rh = rng.randn(Hh, Hh, hd).astype(np.float32)
    Rw = rng.randn(Ww, Ww, hd).astype(np.float32)
    cot = rng.randn(2, Hh, Ww, nh * hd).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    mesh = jax_mesh(2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        want = jax.jit(lambda *a: jax_a_prime(*a, scale),
                       out_shardings=NamedSharding(mesh, P()))(q, kk, v, Rh, Rw)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, kk, v, Rh, Rw)]
    outs, grads = [], []
    hs = nh // k
    for r in range(k):
        heads = slice(r * hs, (r + 1) * hs)
        ins = [t[0][..., heads, :], t[1][..., heads, :], t[2][..., heads, :], t[3], t[4]]
        out = vit.flash_rel_pos_attention_tp(*ins, scale)
        outs.append(out)
        cot_r = torch.from_numpy(cot).reshape(2, Hh, Ww, nh, hd)[..., heads, :]
        grads.append(torch.autograd.grad(out, t, cot_r.reshape(2, Hh, Ww, hs * hd)))
    got = torch.cat([o.reshape(2, Hh, Ww, hs, hd) for o in outs], 3).reshape(2, Hh, Ww, -1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    full = vit.rel_pos_attention_plain(*t, scale)
    want_g = torch.autograd.grad(full, t, torch.from_numpy(cot))
    for i, name in enumerate(("dq", "dk", "dv", "dRh", "dRw")):
        g = sum(gr[i] for gr in grads)        # zero outside each rank's heads
        np.testing.assert_allclose(g.numpy(), want_g[i].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ---- the 2 dp x 2 tp step against JAX ------------------------------------------

LEAVES = {   # port parameter -> what the comparison calls it
    "detr.detr.backbone.0.backbone.blocks.1.attn.qkv.weight": "ViT qkv (cut by heads)",
    "detr.detr.backbone.0.backbone.blocks.0.attn.proj.weight": "ViT proj (row-parallel)",
    "detr.detr.backbone.0.backbone.blocks.1.attn.rel_pos_h": "ViT rel_pos_h (partial)",
    "detr.detr.backbone.0.backbone.blocks.1.mlp.fc2.weight": "ViT mlp2 (row-parallel)",
    "text_encoder.body.model.encoder.layer.1.attention.self.query.weight": "BERT query",
    "text_encoder.body.model.encoder.layer.0.output.dense.weight": "BERT ffn_output",
    "detr.detr.transformer.decoder.layers.0.cross_attn.value_proj.weight": "DETR (replicated)",
}


@pytest.fixture(scope="module")
def tp_step(vit_tree, tmp_path_factory):
    """JAX's `make_train_step(mesh 2x2, tp=True)` and the port's 4 ranks
    (2 dp x 2 tp, gloo) on the same weights, batch and DN noise. The clip
    limit is raised so that Adam's first moment is 0.1 x the gradient, which
    gives JAX's grad norm."""
    cfg, jm, params, inputs, targets = vit_tree
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, grad_clip=1e6))
    jm = jdetr.UninextDETR(cfg)
    real = jdetr.prepare_dn_static
    mp = pytest.MonkeyPatch()
    mp.setattr(jdetr, "prepare_dn_static",
               lambda gb, gv, le, rng, bns, **kw: real(gb, gv, le, DN_KEY, bns, **kw))
    jbatch = {"images": inputs[0], "img_mask": inputs[1], "image_sizes": inputs[2],
              "text_ids": inputs[3], "text_mask": inputs[4],
              "targets": {"boxes": targets[0], "valid": targets[1],
                          "positive_map": targets[2]}}
    mesh = jax_mesh(2, devices=jax.devices()[:4])
    try:
        with jax.set_mesh(mesh):
            tx = joptim.build_optimizer(cfg.solver, params["params"])
            state = TrainState(step=jnp.zeros((), jnp.int32),
                               params=jsharding.shard_tree(params["params"], mesh),
                               opt_state=jsharding.shard_tree(tx.init(params["params"]), mesh),
                               tx=tx)
            step = make_train_step(jm, cfg, "detection", mesh=mesh, has_masks=False, tp=True)
            new_state, metrics = step(state, jax.device_put(jbatch, jax_shard_batch(mesh)),
                                      jax.random.PRNGKey(1))
            jax_params = jax.tree.map(np.asarray, new_state.params)
            jax_mu = {}
            for st in new_state.opt_state[1].inner_states.values():
                adam = st.inner_state[0] if st.inner_state else None
                if hasattr(adam, "mu"):
                    for path, leaf in jax.tree_util.tree_leaves_with_path(adam.mu):
                        jax_mu["/".join(p.key for p in path)] = np.asarray(leaf)
            jax_metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        mp.undo()
    out = tmp_path_factory.mktemp("tp_step")
    torch.save(convert.state_dict_from_jax(params), out / "whole.pt")
    t = torch.from_numpy
    batch = {"images": t(inputs[0]), "img_mask": t(inputs[1]), "image_sizes": t(inputs[2]),
             "text_ids": t(inputs[3]).long(), "text_mask": t(inputs[4]),
             "targets": {"boxes": t(targets[0]), "valid": t(targets[1]),
                         "positive_map": t(targets[2]), "has_masks": False}}
    single_pad = min(detr.DN_SINGLE_PAD, cfg.data.max_insts)
    noise = dn_noise(DN_KEY, 2, single_pad)
    ranks = launch(parallel_step_rank, 4, "gloo", "cpu", cfg, 2, str(out / "whole.pt"),
                   batch, noise, str(out / "ckpt"))
    return cfg, jax_metrics, jax_params, jax_mu, ranks, out


def _jax_leaf(params, path):
    node = params
    for key in path.split("/"):
        node = node[key]
    return node


def test_tp_step_matches_jax(tp_step, vit_tree):
    """The port's 2x2 step against JAX's: every loss and the total within
    2e-5 (JAX's own TP test holds its TP step to its DP step at rtol 2e-4),
    the grad norm within 1e-5; the ranks' layout and A′'s heads. The joined
    shards' gradients (Adam's first moment) within 2e-4 of their largest
    entry, the updated weights within 1e-6 (lr 1e-4: Adam's first step
    moves each weight by about lr)."""
    cfg, jax_metrics, jax_params, jax_mu, ranks, out = tp_step
    assert sorted(r["mesh"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(set(r["heads"].values()) == {cfg.backbone.vit_num_heads // 2} for r in ranks)
    got = ranks[0]["metrics"]
    assert all(r["metrics"] == got for r in ranks)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-6, err_msg=k)
    # the port's one ConvTranspose2d bias of `up_res3` takes the sum of the
    # gradients of JAX's four sub-pixel copies (ROADMAP §3.14)
    mus = {k: m.astype(np.float64) for k, m in jax_mu.items()}
    mus["backbone/up_res3/bias"] = mus["backbone/up_res3/bias"].reshape(4, -1).sum(0)
    want_norm = np.sqrt(sum(float((m ** 2).sum()) for m in mus.values())) / (1 - 0.9)
    ckpt = torch.load(CheckpointManager(str(out / "ckpt")).path(1), weights_only=True)
    state = build_train_state(cfg, "cpu")
    mu = {n: m for g, names in state.optimizer.names.items()
          for n, m in zip(names, ckpt["optimizer"]["mu"][g])}
    np.testing.assert_allclose(got["grad_norm"], want_norm, rtol=1e-5)
    sources = bridge_sources(vit_tree[2])
    for name, what in LEAVES.items():
        leaf, = sources[name]
        flip = (lambda x: x.T) if leaf.endswith("kernel") else (lambda x: x)
        want_mu = jax_mu[leaf]
        np.testing.assert_allclose(flip(mu[name].numpy()), want_mu, rtol=0,
                                   atol=2e-4 * np.abs(want_mu).max(), err_msg=what)
        np.testing.assert_allclose(flip(ckpt["model"][name].numpy()),
                                   _jax_leaf(jax_params, leaf), rtol=0, atol=1e-6,
                                   err_msg=what)


def test_checkpoint_from_tp_ranks_loads_into_one_process(tp_step):
    """The checkpoint the 2x2 ranks wrote holds the whole model under the
    one-process names and shapes, and restores into a one-process state
    unchanged: every parameter and both Adam moments as the file holds
    them, the step and the optimizer's count."""
    cfg, _, _, _, _, out = tp_step
    ckpt = torch.load(CheckpointManager(str(out / "ckpt")).path(1), weights_only=True)
    state = build_train_state(cfg, "cpu", seed=7)
    state, resumed = CheckpointManager(str(out / "ckpt")).restore(state)
    assert resumed and state.step == 1 and state.optimizer.count == 1
    sd = state.model.state_dict()
    assert set(sd) == set(ckpt["model"])
    for k, v in ckpt["model"].items():
        assert torch.equal(sd[k], v), k
    for g in state.optimizer.params:
        for name in ("mu", "nu"):
            for a, b in zip(getattr(state.optimizer, name)[g], ckpt["optimizer"][name][g]):
                assert torch.equal(a, b)


# ---- the 2 dp step against one process -------------------------------------------

def test_dp_step_matches_one_process(tmp_path):
    """2 dp x 1 tp of `tiny_test_config` (R50), one image a rank, against
    the one-process step on the whole batch from the same seed: the DN
    noise comes from the state's generator on both sides (each rank keeps
    its rows of the whole draw). Losses, total and grad norm within 1e-6,
    the averaged gradients (Adam's first moment) within 1e-5 of each
    leaf's largest entry (and 1e-9)."""
    cfg = tiny_test_config()
    inputs = detection_inputs(3)
    targets = detection_targets(4, G=cfg.data.max_insts)
    t = torch.from_numpy
    batch = {"images": t(inputs[0]), "img_mask": t(inputs[1]), "image_sizes": t(inputs[2]),
             "text_ids": t(inputs[3]).long(), "text_mask": t(inputs[4]),
             "targets": {"boxes": t(targets[0]), "valid": t(targets[1]),
                         "positive_map": t(targets[2]), "has_masks": False}}
    ranks = launch(parallel_step_rank, 2, "gloo", "cpu", cfg, 1, None, batch, None,
                   str(tmp_path / "ckpt"))
    state = build_train_state(cfg, "cpu", seed=0)
    want = {k: float(v) for k, v in train_step(state, batch).items()}
    for r in ranks:
        assert r["metrics"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    ckpt = torch.load(CheckpointManager(str(tmp_path / "ckpt")).path(1), weights_only=True)
    opt = state.optimizer
    for g, mus in opt.mu.items():
        for name, a, b in zip(opt.names[g], mus, ckpt["optimizer"]["mu"][g]):
            # + 1e-9: the exact gradient of a key bias is 0, its noise ~1e-12
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-5 * float(a.abs().max()) + 1e-9,
                                       err_msg=name)


def test_multihost_smoke(monkeypatch):
    """`python -m uninext_tpu_torch.tools.multihost_smoke --backend gloo
    --device cpu`: two ranks take one data-parallel step together."""
    from uninext_tpu_torch.tools import multihost_smoke
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert multihost_smoke.main(["--backend", "gloo", "--device", "cpu"]) == 0
