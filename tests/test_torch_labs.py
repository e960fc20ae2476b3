"""The port's MSDA labs (`uninext_tpu_torch/tools/`) vs the JAX tools they
port, on the CPU, with the same numpy inputs.

The JAX side runs the tools' own Pallas kernels in interpret mode
(`pl.pallas_call` wrapped to pass `interpret=True`); the port's wrappers run
their plain versions on CPU tensors, so these tests hold each plain version
to the Pallas kernel it stands for. The CUDA kernels are held to the plain
versions on the card (tests/test_torch_kernels_cuda.py).

`tools/` is no package: its modules are imported by file path, and
tools/msda_v6_lab.py sets `jax_compilation_cache_dir` when imported, so the
import restores the directory this process had.

Tolerances: every comparison is fp32 (bf16 inputs are converted exactly)
and differs only in the order of fp32 sums of at most 64 terms of size
< 10: 1e-5 absolute.
"""
import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.torch_port_common import one_torch_thread
from uninext_tpu.ops import msda as jmsda
from uninext_tpu_torch.ops import dma_gather, gather_fold
from uninext_tpu_torch.ops.msda import ms_deform_attn_plain
from uninext_tpu_torch.tools import msda_v6_lab

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CACHE_DIR = jax.config.jax_compilation_cache_dir


@pytest.fixture(scope="module")
def jax_tools():
    """tools/msda_v6_lab.py, tools/pallas_gather_probe.py and
    tools/pallas_dma_probe.py, imported by path with the compilation cache
    directory and sys.path restored."""
    saved_dir = jax.config.jax_compilation_cache_dir
    saved_path = list(sys.path)
    mods = {}
    try:
        for name in ("msda_v6_lab", "pallas_gather_probe", "pallas_dma_probe"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        sys.path[:] = saved_path
    return mods


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_tool_import_keeps_the_compilation_cache_dir(jax_tools):
    """Importing tools/msda_v6_lab.py points the cache at <repo>/.xla_cache;
    the fixture puts back the directory tests/conftest.py chose."""
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR


def _bf16_exact(a) -> torch.Tensor:
    """A JAX bf16 (or fp32) array as a torch tensor of the same values."""
    t = torch.from_numpy(np.asarray(a).astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


# ---- B: the fold and msda_v6 -------------------------------------------------

# D = 8 (ids as before) and the lab's D = 32
@pytest.mark.parametrize("dtype,Dd", [("float32", 8), ("bfloat16", 8), ("float32", 32),
                                      ("bfloat16", 32)],
                         ids=["float32", "bfloat16", "float32-32", "bfloat16-32"])
def test_fold_plain_matches_jax_fold_pallas(jax_tools, interpret, monkeypatch, dtype, Dd):
    lab = jax_tools["msda_v6_lab"]
    monkeypatch.setattr(lab, "FOLD_TN", 128)       # 2 column blocks
    LP, BMLq = 3, 256
    rng = np.random.RandomState(2)
    g = jnp.asarray(rng.randn(LP * BMLq, 4 * Dd), dtype)
    w = jnp.asarray(rng.rand(LP * BMLq, 4), dtype)
    want = lab._fold_pallas(g.T, w.T, Dd, BMLq, LP)          # (D, BMLq) f32
    got = gather_fold.msda_fold(_bf16_exact(g).view(LP, BMLq, 4 * Dd),
                                _bf16_exact(w).view(LP, BMLq, 4))
    assert got.dtype == torch.float32 and got.shape == (BMLq, Dd)
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=0, atol=TOL)


def test_msda_v6_matches_jax_msda_v6_and_plain_msda(jax_tools, interpret):
    """At the lab's parity inputs (shapes (15,20), (8,10), (4,5), (10,10),
    37 queries, RandomState(1), fp32): the port's v6 (index_select + the
    plain fold) against the JAX lab's v6 (gather + Pallas fold) and against
    the port's plain MSDA (grid_sample)."""
    lab = jax_tools["msda_v6_lab"]
    value, shapes, loc, att = msda_v6_lab.parity_inputs("cpu")
    assert (loc < 0).any() and (loc > 1).any()     # samples outside the frame
    want = jax.jit(lambda v, l, a: lab.msda_v6(v, shapes, l, a))(
        value.numpy(), loc.numpy(), att.numpy())
    got = msda_v6_lab.msda_v6(value, shapes, loc, att)
    assert got.shape == (1, 37, 8 * 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    plain = ms_deform_attn_plain(value, shapes, loc, att)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=TOL)
    assert msda_v6_lab.parity("cpu") < TOL


def test_packing_matches_jax_outside_the_frame():
    """pack_levels and indices_weights against the JAX package's
    _pack_levels and _indices_weights, with locations in [-0.6, 1.6] so
    that many samples fall outside the frame and are masked."""
    shapes = ((6, 9), (3, 5))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(4)
    value_t = rng.randn(2, 3, s, 4).astype(np.float32)            # (B, M, S, D)
    loc = (rng.rand(2, 3, 11, 2, 4, 2) * 2.2 - 0.6).astype(np.float32)
    att = rng.rand(2, 3, 11, 2, 4).astype(np.float32)
    for got, want in zip(msda_v6_lab.pack_levels(torch.from_numpy(value_t), shapes),
                         jmsda._pack_levels(jnp.asarray(value_t), shapes)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idxs, ws = msda_v6_lab.indices_weights(shapes, torch.from_numpy(loc),
                                           torch.from_numpy(att))
    jidxs, jws = jmsda._indices_weights(shapes, jnp.asarray(loc), jnp.asarray(att))
    masked = 0
    for i, w, ji, jw in zip(idxs, ws, jidxs, jws):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
        masked += int((w.sum(-1) == 0).sum())
    assert masked > 50


# ---- C0-C2: the gather probes --------------------------------------------------

SMALL = dict(R=64, TQ=8, SAMP=4, M_STEPS=2)


@pytest.mark.parametrize("probe", ["scalar_loop", "vector_gather", "onehot"])
def test_probe_plain_matches_pallas_probe(jax_tools, interpret, monkeypatch, probe):
    """Each probe's own pallas_call, shrunk through the module's globals,
    against the port's function on the probe's own inputs (captured by
    replacing the probe's timer)."""
    mod = jax_tools["pallas_gather_probe"]
    for k, v in SMALL.items():
        monkeypatch.setattr(mod, k, v)
    cap = {}

    def capture(fn, *args, iters=20):
        cap["args"], cap["out"] = args, fn(*args)   # inside the probe: its R holds
        return 1.0

    monkeypatch.setattr(mod, "honest_ms", capture)
    state = np.random.get_state()
    np.random.seed(3)
    try:
        if probe == "onehot":
            mod.probe_onehot(r=48)
        else:
            getattr(mod, f"probe_{probe}")()
    finally:
        np.random.set_state(state)
    M, TQ, SAMP = SMALL["M_STEPS"], SMALL["TQ"], SMALL["SAMP"]
    idx = torch.from_numpy(np.array(cap["args"][0])).reshape(M, TQ, SAMP)
    buf = _bf16_exact(cap["args"][-1])
    assert buf.dtype == torch.bfloat16 and idx.dtype == torch.int32
    if probe == "onehot":
        w = torch.from_numpy(np.array(cap["args"][1])).reshape(M, TQ, SAMP, 4)
        got = gather_fold.gather_weighted(buf, idx, w)
    else:
        fn = {"scalar_loop": gather_fold.gather_rowsum_scalar,
              "vector_gather": gather_fold.gather_rowsum_vec}[probe]
        got = fn(buf, idx)
    assert got.dtype == torch.float32 and got.shape == (M, TQ, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(cap["out"]), rtol=0, atol=TOL)


# ---- C3, C4: the DMA probes ------------------------------------------------------

DMA_SMALL = dict(R=64, K=4, TILES=8)


@pytest.mark.parametrize("probe", ["1", "2", "3"])
def test_dma_probe_plain_matches_pallas_probe(jax_tools, interpret, monkeypatch, probe):
    """tools/pallas_dma_probe.py's probes 1 and 2 (`probe_dma` with the
    table in HBM and in VMEM) and 3 (`probe_index_map`), their own
    pallas_call shrunk through the module's globals, against the port's C3
    and C4 on the probe's own inputs (captured by replacing its timer)."""
    mod = jax_tools["pallas_dma_probe"]
    for k, v in DMA_SMALL.items():
        monkeypatch.setattr(mod, k, v)
    cap = {}

    def capture(fn, *args, iters=10):
        cap["args"], cap["out"] = args, fn(*args)
        return 1.0

    monkeypatch.setattr(mod, "honest_ms", capture)
    state = np.random.get_state()
    np.random.seed(5)
    try:
        if probe == "3":
            mod.probe_index_map()
        else:
            space = pl.ANY if probe == "1" else mod.pltpu.VMEM
            mod.probe_dma(space, f"probe{probe}")
    finally:
        np.random.set_state(state)
    R, K, TILES = DMA_SMALL["R"], DMA_SMALL["K"], DMA_SMALL["TILES"]
    idx = torch.from_numpy(np.array(cap["args"][0]))
    buf = _bf16_exact(cap["args"][1])
    assert buf.dtype == torch.bfloat16 and buf.shape == (R, mod.D4)
    assert idx.dtype == torch.int32 and idx.shape == (TILES * K,)
    if probe == "3":
        assert int(idx.max()) < R // 8
        got = dma_gather.dma_block_gather(buf, idx)
        assert got.shape == (TILES * K * 8, mod.D4)
    else:
        got = dma_gather.dma_gather_rowsum(buf, idx, k=K)
        assert got.shape == (TILES * 8, mod.D4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(cap["out"]), rtol=0, atol=TOL)
