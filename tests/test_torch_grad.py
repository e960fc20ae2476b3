"""Gradients of the plain versions of kernel A and MSDA against the JAX
package, on the CPU, fp32.

On the card the port's gradients come from kernels A-bwd and MSDA-bwd, which
tests/test_torch_kernels_cuda.py holds to autograd through these plain
versions; here the plain versions' autograd is held to JAX: for MSDA,
`jax.grad` of `ms_deform_attn` through its hand-written VJP
(`_msda_packed_bwd`) and of the unpacked formulation's AD; for the rel-pos
attention, `jax.grad` of `vit.Attention`'s XLA path (`use_flash=False`, the
JAX package's path on a CPU) against the port's `Attention`, parameters
included.
"""
import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import TINY_LEVELS, msda_locations, one_torch_thread, perturb
from uninext_tpu.models import vit as jvit
from uninext_tpu.ops import msda as jmsda
from uninext_tpu_torch.models import vit
from uninext_tpu_torch.ops import msda

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SHAPES = ((6, 7), (3, 4), (2, 2))


def _np(x):
    return x.detach().cpu().numpy()


_JAX_MSDA = ("ms_deform_attn", "ms_deform_attn_unpacked")


@pytest.mark.parametrize("jax_fn,geometry", [
    *(pytest.param(fn, "uniform", id=fn) for fn in _JAX_MSDA),
    *(pytest.param(fn, geo, id=f"{fn}-{geo}") for geo in ("clustered", "tiny")
      for fn in _JAX_MSDA)])
def test_msda_plain_grads_match_jax(jax_fn, geometry):
    """Uniform locations, samples clustered in 2 x 2 pixels (also across the
    frame's edge), and levels of 1x1 and 1x2 with odd widths. The new
    geometries keep every location 1e-3 px off a pixel centre, where the
    gradient w.r.t. the location has a kink: grid_sample rescales through
    [-1, 1] and may land on either side of it."""
    rng = np.random.RandomState(31)
    B, Lq, M, D, P = 2, 11, 2, 8, 3
    shapes = TINY_LEVELS if geometry == "tiny" else SHAPES
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    if geometry == "uniform":
        # about a fifth of the samples fall outside [0, 1]: zero-padding path
        loc = rng.uniform(-0.15, 1.15, (B, Lq, M, L, P, 2)).astype(np.float32)
    else:
        loc = msda_locations(rng, shapes, B, Lq, M, P, geometry, margin=1e-3)
    att = rng.rand(B, Lq, M, L, P).astype(np.float32)
    cot = rng.randn(B, Lq, M * D).astype(np.float32)

    def jloss(v, lo, a):
        return (getattr(jmsda, jax_fn)(v, shapes, lo, a) * cot).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(value, loc, att)
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, loc, att)]
    (msda.ms_deform_attn(ts[0], shapes, ts[1], ts[2]) * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("dvalue", "dloc", "datt"), ts, want):
        # fp32 sums of a few bilinear terms; dloc carries the factors W_l, H_l
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("H,W,span", [(5, 7, 8), (4, 4, 4), (3, 6, 5)])
def test_rel_pos_attention_grads_match_jax_xla_path(H, W, span):
    """Input and parameter gradients of the port's `Attention` (autograd
    through `rel_pos_attention_plain`) vs `jax.grad` of JAX `Attention`
    with `use_flash=False`. 5 x 7 shrinks the span-15 tables; 4 x 4 uses
    them as stored; 3 x 6 shrinks one and grows the other."""
    rng = np.random.RandomState(H * W)
    x = rng.randn(2, H, W, 32).astype(np.float32)
    cot = rng.randn(2, H, W, 32).astype(np.float32)
    jm = jvit.Attention(32, 2, rel_pos_size=span, use_flash=False)
    params = perturb(jm.init(jax.random.PRNGKey(3), x), scale=0.2)

    def jloss(p, x_):
        return (jm.apply(p, x_) * cot).sum()

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, x)
    p = params["params"]
    tm = vit.Attention(32, 2, rel_pos_size=span)
    tm.load_state_dict({
        "qkv.weight": torch.from_numpy(np.asarray(p["qkv"]["kernel"]).T.copy()),
        "qkv.bias": torch.from_numpy(np.asarray(p["qkv"]["bias"])),
        "proj.weight": torch.from_numpy(np.asarray(p["proj"]["kernel"]).T.copy()),
        "proj.bias": torch.from_numpy(np.asarray(p["proj"]["bias"])),
        "rel_pos_h": torch.from_numpy(np.asarray(p["rel_pos_h"])),
        "rel_pos_w": torch.from_numpy(np.asarray(p["rel_pos_w"]))})
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt) * torch.from_numpy(cot)).sum().backward()
    g = gp["params"]
    got_want = [("x", xt.grad, gx),
                ("qkv.weight", tm.qkv.weight.grad.T, g["qkv"]["kernel"]),
                ("qkv.bias", tm.qkv.bias.grad, g["qkv"]["bias"]),
                ("proj.weight", tm.proj.weight.grad.T, g["proj"]["kernel"]),
                ("proj.bias", tm.proj.bias.grad, g["proj"]["bias"]),
                ("rel_pos_h", tm.rel_pos_h.grad, g["rel_pos_h"]),
                ("rel_pos_w", tm.rel_pos_w.grad, g["rel_pos_w"])]
    for name, got, want in got_want:
        want = np.asarray(want)
        # fp32 attention over <= 35 keys: summation order, relative to the
        # leaf's largest entry
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


def test_wrappers_differentiate_through_plain_on_cpu():
    """On CPU tensors the wrappers are the plain versions, so autograd goes
    through them and no kernel (forward or backward) counts a launch."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(2, 3, 4, 2, 8).astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.randn(2, 12, 2, 8).astype(np.float32)) for _ in range(2))
    Rh = torch.from_numpy(rng.randn(3, 3, 8).astype(np.float32))
    Rw = torch.from_numpy(rng.randn(4, 4, 8).astype(np.float32))
    out = vit.flash_rel_pos_attention(q, k, v, Rh, Rw, 0.3)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert vit.flash_rel_pos_attention.launches == 0
    assert vit.rel_pos_flash_attn_bwd.launches == 0
    assert msda.ms_deform_attn_bwd.launches == 0
