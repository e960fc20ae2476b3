"""Kernel A's function in bf16: the port's `flash_rel_pos_attention` (on
CPU tensors, its plain version) against the JAX package's own
`flash_rel_pos_attention` (uninext_tpu/models/vit.py:131), whose stock
Pallas TPU flash kernel runs here in interpret mode (`pl.pallas_call`
wrapped to pass `interpret=True`; nothing in the JAX package changes).

Both read the same bf16 inputs, made with numpy. They round in different
places: the JAX side rounds q * scale, the bias rows and the probabilities
to bf16 before its products; the port computes in fp32 and rounds its
output once (the card's tensor-core kernel also rounds the probabilities,
and is held to the plain version in tests/test_torch_kernels_cuda.py). So
the criterion is the JAX package's own bf16 error: the port's largest
distance from the JAX function in fp32 is at most 1.5x that of JAX bf16,
and the port is within 2 bf16 steps of JAX bf16 at the output's largest
magnitude (element by element the outputs near 0 differ by far more steps
of their own size, since both errors come from the logits).

Shapes: a 14 x 14 window at ViT-H's hd 80, and a ragged 9 x 11 grid
(S = 99, which the JAX side pads to 256 keys) at hd 16.

The gradients (kernel A-bwd's function) are held the same way against
`jax.grad` of the same JAX function, which there runs the stock Pallas
backward kernels (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`)
in interpret mode: all five of dq, dk, dv, dRh, dRw, in fp32 elementwise
and in bf16 by their distance from JAX fp32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from uninext_tpu.models import vit as jvit
from uninext_tpu_torch.models import vit


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, H, W, nh, hd):
    """q (B, H, W, nh, hd), k, v (B, S, nh, hd), Rh (H, H, hd), Rw (W, W,
    hd), fp32 values that bf16 holds exactly."""
    rng = np.random.RandomState(H * W + hd)
    S = H * W
    arrays = (rng.randn(B, H, W, nh, hd), rng.randn(B, S, nh, hd),
              rng.randn(B, S, nh, hd), 0.1 * rng.randn(H, H, hd),
              0.1 * rng.randn(W, W, hd))
    return [torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
            for a in arrays]


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("B,H,W,nh,hd", [(2, 14, 14, 2, 80), (1, 9, 11, 2, 16)])
def test_rel_pos_attention_bf16_matches_pallas_flash(interpret, B, H, W, nh, hd):
    arrays = _inputs(B, H, W, nh, hd)
    scale = hd ** -0.5
    j32 = np.asarray(jvit.flash_rel_pos_attention(
        *(jnp.asarray(a) for a in arrays), scale))
    j16 = np.asarray(jvit.flash_rel_pos_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), scale).astype(jnp.float32))
    got = vit.flash_rel_pos_attention(
        *(torch.from_numpy(a).bfloat16() for a in arrays), scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, nh * hd)
    port = got.float().numpy()
    assert np.isfinite(j16).all() and np.isfinite(port).all()
    jax_err = np.abs(j16 - j32).max()
    port_err = np.abs(port - j32).max()
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)
    step = _bf16_step(np.abs(j16).max())
    assert np.abs(port - j16).max() <= 2 * step, (np.abs(port - j16).max(), step)


@pytest.mark.parametrize("B,H,W,nh,hd", [(2, 14, 14, 2, 80), (1, 9, 11, 2, 16)])
def test_rel_pos_attention_grads_match_pallas_flash(interpret, B, H, W, nh, hd):
    """dq, dk, dv, dRh, dRw of the port's plain version (autograd) against
    `jax.grad` through the stock Pallas backward, for one output cotangent.
    fp32: within 1e-5 of each gradient's largest entry (fp32 sums over at
    most 196 keys in other orders; about 7e-7 seen). bf16: the port's
    largest distance from JAX fp32 is at most 1.5x that of JAX bf16, per
    gradient (the JAX side rounds q * scale, the bias rows, P and dS to
    bf16; the port rounds its gradients once)."""
    arrays = _inputs(B, H, W, nh, hd)
    rng = np.random.RandomState(H * W + hd + 1)
    cot = torch.from_numpy(rng.randn(B, H, W, nh * hd).astype(np.float32))
    cot = cot.bfloat16().float().numpy()
    scale = hd ** -0.5

    def jax_grads(dtype):
        def loss(*xs):
            out = jvit.flash_rel_pos_attention(*xs, scale)
            return (out.astype(jnp.float32) * cot).sum()
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a, dtype) for a in arrays))
        return [np.asarray(g.astype(jnp.float32)) for g in grads]

    def port_grads(dtype):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
        out = vit.flash_rel_pos_attention(*ts, scale)
        grads = torch.autograd.grad(out, ts, torch.from_numpy(cot).to(dtype))
        assert all(g.dtype == dtype for g in grads)
        return [g.float().numpy() for g in grads]

    j32, j16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    p32, p16 = port_grads(torch.float32), port_grads(torch.bfloat16)
    for name, a, b, c, d in zip(("dq", "dk", "dv", "dRh", "dRw"), j32, j16, p32, p16):
        assert np.isfinite(b).all() and np.isfinite(d).all(), name
        np.testing.assert_allclose(c, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=name)
        jax_err = np.abs(b - a).max()
        port_err = np.abs(d - a).max()
        assert port_err <= 1.5 * jax_err, (name, port_err, jax_err)
