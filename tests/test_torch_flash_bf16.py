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
"""
import functools

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
