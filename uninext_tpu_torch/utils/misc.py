"""Small helpers shared across the model, mirroring `uninext_tpu/utils/misc.py`."""
from __future__ import annotations

import threading
from typing import Callable

import torch
import torch.utils.checkpoint


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def agg_lang_feat(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked average of language features: (B, L, C), (B, L) 1=valid ->
    (B, C)."""
    m = mask.to(features.dtype)
    return (features * m[..., None]).sum(1) / m.sum(-1, keepdim=True).clamp(
        min=1e-6)


def stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, the lower index
    first among ties, as `jax.lax.top_k` orders them (`torch.topk` makes no
    promise about ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def host_constant(values, dtype: torch.dtype, device: torch.device
                  ) -> torch.Tensor:
    """A small tensor of host values on `device`. On a GPU it is staged
    through pinned memory and copied without a stream synchronisation."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while a checkpointed function is recomputed for the backward."""
    return getattr(_RECOMPUTE, "depth", 0) > 0


def checkpointed(fn: Callable, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward. The recompute runs with `recomputing()` true, so the kernel
    wrappers can count those launches apart."""
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1
        try:
            return fn(*a)
        finally:
            _RECOMPUTE.depth -= 1

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
