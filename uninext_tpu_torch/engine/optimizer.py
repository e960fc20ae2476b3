"""AdamW with the reference's per-group learning rates, mirroring
`uninext_tpu/engine/optimizer.py` (an optax chain there):

    clip_by_global_norm(grad_clip) ->
    per group: scale_by_adam(0.9, 0.999, eps=1e-8) -> add_decayed_weights(wd)
               -> scale_by_schedule(-lr_group * schedule(step))

Groups (`classify_param`) key on the JAX parameter path, which the weight
bridge gives for every port parameter (`engine/convert.py:jax_module_path`):
backbone x backbone_multiplier, `sampling_offsets` x linear_proj_multiplier,
BERT at lang_lr, VL fusion at vl_lr, everything else at base_lr. As in the
JAX code, `reference_points` falls in the base group and weight decay
applies to every parameter (optax's `add_decayed_weights` has no mask
here). Adam's eps sits outside the square root. The clip is optax's: the
gradients are scaled by grad_clip / norm when the global norm is at least
grad_clip, with nothing added to the norm (`clip_grad_norm_` adds 1e-6).
Updates run as `torch._foreach_*` ops per group, in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..config import SolverConfig
from . import convert


def classify_param(path: str) -> str:
    """Learning-rate group of a JAX parameter path ("a/b/c")."""
    if "backbone" in path:
        if any(k in path for k in ("/mean", "/var")) or \
           "/stem" in path or "res2_block" in path:
            return "frozen"
        return "backbone"
    if "bert" in path:
        return "lang"
    if "vl_layer" in path:
        return "vl"
    if "sampling_offsets" in path:
        return "linear_proj"
    return "base"


def lr_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """WarmupMultiStepLR factor at an update count, in fp32 as the JAX
    schedule computes it (the JAX package's optimizer and trainer use only
    this kind)."""
    f32 = np.float32

    def fn(step: int) -> float:
        warm = min(f32(step) / f32(max(cfg.warmup_iters, 1)), f32(1.0))
        warm = f32(cfg.warmup_factor) * (f32(1) - warm) + warm
        decay = f32(1.0)
        for m in cfg.steps:
            decay = decay * (f32(cfg.gamma) if step >= m else f32(1.0))
        return float(f32(warm * decay))

    return fn


def group_learning_rates(cfg: SolverConfig) -> Dict[str, float]:
    return {"base": cfg.base_lr,
            "backbone": cfg.base_lr * cfg.backbone_multiplier,
            "linear_proj": cfg.base_lr * cfg.linear_proj_multiplier,
            "lang": cfg.lang_lr,
            "vl": cfg.vl_lr,
            "frozen": 0.0}


class AdamW:
    """The optimizer of `build_optimizer`. `step()` clips the parameters'
    `.grad` in place, updates the parameters and returns the global grad
    norm before the clip (a 0-d tensor)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: SolverConfig, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 path_of: Callable[[str], str] = convert.jax_module_path):
        """`path_of` maps a parameter name to the JAX path its group is
        classified by (the bridge's mapping for `UninextDETR`)."""
        if cfg.grad_accum_steps != 1 or cfg.adam_mu_dtype is not None:
            raise NotImplementedError("gradient accumulation and a low-precision "
                                      "first moment are not ported yet")
        self.cfg = cfg
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lr = group_learning_rates(cfg)
        self.schedule = lr_schedule(cfg)
        self.params: Dict[str, List[torch.nn.Parameter]] = {}
        self.names: Dict[str, List[str]] = {}
        for name, p in named_params:
            g = classify_param(path_of(name))
            self.params.setdefault(g, []).append(p)
            self.names.setdefault(g, []).append(name)
        self.mu = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
        self.nu = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        all_params = [p for ps in self.params.values() for p in ps]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in all_params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2.0))).float()
        # optax's select, on the device: below the limit g / 1 * 1 == g exactly
        keep = norm < self.cfg.grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(
            keep, one, torch.full_like(norm, self.cfg.grad_clip)))
        by_param = dict(zip(map(id, all_params), grads))
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        sched = self.schedule(self.count - 1)
        for g, ps in self.params.items():
            lr = self.lr[g]
            if lr == 0.0:
                continue
            gs = [by_param[id(p)] for p in ps]
            mu, nu = self.mu[g], self.nu[g]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                       1 - self.b2))
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, torch._foreach_mul(ps, self.cfg.weight_decay))
            torch._foreach_mul_(upd, float(f32(-lr) * f32(sched)))
            torch._foreach_add_(ps, upd)
        return norm


def build_optimizer(model: torch.nn.Module, cfg: SolverConfig) -> AdamW:
    return AdamW(model.named_parameters(), cfg)
