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
here). The ResNet's stem, res2 and every FrozenBN mean and var form the
"frozen" group, which never moves; they keep their gradients all the same,
and those enter the global norm of the clip, as the JAX package
differentiates them too. The FrozenBN scale and bias of res3-res5 fall in
the backbone group and train, as in the JAX package. Adam's eps sits outside the square root. The clip is optax's: the
gradients are scaled by grad_clip / norm when the global norm is at least
grad_clip, with nothing added to the norm (`clip_grad_norm_` adds 1e-6).
The norm is summed in fp64, so that it stays finite where optax's fp32 sum
of squares overflows (a gradient above ~1.8e19: ConvNeXt from scratch on
zero-padded images, ROADMAP §3.29); below that the two agree to rounding.
Updates run as `torch._foreach_*` ops per group, in place.

With `grad_accum_steps` k > 1 the optimizer follows `optax.MultiSteps`:
`step()` is called after every micro-step's backward, the gradients sum
in the parameters' `.grad` (the caller zeroes them only after an update,
`accumulating`), and every k-th call divides them by k, so the update sees
their mean, then clips and applies AdamW once. Adam's count and the
schedule advance once per update. `adam_mu_dtype` "bfloat16" keeps the
first moment in bf16, as optax's `mu_dtype`: each update forms the new
moment in fp32 from the stored one, uses it, and stores it rounded; the
stored moment decays by b1 rounded to bf16 (0.8984375), as JAX computes it
(the Python constant takes the moment's dtype).

Over a mesh (`parallel/mesh.py`) each update first averages the
gradients over it (`parallel/comm.py:sync_grads`), so that they are the
gradient of the whole batch's loss, and the clip's norm counts every
parameter once: the squared norms of the tensor-parallel shards are summed
over the model group, the replicated parameters' taken once. The moments
live on the shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import SolverConfig
from ..parallel import comm
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
                 path_of: Callable[[str], str] = convert.jax_module_path,
                 mesh=None):
        """`path_of` maps a parameter name to the JAX path its group is
        classified by (the bridge's mapping for `UninextDETR`); `mesh` the
        ranks the gradients are averaged over (None: one process)."""
        self.mesh = mesh
        if cfg.adam_mu_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(f"adam_mu_dtype {cfg.adam_mu_dtype!r}")
        self.cfg = cfg
        self.accum = max(1, cfg.grad_accum_steps)
        self.mini_step = 0                      # micro-steps since the last update
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lr = group_learning_rates(cfg)
        self.schedule = lr_schedule(cfg)
        self.params: Dict[str, List[torch.nn.Parameter]] = {}
        self.names: Dict[str, List[str]] = {}
        for name, p in named_params:
            g = classify_param(path_of(name))
            self.params.setdefault(g, []).append(p)
            self.names.setdefault(g, []).append(name)
        mu_dtype = torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else None
        self.mu = {g: [torch.zeros_like(p, dtype=mu_dtype) for p in ps]
                   for g, ps in self.params.items()}
        self.nu = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()}
        self.count = 0

    @property
    def accumulating(self) -> bool:
        """True between the micro-steps of one update: the next backward
        adds to `.grad` instead of replacing it."""
        return self.mini_step > 0

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """One micro-step: None until the k-th, which updates the parameters
        and returns the global norm of the mean gradient before the clip."""
        self.mini_step += 1
        if self.mini_step < self.accum:
            return None
        self.mini_step = 0
        all_params = [p for ps in self.params.values() for p in ps]
        comm.sync_grads(all_params, self.mesh)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in all_params]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        # in fp64: a gradient above ~1.8e19 overflows optax's fp32 norm to inf
        # (its clip then zeroes the step; ROADMAP §3.29)
        norms = torch._foreach_norm(grads, 2.0, dtype=torch.float64)
        group = None if self.mesh is None else self.mesh.model_group
        if group is None:
            norm = torch.linalg.vector_norm(torch.stack(norms)).float()
        else:
            cut = [getattr(p, "tp_kind", "") == "sharded" for p in all_params]
            sq = lambda ns: torch.stack(ns).square().sum()
            norm = (comm.all_reduce(sq([n for n, c in zip(norms, cut) if c]), group)
                    + sq([n for n, c in zip(norms, cut) if not c])).sqrt().float()
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
            stored = None
            if mu[0].dtype != ps[0].dtype:
                # a low-precision first moment, as JAX computes optax's: b1 is
                # rounded to that dtype (0.8984375 in bf16), the new moment
                # is formed in fp32
                stored = mu
                mu = [m.to(p.dtype) for m, p in zip(stored, ps)]
                torch._foreach_mul_(mu, float(torch.tensor(self.b1, dtype=stored[0].dtype)))
            else:
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
            if stored is not None:
                torch._foreach_copy_(stored, mu)
        return norm


def build_optimizer(model: torch.nn.Module, cfg: SolverConfig, mesh=None) -> AdamW:
    return AdamW(model.named_parameters(), cfg, mesh=mesh)
