"""The collectives of the port's data and tensor parallelism. In the JAX
package GSPMD inserts them from sharding annotations, so it has no such
module; here each is called where it belongs, over an explicit group
(never the default group), and skipped where the group is None (size 1).

- `copy_to_model` / `reduce_from_model`: Megatron's pair around a
  column-parallel layer and after a row-parallel one. The first is the
  identity forward and an all-reduce of the gradient backward; the second
  an all-reduce forward and the identity backward.
- `sync_grads`: the gradients of a step over the mesh. Those of sharded
  parameters are averaged over the data group; those of replicated ones
  over every rank, which averages the data ranks and makes the model
  ranks' copies equal (their gradients differ only by the rounding of
  nondeterministic reductions); `partial` ones (replicated, but each
  model rank's gradient covers only its heads: the ViT's rel-pos tables)
  are summed over the model group and averaged over the data group.
- `global_count`: a loss normaliser over the data group.
- `all_gather`: a tensor's pieces from every rank of a group, for
  checkpoints and logs.

Reductions of bf16 or fp16 tensors run in fp32.
"""
from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

_BUCKET_BYTES = 256 << 20


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group` (a new tensor; `t` itself where the group is
    None); low-precision tensors are summed in fp32 and cast back."""
    if group is None:
        return t
    buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column-parallel layer: x as it is; its gradient summed over
    the model group (each rank's covers only its shard's outputs)."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """After a row-parallel layer: the partial outputs summed over the model
    group; the gradient passes as it is."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


@torch.no_grad()
def _reduce_flat(tensors: List[torch.Tensor], group, scale: float) -> None:
    """All-reduce `tensors` in place over `group`, flattened in buckets of
    at most 256 MiB, then scale them by `scale`."""
    if not tensors:
        return
    if group is not None:
        buckets, size = [[]], 0
        for t in tensors:
            nbytes = t.numel() * 4
            if buckets[-1] and size + nbytes > _BUCKET_BYTES:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1).float() for t in bucket])
            dist.all_reduce(flat, group=group)
            for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(piece.view_as(t))
    if scale != 1.0:
        torch._foreach_mul_(tensors, scale)


def sync_grads(params: Iterable[torch.nn.Parameter], mesh) -> None:
    """Average the parameters' `.grad` over the mesh (the module docstring
    says how each kind of parameter is reduced). Parameters without a
    gradient are skipped; they are the same on every rank."""
    if mesh is None or mesh.size == 1:
        return
    kinds = {"sharded": [], "replicated": [], "partial": []}
    for p in params:
        if p.grad is not None:
            kinds[getattr(p, "tp_kind", "replicated")].append(p.grad)
    _reduce_flat(kinds["sharded"], mesh.data_group, 1.0 / mesh.data_size)
    _reduce_flat(kinds["replicated"], mesh.group, 1.0 / mesh.size)
    _reduce_flat(kinds["partial"], mesh.group, 1.0 / mesh.data_size)


def global_count(count: torch.Tensor, mesh) -> torch.Tensor:
    """A loss normaliser: `count` (a count of this rank's rows, no
    gradient) summed over the data group, at least 1, divided by the data
    group's size. Each rank's loss, a sum over its rows over this, is then
    the data group's size times its share of the whole batch's loss, and
    the mean over the data group (that of the gradients too) is the whole
    batch's loss, as the reference all-reduces `num_boxes`."""
    count = count.detach().float()
    if mesh is None or mesh.data_group is None:
        return count.clamp(min=1.0)
    return all_reduce(count, mesh.data_group).clamp(min=1.0) / mesh.data_size


def all_gather(t: torch.Tensor, group, world: int) -> List[torch.Tensor]:
    """Every rank's `t` (all the same shape) over `group` of `world` ranks,
    in group order; [t] where the group is None."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def mean_over_data(values: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """0-d tensors (a step's losses) averaged over the data group, in one
    reduction."""
    if mesh is None or mesh.data_group is None or not values:
        return values
    flat = all_reduce(torch.stack([v.detach().float() for v in values]), mesh.data_group)
    return list((flat / mesh.data_size).unbind())
