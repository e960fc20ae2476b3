"""Tensor-parallel sharding of the heavy towers (ViT, BERT), mirroring
`uninext_tpu/parallel/sharding.py`: Megatron-style column- and
row-parallel linears over the mesh's model group.

The rules are JAX's, on the JAX leaf name of each port parameter
(`jax_leaf`: the module path of `engine/convert.py:jax_module_path` with
the JAX package's module and leaf names):
  column-parallel (the output features are cut): qkv, mlp1 (ViT);
      query, key, value, intermediate (BERT)
  row-parallel (the input features are cut): proj, mlp2 (ViT);
      attention output, ffn_output (BERT)
  everything else (convolutions, norms, embeddings, the DETR transformer)
  is replicated.

`shard_module` keeps each rank's shard of those `Linear`s, wires the
modules to the model group (`copy_to_model` before a column-parallel
layer, `reduce_from_model` after a row-parallel one, whose bias is added
once, after the sum) and marks every parameter with its kind for
`comm.sync_grads` and the optimizer's norm.

One cut differs from JAX's: `qkv`. Its kernel is P(None, "model") there, a
contiguous cut of the 3 * dim outputs, which at k = 2 hands rank 0 all of q
and half of k (GSPMD repairs that with collectives). Here q, k and v are
each cut by heads: rank r takes heads r * nh / k ... (r + 1) * nh / k of
each, so that A′ (`models/vit.py:flash_rel_pos_attention_tp`) needs no
collective. The sharded axis is the same.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..engine import convert
from . import comm

# module names (the parent of a kernel or bias) to cut, per direction
COLUMN_PARALLEL = {"qkv", "mlp1", "query", "key", "value", "intermediate"}
ROW_PARALLEL = {"proj", "mlp2", "output", "ffn_output"}
# only inside the heavy towers; the DETR transformer stays replicated
TP_ROOTS = {"backbone", "template_backbone", "bert"}

# the port's module names inside the towers -> the JAX package's
_JAX_NAMES = tuple((re.compile(p), r) for p, r in (
    (r"/blocks/(\d+)/", r"/block_\1/"),
    (r"/mlp/fc([12])/", r"/mlp\1/"),
    (r"^bert/encoder/layer/(\d+)/", r"bert/layer_\1/"),
    (r"/attention/self/", r"/attention/"),
    (r"/attention/output/dense/", r"/attention/output/"),
    (r"/attention/output/LayerNorm/", r"/attention_ln/"),
    (r"/intermediate/dense/", r"/intermediate/"),
    (r"/output/dense/", r"/ffn_output/"),
    (r"/output/LayerNorm/", r"/output_ln/"),
    (r"^bert/embeddings/LayerNorm/", r"bert/embeddings_ln/"),
    (r"^bert/embeddings/(\w+)/weight$", r"bert/\1/embedding"),
    (r"/patch_embed/proj/", r"/patch_embed/"),
    (r"/fpn1/0/", r"/up_res3/"),
))
_NORMS = re.compile(r"/(norm[12]|attention_ln|output_ln|embeddings_ln)/weight$")


def jax_leaf(port_key: str) -> str:
    """The JAX leaf of a port parameter in the towers, e.g.
    `backbone/block_3/attn/qkv/kernel` for
    `detr.detr.backbone.0.backbone.blocks.3.attn.qkv.weight`; outside them
    `convert.jax_module_path` (whose leaf names are the port's)."""
    path = convert.jax_module_path(port_key)
    if path.split("/")[0] not in TP_ROOTS:
        return path
    for pattern, repl in _JAX_NAMES:
        path = pattern.sub(repl, path)
    path = _NORMS.sub(r"/\1/scale", path)
    return re.sub(r"/weight$", "/kernel", path)


def param_pspec(path: str, ndim: int) -> Tuple:
    """The PartitionSpec of a JAX leaf (`path` "a/b/c", its rank), as
    `param_pspec` there: (None, "model") for a column-parallel kernel,
    ("model",) for its bias, ("model", None) for a row-parallel kernel, ()
    for anything replicated."""
    names = path.split("/")
    if not any(n in TP_ROOTS for n in names) or len(names) < 2:
        return ()
    parent, leaf = names[-2], names[-1]
    if parent in COLUMN_PARALLEL:
        if leaf == "kernel" and ndim == 2:
            return (None, "model")
        if leaf == "bias" and ndim == 1:
            return ("model",)
    if parent in ROW_PARALLEL and leaf == "kernel" and ndim == 2:
        return ("model", None)
    return ()


def _in_towers(port_key: str) -> bool:
    try:
        return convert.jax_module_path(port_key).split("/")[0] in TP_ROOTS
    except KeyError:
        return False


def _cut_of(name: str, p: torch.Tensor) -> Optional[Tuple]:
    """How a port parameter is cut: ("rows",) or ("cols",) of the torch
    weight (out, in), ("rows",) of a bias, ("qkv",) for a ViT qkv (q, k and
    v each cut by rows, that is by heads), None when replicated."""
    path = jax_leaf(name)
    spec = param_pspec(path, p.dim())
    if not spec:
        return None
    if path.split("/")[-2] == "qkv":
        return ("qkv",)
    return ("rows",) if spec[-1] == "model" else ("cols",)


def cut(full: torch.Tensor, how: Tuple, rank: int, k: int) -> torch.Tensor:
    """Rank `rank`'s shard of a whole parameter (or Adam moment) of `k`."""
    if how[0] == "cols":
        n = full.shape[1] // k
        return full[:, rank * n:(rank + 1) * n]
    if how[0] == "rows":
        n = full.shape[0] // k
        return full[rank * n:(rank + 1) * n]
    q, kk, v = full.chunk(3, 0)
    return torch.cat([cut(t, ("rows",), rank, k) for t in (q, kk, v)], 0)


def join(shards, how: Tuple) -> torch.Tensor:
    """The whole parameter from the k shards, in rank order (the inverse of
    `cut`)."""
    if how[0] == "cols":
        return torch.cat(shards, 1)
    if how[0] == "rows":
        return torch.cat(shards, 0)
    pieces = [s.chunk(3, 0) for s in shards]
    return torch.cat([torch.cat([p[j] for p in pieces], 0) for j in range(3)], 0)


@torch.no_grad()
def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Cut `model`'s towers over `mesh`'s model group in place (every rank
    must hold the same whole weights) and mark every parameter's kind
    (`tp_kind`: "sharded", "replicated" or "partial") and cut (`tp_cut`).
    Each tower module with a `model_group` attribute (the ViT's attention
    and MLP, a BERT layer) gets the group, and those with heads take nh / k
    of them, which must divide (as JAX requires); each row-parallel
    `Linear` gets the group as its `reduce_group`."""
    k = mesh.model_size
    for p in model.parameters():
        p.tp_kind, p.tp_cut = "replicated", None
    if k == 1:
        return model
    towers = [(n, m) for n, m in model.named_modules() if n and _in_towers(n + ".x")]
    for name, mod in towers:
        if hasattr(mod, "model_group") and getattr(mod, "num_heads", k) % k:
            raise ValueError(f"{name}: {mod.num_heads} heads do not split over "
                             f"{k} model ranks")
    for name, p in model.named_parameters():
        how = _cut_of(name, p)
        if how is not None:
            p.data = cut(p.data, how, mesh.model_rank, k).contiguous()
            p.tp_kind, p.tp_cut = "sharded", how
    for name, mod in towers:
        if hasattr(mod, "model_group"):
            mod.model_group = mesh.model_group
            if hasattr(mod, "num_heads"):
                mod.num_heads //= k
            for table in ("rel_pos_h", "rel_pos_w"):
                if hasattr(mod, table):
                    getattr(mod, table).tp_kind = "partial"
        if isinstance(mod, nn.Linear) and mod.weight.tp_cut == ("cols",):
            mod.reduce_group = mesh.model_group
    return model


def whole(t: torch.Tensor, p: torch.nn.Parameter, mesh) -> torch.Tensor:
    """A tensor laid out as parameter `p`'s shard (the parameter, its Adam
    moment), joined over the model group; `t` where `p` is not cut."""
    how = getattr(p, "tp_cut", None)
    if how is None or mesh is None:
        return t
    return join(comm.all_gather(t, mesh.model_group, mesh.model_size), how)


def whole_state_dict(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every shard joined into its whole
    parameter over the model group (a collective: every rank of the mesh
    calls it), so the result does not depend on k."""
    params = dict(model.named_parameters())
    return {k: whole(v, params[k], mesh) if k in params else v
            for k, v in model.state_dict().items()}


def cut_like(t: torch.Tensor, p: torch.nn.Parameter, mesh) -> torch.Tensor:
    """This rank's shard, laid out as `p`, of a whole tensor `t`."""
    how = getattr(p, "tp_cut", None)
    if how is None or mesh is None:
        return t
    return cut(t, how, mesh.model_rank, mesh.model_size)


def cut_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to `model`'s shards (the inverse of
    `whole_state_dict`)."""
    params = dict(model.named_parameters())
    return {k: cut_like(v, params[k], mesh) if k in params else v for k, v in sd.items()}
