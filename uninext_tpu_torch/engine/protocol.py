"""Eval-protocol adaptation, mirroring `uninext_tpu/engine/protocol.py`:
serve a trained checkpoint under a cheaper protocol without retraining.

The reference's eval-time protocol is configuration, not architecture:

  * query count: two-stage top-k proposal selection (NUM_OBJECT_QUERIES,
    reference uninext/config.py:160). The joint models ship 900, the
    reference's single-task detection config 300. The content queries are
    a learned (Q, C) table (`transformer.tgt_embed.weight`); serving the
    top Q' proposals uses its first Q' rows (slot i holds proposal rank i).
  * sampling points: DEC_N_POINTS / ENC_N_POINTS (uninext/config.py
    :163-164). The offset and weight projections lay their outputs out as
    (heads, levels, points, per); keeping the first P' points keeps those
    rows of the projections, and the attention softmax renormalises over
    the remaining (levels x points) slots.
  * eval resolution: MIN_SIZE_TEST, no parameter surgery at all.

The projections are `nn.Linear`: weight (out, in), so the points axis is in
dim 0 of the weight, (M, L, P, per, in), and of the bias, (M, L, P, per).
The decoder divides its offsets by P when its reference points are boxes
(`models/layers.py:MSDeformAttn`), so a decoder cut to P' also spreads the
kept points by P / P': the JAX package's and the reference's semantics.

`adapt_params` cuts a state dict (or a module's) and returns it with the
config it serves; `adapted_model` builds that model on a device.
`tools/frontier_sweep.py` maps the accuracy <-> speed frontier with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..config import UninextConfig

TGT_EMBED = "transformer.tgt_embed.weight"
_PROJECTIONS = (("sampling_offsets", 2), ("attention_weights", 1))


def _slice_msda(sd: Dict[str, torch.Tensor], prefix: str, n_heads: int, n_levels: int,
                p_old: int, p_new: int) -> None:
    """Cut the offset and weight projections of the MSDA module at `prefix`
    (its state-dict keys' prefix, ending in ".", or "" for a bare module)
    in `sd` to the first `p_new` of `p_old` points, as new tensors."""
    for name, per in _PROJECTIONS:
        for leaf in ("weight", "bias"):
            key = f"{prefix}{name}.{leaf}"
            w = sd[key]
            full = n_heads * n_levels * p_old * per
            assert w.shape[0] == full, (key, tuple(w.shape), full)
            rest = tuple(w.shape[1:])
            w = w.reshape(n_heads, n_levels, p_old, per, *rest)[:, :, :p_new]
            sd[key] = w.reshape(n_heads * n_levels * p_new * per, *rest).clone()


def _walk_msda(sd: Dict[str, torch.Tensor], n_heads: int, n_levels: int, p_old: int,
               p_new: int, keys: Tuple[str, ...]) -> int:
    """Cut every MSDA module whose attribute name is in `keys` (the encoder
    layers' "self_attn", the decoder layers' "cross_attn"), wherever it
    sits in the model. Returns the number of modules cut."""
    suffix = ".sampling_offsets.weight"
    prefixes = [k[:-len(suffix) + 1] for k in sd if k.endswith(suffix)
                and k[:-len(suffix)].rsplit(".", 1)[-1] in keys]
    for prefix in prefixes:
        _slice_msda(sd, prefix, n_heads, n_levels, p_old, p_new)
    return len(prefixes)


def adapt_params(state: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: UninextConfig,
                 num_queries: Optional[int] = None, dec_n_points: Optional[int] = None,
                 enc_n_points: Optional[int] = None
                 ) -> Tuple[Dict[str, torch.Tensor], UninextConfig]:
    """Return (state dict, config) serving the protocol (`num_queries`,
    `dec_n_points`, `enc_n_points`; None keeps the trained value). `state`
    is a model or its state dict; it is not changed: the cut tensors are
    new, the others are the input's. Serves only fewer queries than trained
    and 1 <= P' < P points."""
    t = cfg.transformer
    new_t = t
    sd = dict(state.state_dict() if isinstance(state, nn.Module) else state)

    if num_queries is not None and num_queries != t.num_queries:
        assert num_queries <= t.num_queries, (
            f"can only serve fewer queries than trained "
            f"({num_queries} > {t.num_queries})")
        keys = [k for k in sd if k == TGT_EMBED or k.endswith("." + TGT_EMBED)]
        assert len(keys) == 1, keys
        sd[keys[0]] = sd[keys[0]][:num_queries].clone()
        new_t = dataclasses.replace(new_t, num_queries=num_queries)

    if enc_n_points is not None and enc_n_points != t.enc_n_points:
        assert 1 <= enc_n_points < t.enc_n_points
        # the decoder's self_attn is plain attention (no sampling_offsets),
        # so only the encoder layers match
        n = _walk_msda(sd, t.nheads, t.num_feature_levels, t.enc_n_points, enc_n_points,
                       keys=("self_attn",))
        assert n >= 1, "no encoder MSDA modules found"
        new_t = dataclasses.replace(new_t, enc_n_points=enc_n_points)

    if dec_n_points is not None and dec_n_points != t.dec_n_points:
        assert 1 <= dec_n_points < t.dec_n_points
        # from the root: the deformable reid head's decoder layers
        # (detr.reid_embed_head.0.layers.*) share dec_n_points
        n = _walk_msda(sd, t.nheads, t.num_feature_levels, t.dec_n_points, dec_n_points,
                       keys=("cross_attn",))
        expect = t.dec_layers + (cfg.n_layer_deformable_reid
                                 if cfg.use_reid and cfg.use_deformable_reid else 0)
        assert n == expect, (n, expect)
        new_t = dataclasses.replace(new_t, dec_n_points=dec_n_points)

    return sd, dataclasses.replace(cfg, transformer=new_t)


def load_model(sd: Mapping[str, torch.Tensor], cfg: UninextConfig, device="cuda",
               template: bool = False) -> nn.Module:
    """`UninextDETR(cfg)` built on `device` (the card unless the caller
    asks for another) and filled from `sd` strictly, in eval mode."""
    from ..models.detr import UninextDETR

    with torch.device("meta"):
        model = UninextDETR(cfg, template)
    model = model.to_empty(device=torch.device(device))
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model.eval()


def adapted_model(state: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: UninextConfig,
                  num_queries: Optional[int] = None, dec_n_points: Optional[int] = None,
                  enc_n_points: Optional[int] = None, device="cuda",
                  template: bool = False) -> Tuple[nn.Module, UninextConfig]:
    """`adapt_params`, then the model of the new config on `device`, filled
    strictly from the cut state. Returns (model, config)."""
    sd, new_cfg = adapt_params(state, cfg, num_queries=num_queries,
                               dec_n_points=dec_n_points, enc_n_points=enc_n_points)
    return load_model(sd, new_cfg, device, template), new_cfg
