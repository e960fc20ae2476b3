"""Deformable transformer with VL early fusion, two-stage proposals and the
DINO decoder, mirroring `uninext_tpu/models/transformer.py`. Training adds
the denoising (DN) queries ahead of the matching queries, the DN
self-attention mask, and activation checkpointing of the encoder layers
(the JAX package's `remat_encoder`).

The encoder is a plain loop of layers (VLFuse before the first
`num_vl_layers`; with `use_additional_bert`, MODEL.USE_ADDITIONAL_BERT, a
clamped BERT layer on the language stream after every encoder layer); the
JAX package's scan-stacked encoder was an XLA compile measure and its
parameters are unstacked by the weight bridge (`engine/convert.py`).
Parameter names follow the reference (`deformable_transformer_dino.py`,
`DeformableTransformerEncoderVL` of `deformable_transformer.py:299-317`):
level_embed, tgt_embed, encoder.{layers,vl_layers,lang_layers},
decoder.{layers,ref_point_head}, enc_output, enc_output_norm, resizer.

The options of the decoder's target and references, as the JAX package
(`uninext_tpu/models/transformer.py:292-321`):
  * `decouple_tgt` (MODEL.DECOUPLE_TGT): the learnt target embedding, with
    the pooled language feature `ref_feat` riding along at weight 0; off,
    every query's target (the DN queries' too) is `ref_feat`;
  * `still_tgt_for_both` (MODEL.STILL_TGT_FOR_BOTH): off, grounding's
    target is `ref_feat` (+ 0 x the learnt one), detection's stays learnt;
  * `look_forward_twice` (DDETRS.LOOK_FORWARD_TWICE): the references each
    layer hands on keep the gradient of its box head; off, they are the
    detached ones (the forward values are the same).

Flax LayerNorm's epsilon is 1e-6 where torch defaults to 1e-5; every norm
here sets it explicitly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LanguageConfig, TransformerConfig

from ..utils.misc import (agg_lang_feat, checkpointed, inverse_sigmoid,
                          stable_topk_indices)
from .bert import BertLayer
from .layers import (MLP, FeatureResizer, LayerNorm, Linear, MSDeformAttn,
                     MultiHeadAttention, get_sine_pos_embed)
from .vl_fusion import VLFuse

# large finite stand-in for the reference's float('inf') proposal masking
INVALID_LOGIT = 1e5


class EncoderLayer(nn.Module):
    def __init__(self, c: TransformerConfig, dtype=torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttn(c.d_model, c.num_feature_levels, c.nheads,
                                      c.enc_n_points, dtype=dtype)
        self.norm1 = LayerNorm(c.d_model, eps=1e-6)
        self.linear1 = Linear(c.d_model, c.dim_feedforward, dtype=dtype)
        self.linear2 = Linear(c.dim_feedforward, c.d_model, dtype=dtype)
        self.norm2 = LayerNorm(c.d_model, eps=1e-6)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask):
        attn = self.self_attn(src + pos, reference_points, src, padding_mask,
                              spatial_shapes)
        src = self.norm1(src + attn)
        h = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + h)


class DecoderLayer(nn.Module):
    """Self-attention -> norm2 -> deformable cross-attention -> norm1 ->
    FFN -> norm3 (the reference's norm order)."""

    def __init__(self, c: TransformerConfig, dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(c.d_model, c.nheads, dtype=dtype)
        self.norm2 = LayerNorm(c.d_model, eps=1e-6)
        self.cross_attn = MSDeformAttn(c.d_model, c.num_feature_levels, c.nheads,
                                       c.dec_n_points, dtype=dtype)
        self.norm1 = LayerNorm(c.d_model, eps=1e-6)
        self.linear1 = Linear(c.d_model, c.dim_feedforward, dtype=dtype)
        self.linear2 = Linear(c.dim_feedforward, c.d_model, dtype=dtype)
        self.norm3 = LayerNorm(c.d_model, eps=1e-6)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask, attn_mask=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, attn_mask))
        ca = self.cross_attn(tgt + query_pos, reference_points, src,
                             src_padding_mask, spatial_shapes)
        tgt = self.norm1(tgt + ca)
        h = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + h)


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor
                             ) -> torch.Tensor:
    """All-level pixel-centre grid scaled by the valid ratios.
    valid_ratios: (B, L, 2) (w, h). Returns (B, S, L, 2)."""
    dev = valid_ratios.device
    refs = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        ry = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * H)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack([gx, gy], -1))
    ref = torch.cat(refs, 1)
    return ref[:, :, None] * valid_ratios[:, None]


def compute_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, H, W) bool True=padding -> (B, L, 2) (w, h)."""
    out = []
    for m in masks:
        H, W = m.shape[1], m.shape[2]
        valid_h = (~m[:, :, 0]).sum(1).float() / H
        valid_w = (~m[:, 0, :]).sum(1).float() / W
        out.append(torch.stack([valid_w, valid_h], -1))
    return torch.stack(out, 1)


def gen_encoder_output_proposals(memory, mask_flatten, spatial_shapes):
    """(memory zeroed at invalid slots, proposal logits with INVALID_LOGIT at
    invalid slots), before the enc_output projection."""
    B = memory.shape[0]
    dev = memory.device
    proposals = []
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        m = mask_flatten[:, start:start + H * W].reshape(B, H, W)
        valid_h = (~m[:, :, 0]).sum(1).float()
        valid_w = (~m[:, 0, :]).sum(1).float()
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None]
        scale = torch.stack([valid_w, valid_h], -1).reshape(B, 1, 1, 2)
        grid = (grid + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([grid, wh], -1).reshape(B, H * W, 4))
        start += H * W
    props = torch.cat(proposals, 1)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    props = torch.log(props / (1 - props.clamp(max=1 - 1e-7)))
    invalid = mask_flatten[..., None] | ~valid
    return memory.masked_fill(invalid, 0.0), props.masked_fill(invalid, INVALID_LOGIT)


class _Encoder(nn.Module):
    def __init__(self, c: TransformerConfig, lcfg: LanguageConfig, dtype):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(c, dtype)
                                    for _ in range(c.enc_layers))
        n_vl = min(c.num_vl_layers, c.enc_layers) if c.use_early_fusion else 0
        self.vl_layers = nn.ModuleList(VLFuse(c, lcfg, dtype) for _ in range(n_vl))
        if c.use_additional_bert:
            # replicated under tensor parallelism, as JAX's `lang_layer_{i}`
            # (no "bert" root): `shard_module` leaves their model_group unset
            self.lang_layers = nn.ModuleList(BertLayer(lcfg, dtype)
                                             for _ in range(c.enc_layers))


class _Decoder(nn.Module):
    def __init__(self, c: TransformerConfig, dtype):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(c, dtype)
                                    for _ in range(c.dec_layers))
        # input: the sine embedding of 4 box coordinates, 128 features each
        self.ref_point_head = MLP(4 * 128, c.d_model, c.d_model, 2)


class UninextTransformer(nn.Module):
    """Encoder (VL fusion + MSDA) + two-stage proposals + DINO decoder.

    The per-layer heads belong to the parent (`DeformableDETR`) and are
    passed in, so box refinement shares their parameters."""

    def __init__(self, c: TransformerConfig, lcfg: LanguageConfig,
                 dtype=torch.float32):
        super().__init__()
        if not c.two_stage:
            raise NotImplementedError(
                "the one-stage transformer (two_stage=False): the JAX package "
                "has no such path either")
        self.cfg = c
        self.compute_dtype = dtype
        self.level_embed = nn.Parameter(torch.empty(c.num_feature_levels, c.d_model))
        self.encoder = _Encoder(c, lcfg, dtype)
        self.resizer = FeatureResizer(lcfg.hidden_dim, c.d_model)
        self.enc_output = Linear(c.d_model, c.d_model)
        self.enc_output_norm = LayerNorm(c.d_model, eps=1e-6)
        self.tgt_embed = nn.Embedding(c.num_queries, c.d_model)
        self.decoder = _Decoder(c, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=generator)
            self.tgt_embed.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, srcs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                pos_embeds: Sequence[torch.Tensor], lang_hidden: torch.Tensor,
                lang_mask: torch.Tensor, enc_class_head: Callable,
                enc_bbox_head: Callable, bbox_heads: Sequence[Callable],
                dn_tgt: Optional[torch.Tensor] = None,
                dn_refpoints_unact: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                remat_encoder: bool = False,
                task: str = "detection") -> Dict[str, torch.Tensor]:
        """srcs/masks/pos_embeds per level (B, H, W, C) / (B, H, W) True=pad /
        (B, H, W, C); lang_hidden (B, T, C_l); lang_mask (B, T) 1=valid.
        Training: dn_tgt (B, Ndn, C) and dn_refpoints_unact (B, Ndn, 4) go
        ahead of the matching queries, `attn_mask` (Ndn+Q, Ndn+Q) True =
        blocked; `remat_encoder` checkpoints each encoder layer (the
        additional BERT layers are not checkpointed, as in JAX). `task`
        ("detection" or "grounding") picks the target under
        `still_tgt_for_both=False`."""
        c = self.cfg
        B = srcs[0].shape[0]
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flatten = torch.cat([s.reshape(B, -1, c.d_model) for s in srcs], 1)
        mask_flatten = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos_flatten = torch.cat(
            [p.reshape(B, -1, c.d_model) + self.level_embed[l][None, None]
             for l, p in enumerate(pos_embeds)], 1)
        valid_ratios = compute_valid_ratios(masks)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        visual = src_flatten
        lang_layers = getattr(self.encoder, "lang_layers", None)
        if lang_layers is not None:
            dt = self.compute_dtype
            lang_bias = torch.where(lang_mask[:, None, None, :] > 0,
                                    torch.zeros((), dtype=dt, device=lang_mask.device),
                                    torch.tensor(-1e9, dtype=dt, device=lang_mask.device))
        for i, layer in enumerate(self.encoder.layers):
            if i < len(self.encoder.vl_layers):
                visual, lang_hidden = self.encoder.vl_layers[i](
                    visual, lang_hidden, lang_mask)
            args = (visual, pos_flatten, enc_ref, spatial_shapes, mask_flatten)
            visual = (checkpointed(layer, *args)
                      if remat_encoder and torch.is_grad_enabled() else layer(*args))
            if lang_layers is not None:
                lang_hidden = lang_layers[i](lang_hidden.to(self.compute_dtype), lang_bias)
        memory = visual

        lang_pool = agg_lang_feat(lang_hidden, lang_mask)
        ref_feat = self.resizer(lang_pool)[:, None]

        out_memory, out_proposals = gen_encoder_output_proposals(
            memory, mask_flatten, spatial_shapes)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        enc_class = enc_class_head(out_memory, lang_pool[:, None])
        enc_coord_unact = enc_bbox_head(out_memory).float() + out_proposals
        # ties are real here (rows zeroed at invalid proposals): stable order
        topk = min(c.num_queries, enc_class.shape[1])
        topk_idx = stable_topk_indices(enc_class[..., 0], topk)
        if topk < c.num_queries:
            reps = -(-c.num_queries // topk)
            topk_idx = topk_idx.repeat(1, reps)[:, :c.num_queries]
        topk_coords_unact = torch.gather(
            enc_coord_unact, 1, topk_idx[..., None].expand(-1, -1, 4))
        reference_points = topk_coords_unact.detach().sigmoid()
        if dn_refpoints_unact is not None:
            reference_points = torch.cat([dn_refpoints_unact.sigmoid(),
                                          reference_points], 1)
        init_reference = reference_points

        tgt = self.tgt_embed.weight[None].expand(B, -1, -1)
        if dn_tgt is not None:
            tgt = torch.cat([dn_tgt, tgt], 1)
        # the target options (reference :243-255); the coupled target
        # replaces the DN rows too, as in JAX
        if not c.decouple_tgt:
            tgt = ref_feat.expand(-1, tgt.shape[1], -1)
        elif c.still_tgt_for_both or task == "detection":
            tgt = tgt + 0.0 * ref_feat
        elif task == "grounding":
            tgt = ref_feat + 0.0 * tgt
        tgt = tgt.to(self.compute_dtype)

        intermediate, intermediate_refs = [], []
        vr2 = torch.cat([valid_ratios] * 2, -1)[:, None]
        for lid, layer in enumerate(self.decoder.layers):
            ref_input = reference_points[:, :, None] * vr2
            query_sine = get_sine_pos_embed(ref_input[:, :, 0, :])
            query_pos = self.decoder.ref_point_head(query_sine).to(
                self.compute_dtype)
            tgt = layer(tgt, query_pos, ref_input, memory, spatial_shapes,
                        mask_flatten, attn_mask)
            delta = bbox_heads[lid](tgt).float()
            new_ref = (delta + inverse_sigmoid(reference_points)).sigmoid()
            reference_points = new_ref.detach()
            intermediate.append(tgt)
            intermediate_refs.append(new_ref if c.look_forward_twice else reference_points)

        return {
            "hs": torch.stack(intermediate),
            "memory": memory,
            "init_reference": init_reference,
            "inter_references": torch.stack(intermediate_refs),
            "enc_class": enc_class,
            "enc_coord_unact": enc_coord_unact,
            "lang_hidden": lang_hidden,
            "valid_ratios": valid_ratios,
            "mask_flatten": mask_flatten,
        }
