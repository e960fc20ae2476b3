"""UninextDETR, mirroring `uninext_tpu/models/detr.py`, with the ResNet-50,
ConvNeXt-L and ViT-H backbones: inference for detection and grounding
(`forward`), the masks of selected queries (`predict_masks`), the reid
embeddings of the video configs (`compute_reid`, the deformable reid
head), the detection and grounding training losses (`forward_train`) and
the two-frame (key, ref) video training losses (`forward_video_train`),
and, with the SOT/VOS template branch (`template=True`), the template
prompt (`encode_template`) and the SOT training losses
(`forward_sot_train`).

    (images, img_mask, prompt tokens) -> backbone -> input projections ->
    BERT prompt -> VL-fused deformable transformer (two-stage) ->
    per-layer VL alignment logits, refined boxes and (with the IoU branch)
    IoU logits
    [-> masks: the dynamic mask head on the encoder memory, for the queries
        a caller selected (`models/postprocess.py`)]
    [-> reid: a small deformable decoder over the encoder memory, then an
        MLP, on every query (`use_reid`)]
    [-> training: DN queries, per-layer simOTA / encoder Hungarian
        matching, focal, L1, GIoU and IoU-branch losses, and the dynamic
        masks of the matched queries against the gt masks (focal, dice) or,
        with `loss.boxinst`, against their gt boxes (BoxInst's projection
        and pairwise terms)]
    [-> video training: key and ref frames through one backbone pass and
        two transformer passes, the key frame's losses, and the contrastive
        reid loss between the key frame's matched queries and the ref
        frame's queries]
    [-> SOT/VOS: a template crop (`models/sot.py:crop_template`) through the
        template backbone (4 channels) or the main one (3), the input
        projections, the P3-P6 fuser or the per-level 8x8 resize, and
        `adjust_layer` -> a pseudo-language prompt for a grounding pass]

Public tensors keep the JAX layouts: images (B, H, W, 3) NHWC, normalised
and padded to a multiple of 32; `img_mask` (B, H, W) True for padding.

Module nesting follows the reference UNINEXT checkpoint, so
`state_dict()` keys are the reference keys:
`detr.detr.backbone.0.backbone.*` (detectron2's ResNet, D2ConvNeXt or
D2ViT),
`detr.detr.input_proj.*`, `detr.detr.transformer.*`,
`detr.detr.{class_embed,bbox_embed,iou_head}.*`, `detr.controller.*` and
`detr.mask_head.*` (the mask head), `detr.resizer.*` (the DN label encoder),
`detr.reid_embed_head.*` (the reid head: `.0` the deformable decoder and
`.1` the MLP, or the MLP alone), `text_encoder.body.model.*` (HF BERT)
and the template branch: `detr.detr.ref_backbone.0.backbone.*` (the
4-channel template backbone), `detr.sot_fuser.refine.{i}.*` and
`detr.adjust_layer.*`. `engine/convert.py` fills them from a JAX
parameter tree.

The template branch is built on request (`build_model(..., template=True)`,
the SOT training state, the SOT/VOS/R-VOS drivers' models): a tree of the
JAX package's image or video paths has none of it, as flax creates
parameters only where a path runs.

Random numbers of training (DN box noise, drop-path masks) come from an
explicit `torch.Generator`, or the DN noise from the caller; the JAX
package's `jax.random` stream is not reproduced.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

import numpy as np

from ..config import UninextConfig
from ..parallel.comm import global_count
from ..parallel.mesh import rows_of_draw
from ..utils import box_ops
from ..utils.misc import agg_lang_feat, inverse_sigmoid
from . import criterion as crit
from .bert import BertModel
from .convnext import ConvNeXt
from .heads import StillClassifier, VLAlign
from .layers import (MLP, Conv2d, FeatureResizer, GroupNorm, Linear, get_sine_pos_embed,
                     lecun_normal_)
from .mask_head import MaskHeadSmallConv, dynamic_mask_forward, num_gen_params
from .matcher import hungarian_match, ota_cost_and_iou, simota_match, vl_cost_matrix
from .position_encoding import position_embedding_sine
from .postprocess import take_queries
from .resnet import ResNet
from .sot import FeatureFuser, crop_template, resize_level
from .transformer import DecoderLayer, UninextTransformer
from .vit import ViT


# static DINO denoising layout (`uninext_tpu/models/detr.py:46-47`): DN_GROUPS
# groups of (positive | negative) blocks of DN_SINGLE_PAD slots each
DN_SINGLE_PAD = 20
DN_GROUPS = 5


def _downsample_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-downsample a (B, H, W) bool padding mask to (B, h, w)."""
    H, W = mask.shape[1:]
    h, w = hw
    iy = torch.arange(h, device=mask.device) * H // h
    ix = torch.arange(w, device=mask.device) * W // w
    return mask[:, iy][:, :, ix]


def build_dn_attn_mask(num_queries: int, single_pad: int = DN_SINGLE_PAD,
                       groups: int = DN_GROUPS) -> np.ndarray:
    """Static (pad+Q, pad+Q) bool mask, True = blocked: matching queries do
    not see the DN queries, and DN groups do not see each other."""
    pad = 2 * single_pad * groups
    n = pad + num_queries
    m = np.zeros((n, n), dtype=bool)
    m[pad:, :pad] = True
    for g in range(groups):
        lo, hi = 2 * single_pad * g, 2 * single_pad * (g + 1)
        m[lo:hi, hi:pad] = True
        m[lo:hi, :lo] = True
    return m


def select_matched(q2g: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first `n` matched queries of each image, in ascending query order,
    then unmatched ones: q2g (B, Q) -> sel_q (B, min(n, Q)) and sel_valid
    (B, min(n, Q)), True where the query is matched."""
    Q = q2g.shape[1]
    ar = torch.arange(Q, device=q2g.device)
    key = torch.where(q2g >= 0, ar, Q + ar)
    sel_q = torch.argsort(key, dim=-1)[:, :n]
    return sel_q, torch.gather(q2g, 1, sel_q) >= 0


def prepare_dn_static(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                      label_enc: torch.Tensor, box_noise_scale: float,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      single_pad: int = DN_SINGLE_PAD, groups: int = DN_GROUPS,
                      mesh=None):
    """Contrastive denoising queries with a fixed layout: `groups` groups of
    a positive and a negative copy of the first `single_pad` gts per image.

    `noise` = (sign, part), each (B, groups, 2, single_pad, 4): sign in
    {-1, 1}, part in [0, 1); drawn from `generator` when not given (under
    data parallelism, `mesh`, the whole batch's draw cut to this rank's
    rows). Returns
    dn_tgt (B, pad, C), dn_ref_unact (B, pad, 4) and dn_q2g (B, pad): the
    gt a positive slot reconstructs, else -1."""
    B, G = gt_valid.shape
    C = label_enc.shape[-1]
    dev = gt_boxes.device
    single_pad = min(single_pad, G)
    pad = 2 * single_pad * groups
    boxes = gt_boxes[:, :single_pad]
    valid = gt_valid[:, :single_pad]
    b = boxes[:, None, None].expand(B, groups, 2, single_pad, 4)
    if noise is None:
        shape = lambda n: (n,) + b.shape[1:]
        sign = rows_of_draw(lambda n: torch.randint(0, 2, shape(n), generator=generator,
                                                    device=dev), B, mesh).float() * 2 - 1
        part = rows_of_draw(lambda n: torch.rand(shape(n), generator=generator, device=dev),
                            B, mesh)
    else:
        sign, part = noise
    is_neg = torch.tensor([0.0, 1.0], device=dev).reshape(1, 1, 2, 1, 1)
    part = part + is_neg                                      # negatives in [1, 2)
    xyxy = box_ops.box_cxcywh_to_xyxy(b)
    half_wh = torch.cat([b[..., 2:] / 2, b[..., 2:] / 2], -1)
    noised = (xyxy + sign * part * half_wh * box_noise_scale).clamp(0.0, 1.0)
    noised = box_ops.box_xyxy_to_cxcywh(noised).reshape(B, pad, 4)

    v = valid[:, None, None].expand(B, groups, 2, single_pad).reshape(B, pad)
    dn_ref_unact = torch.where(v[..., None], inverse_sigmoid(noised), 0.0)
    dn_tgt = torch.where(v[..., None], label_enc[:, None].expand(B, pad, C), 0.0)
    g_idx = torch.arange(single_pad, device=dev).expand(B, groups, 2, single_pad)
    is_pos = torch.tensor([True, False], device=dev).reshape(1, 1, 2, 1)
    dn_q2g = torch.where(valid[:, None, None] & is_pos, g_idx, -1).reshape(B, pad)
    return dn_tgt, dn_ref_unact, dn_q2g


class _Nest(nn.Module):
    """One level of the reference checkpoint's module nesting."""

    def __init__(self, name: str, child: nn.Module):
        super().__init__()
        self.add_module(name, child)


def build_trunk(cfg: UninextConfig, in_channels: int, dtype: torch.dtype) -> nn.Module:
    """The backbone of `cfg` taking `in_channels` input channels (the
    template backbone is the same family with 4)."""
    b = cfg.backbone
    if b.name == "resnet50":
        return ResNet(in_channels=in_channels, dtype=dtype)
    if b.name == "convnext_large":
        return ConvNeXt(depths=b.convnext_depths, dims=b.convnext_dims,
                        drop_path_rate=b.drop_path_rate, in_channels=in_channels,
                        dtype=dtype)
    if b.name == "vit_huge":
        return ViT(patch_size=b.vit_patch_size, embed_dim=b.vit_embed_dim,
                   depth=b.vit_depth, num_heads=b.vit_num_heads,
                   window_size=b.vit_window_size, global_blocks=b.vit_global_blocks,
                   in_channels=in_channels, dtype=dtype,
                   drop_path_rate=b.vit_drop_path_rate,
                   use_checkpoint=b.vit_use_checkpoint)
    raise ValueError(f"unknown backbone {b.name!r}")


class DeformableDETR(nn.Module):
    """Backbone, input projections, transformer and heads (the reference's
    `detr.detr`); with `template` and `sot.extra_backbone_for_template`,
    the 4-channel template backbone `ref_backbone`."""

    def __init__(self, cfg: UninextConfig, dtype: torch.dtype, template: bool = False):
        super().__init__()
        t, b = cfg.transformer, cfg.backbone
        self.backbone = nn.ModuleList([_Nest("backbone", build_trunk(cfg, b.in_channels,
                                                                     dtype))])
        n_bb = len(b.out_channels)
        projs = []
        for i in range(t.num_feature_levels):
            if i < n_bb:
                conv = Conv2d(b.out_channels[i], t.d_model, 1, dtype=dtype)
            else:
                cin = b.out_channels[-1] if i == n_bb else t.d_model
                conv = Conv2d(cin, t.d_model, 3, stride=2, padding=1, dtype=dtype)
            projs.append(nn.Sequential(conv, GroupNorm(32, t.d_model, eps=1e-6)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = UninextTransformer(t, cfg.language, dtype=dtype)
        lang_dim = cfg.language.hidden_dim
        # the encoder's proposal head (class_embed[dec_layers]): binary
        # objectness, or with still_cls_for_encoder False a VLAlign against
        # the pooled prompt (`uninext_tpu/models/detr.py:262-265`)
        self.class_embed = nn.ModuleList(
            [VLAlign(t, lang_dim) for _ in range(t.dec_layers)]
            + [StillClassifier(t.d_model, t.prior_prob) if t.still_cls_for_encoder
               else VLAlign(t, lang_dim)])
        self.bbox_embed = nn.ModuleList(
            MLP(t.d_model, t.d_model, 4, 3) for _ in range(t.dec_layers + 1))
        if t.use_iou_branch:
            self.iou_head = nn.ModuleList(
                Linear(t.d_model, 1) for _ in range(t.dec_layers))
        self.prior_prob = t.prior_prob
        if template and cfg.sot.extra_backbone_for_template:
            self.ref_backbone = nn.ModuleList([_Nest("backbone", build_trunk(cfg, 4, dtype))])

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for proj in self.input_proj:
                w = proj[0].weight
                rf = w[0, 0].numel()
                bound = math.sqrt(6.0 / (w.shape[1] * rf + w.shape[0] * rf))
                w.uniform_(-bound, bound, generator=generator)
            for mlp in self.bbox_embed:
                nn.init.zeros_(mlp.layers[-1].weight)
            bias = -math.log((1 - self.prior_prob) / self.prior_prob)
            for head in getattr(self, "iou_head", ()):
                nn.init.constant_(head.bias, bias)


class DeformableReidHead(nn.Module):
    """The reference's DeformableReidHead (deformable_transformer_dino.py
    :504-528): `n_layers` decoder layers over the encoder memory, their
    query positions from the sine embedding of the reference boxes."""

    def __init__(self, cfg: UninextConfig, dtype: torch.dtype):
        super().__init__()
        t = cfg.transformer
        self.layers = nn.ModuleList(DecoderLayer(t, dtype)
                                    for _ in range(cfg.n_layer_deformable_reid))
        self.ref_point_head = MLP(4 * 128, t.d_model, t.d_model, 2)


class _DNWrapper(nn.Module):
    """The reference's DDETRSegmUniDN level: the DETR, the DN label encoder
    (`resizer`, language pool -> d_model), with the mask head enabled the
    `controller` (query -> dynamic mask parameters) and `mask_head`, and
    with `use_reid` the reid head `reid_embed_head`: [DeformableReidHead,
    MLP] with `use_deformable_reid`, else the MLP alone; with `template`
    the SOT/VOS template branch's `adjust_layer` (d_model -> the language
    width, fp32) and, with `sot.feature_fusion`, `sot_fuser`."""

    def __init__(self, cfg: UninextConfig, dtype: torch.dtype, template: bool = False):
        super().__init__()
        d = cfg.transformer.d_model
        self.detr = DeformableDETR(cfg, dtype, template)
        self.resizer = FeatureResizer(cfg.language.hidden_dim, d)
        if cfg.mask_head.enabled:
            self.controller = MLP(d, d, num_gen_params(cfg.mask_head, d // 32), 3)
            self.mask_head = MaskHeadSmallConv(d, dtype)
        if cfg.use_reid:
            mlp = MLP(d, d, d, cfg.reid_layers)
            self.reid_embed_head = (nn.ModuleList([DeformableReidHead(cfg, dtype), mlp])
                                    if cfg.use_deformable_reid else mlp)
        if template:
            self.adjust_layer = Linear(d, cfg.language.hidden_dim)
            if cfg.sot.feature_fusion:
                self.sot_fuser = FeatureFuser(d, cfg.transformer.num_feature_levels, dtype)


class UninextDETR(nn.Module):
    def __init__(self, cfg: UninextConfig, template: bool = False):
        super().__init__()
        self.cfg = cfg
        self.template = template
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        self.detr = _DNWrapper(cfg, dtype, template)
        self.text_encoder = _Nest("body", _Nest("model", BertModel(cfg.language, dtype)))
        self._dn_masks: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def _dn_attn_mask(self, single_pad: int, device: torch.device) -> torch.Tensor:
        """The constant DN attention mask, copied to `device` once (the copy
        from pageable host memory synchronises the stream)."""
        key = (single_pad, device)
        if key not in self._dn_masks:
            self._dn_masks[key] = torch.from_numpy(build_dn_attn_mask(
                self.cfg.transformer.num_queries, single_pad=single_pad)).to(device)
        return self._dn_masks[key]

    @property
    def core(self) -> DeformableDETR:
        return self.detr.detr

    @property
    def bert(self) -> BertModel:
        return self.text_encoder.body.model

    def encode_text(self, text_ids: torch.Tensor, text_mask: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        return self.bert(text_ids, text_mask)

    def _levels(self, trunk: nn.Module, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None
                ) -> List[torch.Tensor]:
        """`trunk` on images, then the input projections: per-level (B, h,
        w, C) fp32. `train` turns on ConvNeXt's and ViT's drop-path and
        ViT's checkpointing (the frozen-BN ResNet has no train mode)."""
        c = self.cfg
        if c.backbone.name == "resnet50":
            feats = trunk(images)
        else:
            feats = trunk(images, train=train, generator=generator, mesh=mesh)
        level_feats = [feats[f"res{i + 3}"] for i in range(len(c.backbone.out_channels))]
        srcs = []
        for i, proj in enumerate(self.core.input_proj):
            if i < len(level_feats):
                srcs.append(proj(level_feats[i]))
            elif i == len(level_feats):
                srcs.append(proj(level_feats[-1]))
            else:
                srcs.append(proj(srcs[-1]))
        return srcs

    def encode_image(self, images: torch.Tensor, img_mask: torch.Tensor,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None, mesh=None):
        """images: (B, H, W, 3) normalised; img_mask: (B, H, W) True=pad.
        Returns per-level srcs (B, h, w, C) fp32, masks, sine positions.
        `train` turns on the backbone's drop-path and checkpointing."""
        t = self.cfg.transformer
        srcs = self._levels(self.core.backbone[0].backbone, images, train, generator, mesh)
        masks, poses = [], []
        for x in srcs:
            m = _downsample_mask(img_mask, (x.shape[1], x.shape[2]))
            masks.append(m)
            poses.append(position_embedding_sine(m, t.d_model // 2,
                                                 dtype=self.compute_dtype))
        return srcs, masks, poses

    def encode_template(self, template_images: torch.Tensor,
                        template_pad_mask: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """Template crops (B, S, S, 3 or 4), normalised, with their pad mask
        (B, S, S) True = crop padding (`models/sot.py:crop_template`) -> a
        pseudo-language prompt {hidden (B, N, lang_dim) fp32, masks (B, N)
        int32, 1 = valid, aggregate (B, lang_dim)}, as
        `uninext_tpu/models/detr.py:encode_template`. A 4-channel crop goes
        through the template backbone when the config has one, else through
        the main backbone; then the input projections. With
        `sot.feature_fusion` the fused stride-8 map is the prompt (N =
        (S/8)^2: 1024 tokens for a 256 crop); without it each level is
        resized (nearest) to ref_feat_size^2 and the levels concatenated
        (N = L * 64). The masks come from the crop's pad mask, nearest-
        downsampled to each level. `adjust_layer` runs in fp32 under any
        compute dtype."""
        c = self.cfg
        d = c.transformer.d_model
        if not self.template:
            raise ValueError("encode_template: the model was built without the template "
                             "branch (build_model(..., template=True))")
        B, S = template_images.shape[:2]
        if c.sot.extra_backbone_for_template and template_images.shape[-1] == 4:
            trunk = self.core.ref_backbone[0].backbone
        else:
            trunk = self.core.backbone[0].backbone
        levels = self._levels(trunk, template_images)
        if template_pad_mask is None:
            template_pad_mask = torch.zeros((B, S, S), dtype=torch.bool,
                                            device=template_images.device)
        lmasks = [_downsample_mask(template_pad_mask, (x.shape[1], x.shape[2]))
                  for x in levels]
        if c.sot.feature_fusion:
            tok = self.detr.sot_fuser(levels).reshape(B, -1, d)
            pad = lmasks[0].reshape(B, -1)
        else:
            r = c.sot.ref_feat_size
            tok = torch.cat([resize_level(x, r).reshape(B, r * r, d) for x in levels], 1)
            pad = torch.cat([resize_level(m[..., None].float(), r).reshape(B, r * r) > 0
                             for m in lmasks], 1)
        hidden = self.detr.adjust_layer(tok.float())
        masks = (~pad).int()
        return {"hidden": hidden, "masks": masks, "aggregate": agg_lang_feat(hidden, masks)}

    def _decode_outputs(self, trans, lvl: int, task: str = "detection",
                        lang_mask: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """Alignment logits, refined boxes and IoU logits (with the IoU
        branch) of decoder layer `lvl`. Detection aligns each query with
        every prompt token (B, Q, T); grounding with the pooled expression
        (B, Q, 1)."""
        base = (trans["init_reference"] if lvl == 0
                else trans["inter_references"][lvl - 1])
        hs = trans["hs"][lvl]
        lang = trans["lang_hidden"]
        if task == "grounding":
            lang = agg_lang_feat(lang, lang_mask)[:, None]
        delta = self.core.bbox_embed[lvl](hs).float()
        out = {"pred_logits": self.core.class_embed[lvl](hs, lang),
               "pred_boxes": (delta + inverse_sigmoid(base)).sigmoid(),
               "hs": hs, "base_reference": base}
        if self.cfg.transformer.use_iou_branch:
            out["pred_boxious"] = self.core.iou_head[lvl](hs.float())
        return out

    def forward(self, images: torch.Tensor, img_mask: torch.Tensor,
                image_sizes: torch.Tensor, text_ids: Optional[torch.Tensor],
                text_mask: torch.Tensor, task: str = "detection",
                lang_dict: Optional[Dict[str, torch.Tensor]] = None,
                reid: bool = True) -> Dict:
        """Inference for `task` "detection" (a category prompt) or
        "grounding" (an expression). `lang_dict` (the output of
        `encode_text`) lets a server encode its category prompt once and
        reuse it. Returns the last decoder layer's logits, boxes and (with
        `use_iou_branch`) IoU logits with what `predict_masks` takes: `hs`,
        `base_reference`, the encoder `memory` and the level shapes of this
        input, `spatial_shapes`. The other layers' heads feed only the
        losses. With `use_reid`, `pred_embeds` (B, Q, d_model) fp32: the
        reid embedding of every query (`compute_reid`), unless `reid` is
        False (a caller that reads no embedding: the SOT and VOS frame
        steps, whose JAX counterparts XLA prunes of the reid head)."""
        if task not in ("detection", "grounding"):
            raise NotImplementedError(f"task {task!r} is not ported yet")
        t = self.cfg.transformer
        lang = lang_dict if lang_dict is not None else self.encode_text(
            text_ids, text_mask)
        srcs, masks, poses = self.encode_image(images, img_mask)
        core = self.core
        trans = core.transformer(
            srcs, masks, poses, lang["hidden"], lang["masks"],
            enc_class_head=core.class_embed[t.dec_layers],
            enc_bbox_head=core.bbox_embed[t.dec_layers],
            bbox_heads=core.bbox_embed[:t.dec_layers], task=task)
        out = self._decode_outputs(trans, t.dec_layers - 1, task, lang["masks"])
        out["memory"] = trans["memory"]
        out["spatial_shapes"] = tuple((s.shape[1], s.shape[2]) for s in srcs)
        if self.cfg.use_reid and reid:
            out["pred_embeds"] = self.compute_reid(
                out["hs"], trans["inter_references"][-1], trans,
                out["spatial_shapes"])
        return out

    def compute_reid(self, hs: torch.Tensor, refs: torch.Tensor, trans: Dict,
                     spatial_shapes: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
        """Reid embeddings (B, Q, d_model) fp32 of the queries' decoder states
        hs (B, Q, C) with their refined boxes refs (B, Q, 4): with
        `use_deformable_reid` the deformable reid decoder first attends to
        the encoder memory of `trans` (its `memory`, `mask_flatten` and
        `valid_ratios`), then the MLP. `detach_reid` stops the gradient of
        hs; refs never carry one into the deformable decoder; the memory
        keeps its gradient, so the reid loss reaches the encoder
        (`uninext_tpu/models/detr.py:852`)."""
        c = self.cfg
        x = hs.detach() if c.detach_reid else hs
        head = self.detr.reid_embed_head
        if not c.use_deformable_reid:
            return head(x)
        deform, mlp = head
        refs = refs.detach()
        vr2 = torch.cat([trans["valid_ratios"]] * 2, -1)[:, None]
        for layer in deform.layers:
            ref_input = refs[:, :, None] * vr2
            qpos = deform.ref_point_head(
                get_sine_pos_embed(ref_input[:, :, 0, :])).to(x.dtype)
            x = layer(x, qpos, ref_input, trans["memory"], spatial_shapes,
                      trans["mask_flatten"])
        return mlp(x)

    def predict_masks(self, memory: torch.Tensor,
                      spatial_shapes: Tuple[Tuple[int, int], ...],
                      hs_sel: torch.Tensor, base_ref_sel: torch.Tensor,
                      image_sizes: torch.Tensor) -> torch.Tensor:
        """Mask logits (B, K, H/4, W/4) for K selected queries: their decoder
        states hs_sel (B, K, C) and base references base_ref_sel (B, K, 4),
        whose centres scaled by image_sizes' (w, h) place the relative
        coordinates. The mask features come from the encoder memory's first
        three levels."""
        params = self.detr.controller(hs_sel)
        centers = base_ref_sel[..., :2] * image_sizes.flip(-1)[:, None].float()
        return dynamic_mask_forward(self._mask_feats(memory, spatial_shapes), centers,
                                    params, self.cfg.mask_head)

    def _mask_feats(self, memory: torch.Tensor,
                    spatial_shapes: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
        """The mask head on the encoder memory's first three levels: fp32
        mask features (B, H/8, W/8, C // 32)."""
        B, d = memory.shape[0], self.cfg.transformer.d_model
        feats, start = [], 0
        for h, w in spatial_shapes[:3]:
            feats.append(memory[:, start:start + h * w].reshape(B, h, w, d))
            start += h * w
        return self.detr.mask_head(feats).float()


    def forward_train(self, images: torch.Tensor, img_mask: torch.Tensor,
                      image_sizes: torch.Tensor, text_ids: Optional[torch.Tensor],
                      text_mask: Optional[torch.Tensor], targets: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      dn_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      task: str = "detection",
                      lang_dict: Optional[Dict[str, torch.Tensor]] = None,
                      mesh=None) -> Dict[str, torch.Tensor]:
        """Training forward: the loss dict of
        `uninext_tpu/models/detr.py:__call__(..., train=True)` for `task`
        "detection" (a category prompt) or "grounding" (an expression, or
        with `lang_dict` a prompt made elsewhere, which keeps its gradient:
        the template prompt of `forward_sot_train`).

        targets: boxes (B, G, 4) cxcywh normalised, valid (B, G) bool,
        positive_map (B, G, T) bool (detection only), and with has_masks
        True the instance masks (B, G, H/4, W/4) in {0, 1}, which add the
        mask losses, or with `loss.boxinst` the box bitmasks (B, G, H/4,
        W/4), the colour similarity (B, 8, H/4, W/4) and the micro-step
        `step`, which add BoxInst's. Drop-path masks and, unless
        `dn_noise` = (sign, part) is given, the DN box noise come from
        `generator`. Under data
        parallelism (`mesh`; the batch is this rank's rows) the draws are
        the whole batch's, cut to this rank's rows, and every loss
        normaliser is the whole batch's (`parallel/comm.py:global_count`)."""
        if task not in ("detection", "grounding"):
            raise NotImplementedError(f"task {task!r} is not ported yet")
        c = self.cfg
        t = c.transformer
        if lang_dict is not None:
            lang = lang_dict
        else:
            lang = self.encode_text(text_ids, text_mask)
            if c.language.freeze:
                lang = {k: v.detach() for k, v in lang.items()}
        srcs, masks, poses = self.encode_image(images, img_mask, train=True,
                                               generator=generator, mesh=mesh)
        dn_tgt = dn_ref = dn_q2g = attn_mask = None
        if t.use_dino and t.dn_number > 0:
            label_enc = self.detr.resizer(agg_lang_feat(lang["hidden"], lang["masks"]))
            single_pad = min(DN_SINGLE_PAD, c.data.max_insts)
            dn_tgt, dn_ref, dn_q2g = prepare_dn_static(
                targets["boxes"], targets["valid"], label_enc, t.box_noise_scale,
                noise=dn_noise, generator=generator, single_pad=single_pad, mesh=mesh)
            attn_mask = self._dn_attn_mask(single_pad, images.device)
        core = self.core
        trans = core.transformer(
            srcs, masks, poses, lang["hidden"], lang["masks"],
            enc_class_head=core.class_embed[t.dec_layers],
            enc_bbox_head=core.bbox_embed[t.dec_layers],
            bbox_heads=core.bbox_embed[:t.dec_layers],
            dn_tgt=dn_tgt, dn_refpoints_unact=dn_ref, attn_mask=attn_mask,
            remat_encoder=c.remat_encoder, task=task)
        pad = 0 if dn_tgt is None else dn_tgt.shape[1]
        layers = []
        for lvl in range(t.dec_layers):
            out = self._decode_outputs(trans, lvl, task, lang["masks"])
            layer = {k: v[:, pad:] for k, v in out.items()}
            if pad:
                layer["dn_logits"] = out["pred_logits"][:, :pad]
                layer["dn_boxes"] = out["pred_boxes"][:, :pad]
            layers.append(layer)
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        return self.compute_losses(layers, trans, targets, lang["masks"], dn_q2g,
                                   task, image_sizes, spatial_shapes, mesh)

    def forward_sot_train(self, images_key: torch.Tensor, img_mask: torch.Tensor,
                          image_sizes: torch.Tensor, targets_key: Dict[str, torch.Tensor],
                          targets_ref: Dict[str, torch.Tensor], images_ref: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          dn_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          mesh=None) -> Dict[str, torch.Tensor]:
        """The SOT/VOS training losses of
        `uninext_tpu/models/detr.py:forward_sot_train` (reference
        coco_forward_sot): the ref frame gives only a template, the crop
        around its first valid slot's box (with the 4-channel template
        backbone, the slot's gt mask, upsampled x4 by repetition and cut to
        the ref image, as the 4th channel), encoded inside the
        differentiated function (`encode_template`: the template backbone,
        the fuser and `adjust_layer` get gradients); then one grounding
        pass on the key frame with that prompt, DN queries included, and
        its losses (`forward_train`). No reid loss. Key and ref share
        `img_mask` and `image_sizes`."""
        c = self.cfg
        valid_r = targets_ref["valid"]
        B = valid_r.shape[0]
        ar = torch.arange(B, device=valid_r.device)
        idx = valid_r.int().argmax(1)                     # the first valid slot
        box_n = targets_ref["boxes"][ar, idx]             # cxcywh, normalised
        hw = image_sizes.float()
        w, h = hw[:, 1], hw[:, 0]
        box_xyxy = torch.stack([(box_n[:, 0] - box_n[:, 2] / 2) * w,
                                (box_n[:, 1] - box_n[:, 3] / 2) * h,
                                (box_n[:, 0] + box_n[:, 2] / 2) * w,
                                (box_n[:, 1] + box_n[:, 3] / 2) * h], 1)
        mask_channel = c.sot.extra_backbone_for_template
        gm = None
        if mask_channel and "masks" in targets_ref:
            m4 = targets_ref["masks"][ar, idx]            # (B, H/4, W/4)
            gm = m4.repeat_interleave(4, 1).repeat_interleave(4, 2)
            gm = gm[:, :images_ref.shape[1], :images_ref.shape[2]]
        crop, pad = crop_template(images_ref, box_xyxy, c.sot.template_size,
                                  c.sot.search_area_factor, gt_masks=gm,
                                  mask_channel=mask_channel, pad_masks=img_mask)
        lang = self.encode_template(crop, pad)
        return self.forward_train(images_key, img_mask, image_sizes, None, None, targets_key,
                                  generator=generator, dn_noise=dn_noise, task="grounding",
                                  lang_dict=lang, mesh=mesh)

    def forward_video_train(self, images_key: torch.Tensor, img_mask: torch.Tensor,
                            image_sizes: torch.Tensor, text_ids: torch.Tensor,
                            text_mask: torch.Tensor, targets_key: Dict[str, torch.Tensor],
                            targets_ref: Dict[str, torch.Tensor], images_ref: torch.Tensor,
                            task: str = "detection",
                            generator: Optional[torch.Generator] = None,
                            mesh=None) -> Dict[str, torch.Tensor]:
        """The two-frame (key, ref) training losses of
        `uninext_tpu/models/detr.py:forward_video_train`: one backbone pass
        over the 2B clip, a transformer pass for each frame (no DN queries),
        the losses of `forward_train` on the key frame, and `loss_reid` /
        `loss_reid_aux` between the key frame's best query per gt (simOTA on
        the last layer) and every ref-frame query: positives are the ref
        queries simOTA gives that gt at k = 10, those it gives at k = 100
        and no other gt are left out, the rest are negatives. Slot i of
        targets_key and targets_ref is the same object; a row counts where
        the object is valid in both frames. Both frames share `img_mask`.
        The ref frame's decoder gets no gradient (its heads, references and,
        with `detach_reid`, its states are stopped); the reid head's
        attention to both frames' memories reaches both encoders. Under data
        parallelism (`mesh`) the normalisers are the whole batch's; a ViT's
        drop-path masks are then a block of the whole draw per rank, not
        the one-process step's (the video configs' R50 draws none)."""
        c = self.cfg
        if not c.use_reid:
            raise ValueError("video training needs a config with use_reid")
        if task not in ("detection", "grounding"):
            raise NotImplementedError(f"video task {task!r} is not ported yet")
        t = c.transformer
        B = images_key.shape[0]
        lang = self.encode_text(text_ids, text_mask)
        if c.language.freeze:
            lang = {k: v.detach() for k, v in lang.items()}
        srcs, masks, poses = self.encode_image(
            torch.cat([images_key, images_ref]), torch.cat([img_mask, img_mask]),
            train=True, generator=generator, mesh=mesh)
        core = self.core
        heads = dict(enc_class_head=core.class_embed[t.dec_layers],
                     enc_bbox_head=core.bbox_embed[t.dec_layers],
                     bbox_heads=core.bbox_embed[:t.dec_layers],
                     remat_encoder=c.remat_encoder, task=task)
        trans_k, trans_r = (
            core.transformer([x[sl] for x in srcs], [m[sl] for m in masks],
                             [p[sl] for p in poses], lang["hidden"], lang["masks"],
                             **heads)
            for sl in (slice(None, B), slice(B, None)))
        layers = [self._decode_outputs(trans_k, lvl, task, lang["masks"])
                  for lvl in range(t.dec_layers)]
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        losses = self.compute_losses(layers, trans_k, targets_key, lang["masks"], None,
                                     task, image_sizes, spatial_shapes, mesh)

        valid_k, valid_r = targets_key["valid"], targets_ref["valid"]
        last = core.class_embed[t.dec_layers - 1]
        if task == "grounding":
            pm_k, pm_r = valid_k[..., None], valid_r[..., None]
            ref_lang = agg_lang_feat(trans_r["lang_hidden"], lang["masks"])[:, None]
        else:
            pm_k = targets_key["positive_map"] & valid_k[..., None]
            pm_r = targets_ref["positive_map"] & valid_r[..., None]
            ref_lang = trans_r["lang_hidden"]
        with torch.no_grad():
            cost_k, iou_k = ota_cost_and_iou(layers[-1]["pred_logits"],
                                             layers[-1]["pred_boxes"], pm_k,
                                             targets_key["boxes"], valid_k)
            _, g2q_key = simota_match(cost_k, iou_k, valid_k)
            cost_r, iou_r = ota_cost_and_iou(last(trans_r["hs"][-1], ref_lang),
                                             trans_r["inter_references"][-1], pm_r,
                                             targets_ref["boxes"], valid_r)
            q2g_pos, _ = simota_match(cost_r, iou_r, valid_r, 10)
            q2g_wide, _ = simota_match(cost_r, iou_r, valid_r, 100)
        key_embeds = self.compute_reid(trans_k["hs"][-1], trans_k["inter_references"][-1],
                                       trans_k, spatial_shapes)
        ref_embeds = self.compute_reid(trans_r["hs"][-1], trans_r["inter_references"][-1],
                                       trans_r, spatial_shapes)
        G, Q = valid_k.shape[1], key_embeds.shape[1]
        g_idx = torch.arange(G, device=valid_k.device)[None, :, None]
        labels3 = torch.where(q2g_pos[:, None] == g_idx, 1,
                              torch.where(q2g_wide[:, None] == g_idx, -1, 0))
        key_sel = take_queries(key_embeds, g2q_key.clamp(min=0))      # (B, G, C)
        contrast = torch.einsum("bgc,bqc->bgq", key_sel, ref_embeds)
        norm = lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-9)
        cos = torch.einsum("bgc,bqc->bgq", norm(key_sel), norm(ref_embeds))
        row_valid = (valid_k & valid_r).float()
        losses.update(crit.loss_reid_static(
            contrast.reshape(B * G, Q), labels3.reshape(B * G, Q),
            row_valid.reshape(B * G), cos.reshape(B * G, Q), mesh))
        return losses

    def compute_losses(self, layers: List[Dict[str, torch.Tensor]], trans,
                       targets: Dict[str, torch.Tensor], lang_mask: torch.Tensor,
                       dn_q2g: Optional[torch.Tensor], task: str = "detection",
                       image_sizes: Optional[torch.Tensor] = None,
                       spatial_shapes: Tuple[Tuple[int, int], ...] = (),
                       mesh=None) -> Dict[str, torch.Tensor]:
        """Per-layer matching and losses (`uninext_tpu/models/detr.py:525`):
        simOTA for the decoder layers, Hungarian for the encoder proposals,
        the DN slots by construction; with has_masks, the mask losses of each
        layer's first `mask_head.max_insts` matched queries, whose dynamic
        masks sit at their base references' centres. Grounding aligns with
        one pooled token: a positive map of ones for every valid gt. With
        `loss.boxinst` the mask losses are BoxInst's, against the targets'
        `box_bitmasks` and `color_similarity`, the pairwise term warmed up
        by `targets["step"]`. Keys as the JAX package's: `loss_ce`,
        `loss_bbox`, `loss_giou`, `loss_boxiou`, `loss_mask`, `loss_dice`
        (or `loss_prj`, `loss_pairwise`) of the last layer, `_{lvl}` for the
        others, `_enc` and `_dn`."""
        c = self.cfg
        t = c.transformer
        lcfg = c.loss
        gt_boxes, gt_valid = targets["boxes"], targets["valid"]
        if task == "grounding":
            positive_map = gt_valid[..., None]
            text_mask = torch.ones(gt_valid.shape[0], 1, device=gt_valid.device)
        else:
            positive_map = targets["positive_map"] & gt_valid[..., None]
            text_mask = lang_mask.float()
        num_boxes_global = global_count(gt_valid.sum(), mesh)
        suffix = lambda lvl: "" if lvl == t.dec_layers - 1 else f"_{lvl}"

        mask_feats = None
        if c.mask_head.enabled and targets.get("has_masks", False):
            mask_feats = self._mask_feats(trans["memory"], spatial_shapes)
            scale = image_sizes.flip(-1)[:, None].float()         # (B, 1, 2) = (w, h)
            if lcfg.boxinst:
                # BoxInst: box bitmasks and colour similarity, no gt masks;
                # the pairwise term warms up over the micro-steps
                if "box_bitmasks" not in targets or "color_similarity" not in targets:
                    raise ValueError("BoxInst's mask losses need the targets' box_bitmasks "
                                     "and color_similarity (UniDatasetMapper(boxinst=True))")
                tgt_masks_all = targets["box_bitmasks"].float()
                step = torch.as_tensor(targets.get("step", 0), dtype=torch.float32,
                                       device=gt_boxes.device)
                warmup = (step / lcfg.boxinst_warmup_iters).clamp(0.0, 1.0)
            else:
                tgt_masks_all = targets["masks"].float()

        per_layer: Dict[str, List[torch.Tensor]] = {}
        for layer in layers:
            with torch.no_grad():
                logits, boxes = layer["pred_logits"].detach(), layer["pred_boxes"].detach()
                if lcfg.ota:
                    cost, iou = ota_cost_and_iou(logits, boxes, positive_map,
                                                 gt_boxes, gt_valid)
                    q2g, _ = simota_match(cost, iou, gt_valid)
                else:
                    cost = vl_cost_matrix(logits, boxes, positive_map, gt_boxes,
                                          gt_valid, lcfg.set_cost_class,
                                          lcfg.set_cost_box, lcfg.set_cost_giou)
                    q2g = hungarian_match(cost, gt_valid)
            n_matched = global_count((q2g >= 0).sum(), mesh)
            num_boxes = n_matched if lcfg.ota else num_boxes_global
            out = {"loss_ce": crit.loss_labels_vl(layer["pred_logits"], positive_map,
                                                  q2g, text_mask, num_boxes, lcfg)}
            out.update(crit.loss_boxes(layer["pred_boxes"], gt_boxes, q2g, num_boxes,
                                       layer.get("pred_boxious"), mesh))
            if mask_feats is not None:
                sel_q, sel_valid = select_matched(q2g, c.mask_head.max_insts)
                params = self.detr.controller(take_queries(layer["hs"], sel_q))
                centers = take_queries(layer["base_reference"], sel_q)[..., :2] * scale
                mask_logits = dynamic_mask_forward(mask_feats, centers, params,
                                                   c.mask_head)
                tgt = crit.gather_by_match(tgt_masks_all, torch.gather(q2g, 1, sel_q))
                if lcfg.boxinst:
                    out.update(crit.loss_masks_boxinst(
                        mask_logits, tgt, targets["color_similarity"], sel_valid, warmup,
                        lcfg.boxinst_pairwise_color_thresh, lcfg.boxinst_pairwise_size,
                        lcfg.boxinst_pairwise_dilation, mesh))
                else:
                    out.update(crit.loss_masks(mask_logits, tgt, sel_valid, num_boxes,
                                               lcfg))
            for k, v in out.items():
                per_layer.setdefault(k, []).append(v)
        losses: Dict[str, torch.Tensor] = {}
        for k, vals in per_layer.items():
            for lvl, v in enumerate(vals):
                losses[f"{k}{suffix(lvl)}"] = v

        enc_logits = trans["enc_class"]                          # (B, S, 1)
        enc_boxes = trans["enc_coord_unact"].sigmoid()
        bin_pm = gt_valid[..., None]
        with torch.no_grad():
            enc_cost = vl_cost_matrix(enc_logits.detach(), enc_boxes.detach(),
                                      bin_pm, gt_boxes, gt_valid, lcfg.set_cost_class,
                                      lcfg.set_cost_box, lcfg.set_cost_giou)
            enc_q2g = hungarian_match(enc_cost, gt_valid)
        losses["loss_ce_enc"] = crit.loss_labels_vl(enc_logits, bin_pm, enc_q2g, None,
                                                    num_boxes_global, lcfg)
        enc_box = crit.loss_boxes(enc_boxes, gt_boxes, enc_q2g, num_boxes_global)
        losses["loss_bbox_enc"] = enc_box["loss_bbox"]
        losses["loss_giou_enc"] = enc_box["loss_giou"]

        if dn_q2g is not None:
            dn_num_boxes = num_boxes_global * DN_GROUPS
            for lvl, layer in enumerate(layers):
                sfx = suffix(lvl)
                losses[f"loss_ce_dn{sfx}"] = crit.loss_labels_vl(
                    layer["dn_logits"], positive_map, dn_q2g, text_mask,
                    dn_num_boxes, lcfg)
                bx = crit.loss_boxes(layer["dn_boxes"], gt_boxes, dn_q2g, dn_num_boxes)
                losses[f"loss_bbox_dn{sfx}"] = bx["loss_bbox"]
                losses[f"loss_giou_dn{sfx}"] = bx["loss_giou"]
        return losses


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`, with the JAX package's initialisers:
    lecun-normal linear and conv weights (flax's truncated normal,
    `layers.lecun_normal_`), zero biases, unit norms, embedding rows of std
    1/sqrt(dim) (flax's `Embed`: an untruncated normal), then each module's
    own `init_weights` (prior biases, zeroed box deltas, the MSDA offset
    ring, layer scales, ...)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) \
                    else w[0].numel()
                lecun_normal_(w, fan_in, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]),
                                   generator=generator)
        for mod in model.modules():
            if hasattr(mod, "init_weights"):
                mod.init_weights(generator)


def build_model(cfg: UninextConfig, device="cuda", seed: int = 0,
                template: bool = False) -> UninextDETR:
    """Build `UninextDETR` directly on `device` (the card unless the caller
    asks for another; no host copy of the weights, no use of the global
    RNG) with random weights from `seed`; with `template`, the SOT/VOS
    template branch too."""
    device = torch.device(device)
    with torch.device("meta"):
        model = UninextDETR(cfg, template)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_params(model, gen)
    missed = [n for n, p in model.named_parameters() if torch.isnan(p).any()]
    if missed:
        raise RuntimeError(f"parameters left uninitialised: {missed}")
    return model.eval()
