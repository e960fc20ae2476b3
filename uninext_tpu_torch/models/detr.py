"""UninextDETR, mirroring `uninext_tpu/models/detr.py`, for the detection
task with the ViT-H backbone: inference (`forward`) and the training
losses (`forward_train`, without the mask losses).

    (images, img_mask, prompt tokens) -> backbone -> input projections ->
    BERT prompt -> VL-fused deformable transformer (two-stage) ->
    per-layer VL alignment logits, refined boxes and IoU logits
    [-> training: DN queries, per-layer simOTA / encoder Hungarian
        matching, focal, L1, GIoU and IoU-branch losses]

Public tensors keep the JAX layouts: images (B, H, W, 3) NHWC, normalised
and padded to a multiple of 32; `img_mask` (B, H, W) True for padding.

Module nesting follows the reference UNINEXT checkpoint, so
`state_dict()` keys are the reference keys:
`detr.detr.backbone.0.backbone.*` (D2ViT), `detr.detr.input_proj.*`,
`detr.detr.transformer.*`, `detr.detr.{class_embed,bbox_embed,iou_head}.*`,
`detr.resizer.*` (the DN label encoder) and `text_encoder.body.model.*`
(HF BERT). `engine/convert.py` fills them from a JAX parameter tree.

Random numbers of training (DN box noise, drop-path masks) come from an
explicit `torch.Generator`, or the DN noise from the caller; the JAX
package's `jax.random` stream is not reproduced.

Not ported yet: the ResNet and ConvNeXt backbones, the mask head and its
losses, reid, SOT/VOS templates, grounding and video training.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

import numpy as np

from ..config import UninextConfig
from ..utils import box_ops
from ..utils.misc import agg_lang_feat, inverse_sigmoid
from . import criterion as crit
from .bert import BertModel
from .heads import StillClassifier, VLAlign
from .layers import MLP, Conv2d, FeatureResizer, GroupNorm, Linear
from .matcher import hungarian_match, ota_cost_and_iou, simota_match, vl_cost_matrix
from .position_encoding import position_embedding_sine
from .transformer import UninextTransformer
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


def prepare_dn_static(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                      label_enc: torch.Tensor, box_noise_scale: float,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      single_pad: int = DN_SINGLE_PAD, groups: int = DN_GROUPS):
    """Contrastive denoising queries with a fixed layout: `groups` groups of
    a positive and a negative copy of the first `single_pad` gts per image.

    `noise` = (sign, part), each (B, groups, 2, single_pad, 4): sign in
    {-1, 1}, part in [0, 1); drawn from `generator` when not given. Returns
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
        sign = torch.randint(0, 2, b.shape, generator=generator,
                             device=dev).float() * 2 - 1
        part = torch.rand(b.shape, generator=generator, device=dev)
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


class DeformableDETR(nn.Module):
    """Backbone, input projections, transformer and heads (the reference's
    `detr.detr`)."""

    def __init__(self, cfg: UninextConfig, dtype: torch.dtype):
        super().__init__()
        t, b = cfg.transformer, cfg.backbone
        if b.name != "vit_huge":
            raise NotImplementedError(f"backbone {b.name} is not ported yet")
        vit = ViT(patch_size=b.vit_patch_size, embed_dim=b.vit_embed_dim,
                  depth=b.vit_depth, num_heads=b.vit_num_heads,
                  window_size=b.vit_window_size,
                  global_blocks=b.vit_global_blocks,
                  in_channels=b.in_channels, dtype=dtype,
                  drop_path_rate=b.vit_drop_path_rate,
                  use_checkpoint=b.vit_use_checkpoint)
        self.backbone = nn.ModuleList([_Nest("backbone", vit)])
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
        if not t.still_cls_for_encoder:
            raise NotImplementedError("encoder VL-alignment head")
        self.class_embed = nn.ModuleList(
            [VLAlign(t, lang_dim) for _ in range(t.dec_layers)]
            + [StillClassifier(t.d_model, t.prior_prob)])
        self.bbox_embed = nn.ModuleList(
            MLP(t.d_model, t.d_model, 4, 3) for _ in range(t.dec_layers + 1))
        if not t.use_iou_branch:
            raise NotImplementedError("heads without the IoU branch")
        self.iou_head = nn.ModuleList(
            Linear(t.d_model, 1) for _ in range(t.dec_layers))
        self.prior_prob = t.prior_prob

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
            for head in self.iou_head:
                nn.init.constant_(head.bias, bias)


class _DNWrapper(nn.Module):
    """The reference's DDETRSegmUniDN level: the DETR and the DN label
    encoder (`resizer`, language pool -> d_model)."""

    def __init__(self, cfg: UninextConfig, dtype: torch.dtype):
        super().__init__()
        self.detr = DeformableDETR(cfg, dtype)
        self.resizer = FeatureResizer(cfg.language.hidden_dim, cfg.transformer.d_model)


class UninextDETR(nn.Module):
    def __init__(self, cfg: UninextConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        self.detr = _DNWrapper(cfg, dtype)
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

    def encode_image(self, images: torch.Tensor, img_mask: torch.Tensor,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None):
        """images: (B, H, W, 3) normalised; img_mask: (B, H, W) True=pad.
        Returns per-level srcs (B, h, w, C) fp32, masks, sine positions.
        `train` turns on the backbone's drop-path and checkpointing."""
        c = self.cfg
        t = c.transformer
        feats = self.core.backbone[0].backbone(images, train=train,
                                               generator=generator)
        level_feats = [feats[f"res{i + 3}"] for i in range(len(c.backbone.out_channels))]
        srcs, masks, poses = [], [], []
        for i, proj in enumerate(self.core.input_proj):
            if i < len(level_feats):
                x = proj(level_feats[i])
            elif i == len(level_feats):
                x = proj(level_feats[-1])
            else:
                x = proj(srcs[-1])
            m = _downsample_mask(img_mask, (x.shape[1], x.shape[2]))
            srcs.append(x)
            masks.append(m)
            poses.append(position_embedding_sine(m, t.d_model // 2,
                                                 dtype=self.compute_dtype))
        return srcs, masks, poses

    def _decode_outputs(self, trans, lvl: int) -> Dict[str, torch.Tensor]:
        """Alignment logits, refined boxes and IoU logits of decoder layer
        `lvl` (detection: logits against every prompt token)."""
        base = (trans["init_reference"] if lvl == 0
                else trans["inter_references"][lvl - 1])
        hs = trans["hs"][lvl]
        delta = self.core.bbox_embed[lvl](hs).float()
        return {"pred_logits": self.core.class_embed[lvl](hs, trans["lang_hidden"]),
                "pred_boxes": (delta + inverse_sigmoid(base)).sigmoid(),
                "pred_boxious": self.core.iou_head[lvl](hs.float()),
                "hs": hs, "base_reference": base}

    def inference_outputs(self, trans) -> Dict[str, torch.Tensor]:
        """The last decoder layer's outputs for `postprocess_detection`;
        the other layers' heads feed only the training losses."""
        out = self._decode_outputs(trans, self.cfg.transformer.dec_layers - 1)
        out["memory"] = trans["memory"]
        return out

    def forward(self, images: torch.Tensor, img_mask: torch.Tensor,
                image_sizes: torch.Tensor, text_ids: Optional[torch.Tensor],
                text_mask: torch.Tensor, task: str = "detection",
                lang_dict: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Detection inference. `lang_dict` (the output of `encode_text`)
        lets a server encode its category prompt once and reuse it."""
        if task != "detection":
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
            bbox_heads=core.bbox_embed[:t.dec_layers])
        return self.inference_outputs(trans)


    def forward_train(self, images: torch.Tensor, img_mask: torch.Tensor,
                      image_sizes: torch.Tensor, text_ids: torch.Tensor,
                      text_mask: torch.Tensor, targets: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      dn_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """Detection training forward: the loss dict of
        `uninext_tpu/models/detr.py:__call__(..., train=True)`.

        targets: boxes (B, G, 4) cxcywh normalised, valid (B, G) bool,
        positive_map (B, G, T) bool, has_masks False (the mask losses are
        not ported). Drop-path masks and, unless `dn_noise` = (sign, part)
        is given, the DN box noise come from `generator`."""
        if targets.get("has_masks", False):
            raise NotImplementedError("mask losses are not ported yet")
        c = self.cfg
        t = c.transformer
        lang = self.encode_text(text_ids, text_mask)
        if c.language.freeze:
            lang = {k: v.detach() for k, v in lang.items()}
        srcs, masks, poses = self.encode_image(images, img_mask, train=True,
                                               generator=generator)
        dn_tgt = dn_ref = dn_q2g = attn_mask = None
        if t.use_dino and t.dn_number > 0:
            label_enc = self.detr.resizer(agg_lang_feat(lang["hidden"], lang["masks"]))
            single_pad = min(DN_SINGLE_PAD, c.data.max_insts)
            dn_tgt, dn_ref, dn_q2g = prepare_dn_static(
                targets["boxes"], targets["valid"], label_enc, t.box_noise_scale,
                noise=dn_noise, generator=generator, single_pad=single_pad)
            attn_mask = self._dn_attn_mask(single_pad, images.device)
        core = self.core
        trans = core.transformer(
            srcs, masks, poses, lang["hidden"], lang["masks"],
            enc_class_head=core.class_embed[t.dec_layers],
            enc_bbox_head=core.bbox_embed[t.dec_layers],
            bbox_heads=core.bbox_embed[:t.dec_layers],
            dn_tgt=dn_tgt, dn_refpoints_unact=dn_ref, attn_mask=attn_mask,
            remat_encoder=c.remat_encoder)
        pad = 0 if dn_tgt is None else dn_tgt.shape[1]
        layers = []
        for lvl in range(t.dec_layers):
            out = self._decode_outputs(trans, lvl)
            layer = {k: out[k][:, pad:] for k in
                     ("pred_logits", "pred_boxes", "pred_boxious")}
            if pad:
                layer["dn_logits"] = out["pred_logits"][:, :pad]
                layer["dn_boxes"] = out["pred_boxes"][:, :pad]
            layers.append(layer)
        return self.compute_losses(layers, trans, targets, lang["masks"], dn_q2g)

    def compute_losses(self, layers: List[Dict[str, torch.Tensor]], trans,
                       targets: Dict[str, torch.Tensor], lang_mask: torch.Tensor,
                       dn_q2g: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-layer matching and losses (`uninext_tpu/models/detr.py:525`,
        without the mask losses): simOTA for the decoder layers, Hungarian
        for the encoder proposals, the DN slots by construction. Keys as the
        JAX package's: `loss_ce`, `loss_bbox`, `loss_giou`, `loss_boxiou` of
        the last layer, `_{lvl}` for the others, `_enc` and `_dn`."""
        c = self.cfg
        t = c.transformer
        lcfg = c.loss
        gt_boxes, gt_valid = targets["boxes"], targets["valid"]
        positive_map = targets["positive_map"] & gt_valid[..., None]
        text_mask = lang_mask.float()
        num_boxes_global = gt_valid.sum().float().clamp(min=1.0)
        suffix = lambda lvl: "" if lvl == t.dec_layers - 1 else f"_{lvl}"

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
            n_matched = (q2g >= 0).sum().float().clamp(min=1.0)
            num_boxes = n_matched if lcfg.ota else num_boxes_global
            out = {"loss_ce": crit.loss_labels_vl(layer["pred_logits"], positive_map,
                                                  q2g, text_mask, num_boxes, lcfg)}
            out.update(crit.loss_boxes(layer["pred_boxes"], gt_boxes, q2g, num_boxes,
                                       layer.get("pred_boxious")))
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
    lecun-normal linear and conv weights, zero biases, unit norms, embedding
    rows of std 1/sqrt(dim), then each module's own `init_weights` (prior
    biases, zeroed box deltas, the MSDA offset ring, layer scales, ...)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) \
                    else w[0].numel()
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
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


def build_model(cfg: UninextConfig, device="cuda", seed: int = 0) -> UninextDETR:
    """Build `UninextDETR` directly on `device` (the card unless the caller
    asks for another; no host copy of the weights, no use of the global
    RNG) with random weights from `seed`."""
    device = torch.device(device)
    with torch.device("meta"):
        model = UninextDETR(cfg)
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
