"""UninextDETR, the inference half of `uninext_tpu/models/detr.py`, for the
detection task with the ViT-H backbone.

    (images, img_mask, prompt tokens) -> backbone -> input projections ->
    BERT prompt -> VL-fused deformable transformer (two-stage) ->
    per-layer VL alignment logits, refined boxes and IoU logits

Public tensors keep the JAX layouts: images (B, H, W, 3) NHWC, normalised
and padded to a multiple of 32; `img_mask` (B, H, W) True for padding.

Module nesting follows the reference UNINEXT checkpoint, so
`state_dict()` keys are the reference keys:
`detr.detr.backbone.0.backbone.*` (D2ViT), `detr.detr.input_proj.*`,
`detr.detr.transformer.*`, `detr.detr.{class_embed,bbox_embed,iou_head}.*`
and `text_encoder.body.model.*` (HF BERT). `engine/convert.py` fills them
from a JAX parameter tree.

Not ported yet: the ResNet and ConvNeXt backbones, the mask head, reid,
SOT/VOS templates, grounding, and every training branch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from uninext_tpu.config import UninextConfig

from ..utils.misc import inverse_sigmoid
from .bert import BertModel
from .heads import StillClassifier, VLAlign
from .layers import MLP, Conv2d, GroupNorm, Linear
from .position_encoding import position_embedding_sine
from .transformer import UninextTransformer
from .vit import ViT


def _downsample_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-downsample a (B, H, W) bool padding mask to (B, h, w)."""
    H, W = mask.shape[1:]
    h, w = hw
    iy = torch.arange(h, device=mask.device) * H // h
    ix = torch.arange(w, device=mask.device) * W // w
    return mask[:, iy][:, :, ix]


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
                  in_channels=b.in_channels, dtype=dtype)
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


class UninextDETR(nn.Module):
    def __init__(self, cfg: UninextConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        self.detr = _Nest("detr", DeformableDETR(cfg, dtype))
        self.text_encoder = _Nest("body", _Nest("model", BertModel(cfg.language, dtype)))

    @property
    def core(self) -> DeformableDETR:
        return self.detr.detr

    @property
    def bert(self) -> BertModel:
        return self.text_encoder.body.model

    def encode_text(self, text_ids: torch.Tensor, text_mask: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        return self.bert(text_ids, text_mask)

    def encode_image(self, images: torch.Tensor, img_mask: torch.Tensor):
        """images: (B, H, W, 3) normalised; img_mask: (B, H, W) True=pad.
        Returns per-level srcs (B, h, w, C) fp32, masks, sine positions."""
        c = self.cfg
        t = c.transformer
        feats = self.core.backbone[0].backbone(images)
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


def build_model(cfg: UninextConfig, device="cpu", seed: int = 0) -> UninextDETR:
    """Build `UninextDETR` directly on `device` (no host copy of the
    weights, no use of the global RNG) with random weights from `seed`."""
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
