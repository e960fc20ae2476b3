"""The weight bridge: a JAX (flax) parameter tree -> the port's modules.

`load_jax_params(model, params)` is the inverse of
`uninext_tpu/engine/convert.py:convert_checkpoint`: the port's
`state_dict()` keys are the reference UNINEXT keys, so passing the loaded
port's `state_dict()` through `convert_checkpoint` gives back the JAX tree.
Layouts turn around as there: Dense kernels (in, out) become Linear weights
(out, in); conv kernels (kh, kw, in, out) become (out, in, kh, kw); flax
norms' `scale` becomes `weight`; the decoder self-attention's q/k/v
projections become one `in_proj_weight`.

The backbone is the one the tree holds (`backbone_filler`):
`backbone/stem_norm` marks a ConvNeXt (D2ConvNeXt's names, the layer scale
`gamma` a `gamma.weight`), `backbone/stem_conv` without it a ResNet, whose
FrozenBN `scale`/`bias`/`mean`/`var` become detectron2's
`weight`/`bias`/`running_mean`/`running_var`; else it is a ViT. The mask
head (`controller`, `mask_head`) is filled when the tree has it.

Two places need care:
  * the JAX encoder is scan-stacked (`transformer/encoder_scan/layer/*`
    with a leading layer axis); the bridge unstacks it into
    `transformer.encoder.layers.{i}`;
  * `up_res3` is a Dense (in, 4*out) in JAX and the ConvTranspose2d
    `fpn1.0` in the reference; its bias must be four equal copies, which
    is what a ConvTranspose2d bias can hold.

The transformer options of the reference follow the tree: its
`transformer/lang_layer_{i}` (USE_ADDITIONAL_BERT) become the encoder's
`lang_layers.{i}` (HF BERT names), a VLAlign `enc_class_embed`
(STILL_CLS_FOR_ENCODER off) becomes `class_embed.{dec_layers}` as a
VLAlign, and a tree without `iou_head_{i}` (USE_IOU_BRANCH off) fills no
`iou_head`; the strict load then holds the model's config to the tree's.

The DN label encoder `dn_resizer` (training only) becomes `detr.resizer.*`,
as in the reference checkpoint. The reid head of the video configs becomes
`detr.reid_embed_head.*`: `reid_dec_{i}` (decoder layers) and
`reid_ref_point_head` under `.0`, `reid_embed` (the MLP) under `.1`, or
the MLP alone without the deformable head. The SOT/VOS template branch
of a tree that holds it (`init_all_paths`, the SOT training path) goes to
a model built with `template=True`: `template_backbone` (the backbone's
family with 4 input channels) becomes `detr.detr.ref_backbone.0.backbone.*`,
`sot_fuser/refine_{i}` `detr.sot_fuser.refine.{i}.*` and `adjust_layer`
`detr.adjust_layer.*`, the reference checkpoint's keys. Every JAX leaf
must be consumed and every port parameter filled (but `load_jax_params`'s
one exception, for a video tree's DN label encoder); anything else raises,
a template leaf the tree lacks by its name. The input is a tree of numpy
arrays (or anything `np.asarray` takes), so this module needs no JAX.

Reference checkpoints need no bridge: `load_reference_checkpoint` (the
counterpart of `load_torch_checkpoint` there) copies a `.pth`'s tensors
into the model by name and shape and reports what it loaded, what the
model missed, what had another shape and what went unused.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch

ROOT = "detr.detr."
BERT_ROOT = "text_encoder.body.model."
DN_ROOT = "detr.resizer."        # the DN label encoder (JAX `dn_resizer`)
REID_ROOT = "detr.reid_embed_head."  # the reid head of the video configs


class _Leaves:
    """The JAX tree flattened to {"a/b/c": array}; each leaf is taken once."""

    def __init__(self, tree):
        self.flat: Dict[str, np.ndarray] = {}
        self._flatten(tree.get("params", tree), "")

    def _flatten(self, node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                self._flatten(v, f"{path}/{k}" if path else str(k))
        else:
            self.flat[path] = np.asarray(node)

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"JAX leaf {path!r} not found")
        return self.flat.pop(path)

    def has(self, path: str) -> bool:
        return path in self.flat or any(k.startswith(path + "/") for k in self.flat)

    def check_empty(self):
        if self.flat:
            raise ValueError(f"JAX leaves not consumed: {sorted(self.flat)}")


def _j(path: str, name: str) -> str:
    return f"{path}/{name}" if path else name


def _dense(sd, key, lv, path):
    sd[key + "weight"] = lv.take(_j(path, "kernel")).T
    if lv.has(_j(path, "bias")):
        sd[key + "bias"] = lv.take(_j(path, "bias"))


def _conv(sd, key, lv, path):
    sd[key + "weight"] = lv.take(_j(path, "kernel")).transpose(3, 2, 0, 1)
    if lv.has(_j(path, "bias")):
        sd[key + "bias"] = lv.take(_j(path, "bias"))


def _norm(sd, key, lv, path):
    sd[key + "weight"] = lv.take(_j(path, "scale"))
    sd[key + "bias"] = lv.take(_j(path, "bias"))


def _mlp(sd, key, lv, path):
    j = 0
    while lv.has(_j(path, f"layer_{j}")):
        _dense(sd, f"{key}layers.{j}.", lv, _j(path, f"layer_{j}"))
        j += 1


_FROZEN_BN = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))


def _frozen_bn(sd, key, lv, path):
    for src, dst in _FROZEN_BN:
        sd[key + dst] = lv.take(_j(path, src))


# a ResNet block's convolutions and the JAX names of their norms
_RESNET_BN = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3", "shortcut": "shortcut_bn"}


def fill_resnet(sd, key, lv, path):
    """detectron2's ResNet: stem.conv1 (+ .norm), res{s}.{b}.conv{1,2,3}
    and res{s}.{b}.shortcut (+ .norm each)."""
    _conv(sd, key + "stem.conv1.", lv, _j(path, "stem_conv"))
    _frozen_bn(sd, key + "stem.conv1.norm.", lv, _j(path, "stem_bn"))
    for s in range(2, 6):
        b = 0
        while lv.has(_j(path, f"res{s}_block{b}")):
            bp, bk = _j(path, f"res{s}_block{b}"), f"{key}res{s}.{b}."
            for conv, bn in _RESNET_BN.items():
                if lv.has(_j(bp, conv)) or lv.has(_j(bp, bn)):
                    _conv(sd, f"{bk}{conv}.", lv, _j(bp, conv))
                    _frozen_bn(sd, f"{bk}{conv}.norm.", lv, _j(bp, bn))
            b += 1


def fill_convnext(sd, key, lv, path):
    """D2ConvNeXt: downsample_layers.0.{0,1} (stem conv, stem norm),
    downsample_layers.{i}.{0,1} (norm, conv), stages.{s}.{b}.{dwconv,norm,
    pwconv1,pwconv2,gamma}, norm{1,2,3} (the out norms of res3-res5). The
    depthwise kernel is (7, 7, 1, C) in JAX, (C, 1, 7, 7) here."""
    _conv(sd, key + "downsample_layers.0.0.", lv, _j(path, "stem_conv"))
    _norm(sd, key + "downsample_layers.0.1.", lv, _j(path, "stem_norm"))
    for i in range(1, 4):
        _norm(sd, f"{key}downsample_layers.{i}.0.", lv, _j(path, f"down_norm_{i}"))
        _conv(sd, f"{key}downsample_layers.{i}.1.", lv, _j(path, f"down_conv_{i}"))
    for s in range(4):
        b = 0
        while lv.has(_j(path, f"stage{s}_block{b}")):
            bp, bk = _j(path, f"stage{s}_block{b}"), f"{key}stages.{s}.{b}."
            _conv(sd, bk + "dwconv.", lv, _j(bp, "dwconv"))
            _norm(sd, bk + "norm.", lv, _j(bp, "norm"))
            _dense(sd, bk + "pwconv1.", lv, _j(bp, "pwconv1"))
            _dense(sd, bk + "pwconv2.", lv, _j(bp, "pwconv2"))
            sd[bk + "gamma.weight"] = lv.take(_j(bp, "gamma"))
            b += 1
    for i in range(1, 4):
        _norm(sd, f"{key}norm{i}.", lv, _j(path, f"out_norm_res{i + 2}"))


def backbone_filler(lv, path) -> Callable:
    """The fill function of the backbone family a tree holds at `path`:
    ConvNeXt (`stem_norm`), detectron2's ResNet (`stem_conv` with a frozen
    batch norm) or D2ViT. The model a tree is loaded into was built from a
    config naming the same family, which the strict load checks."""
    if lv.has(_j(path, "stem_norm")):
        return fill_convnext
    return fill_resnet if lv.has(_j(path, "stem_conv")) else fill_vit


def fill_vit(sd, key, lv, path):
    """D2ViT: patch_embed.proj, pos_embed, blocks.{i}.*, fpn1.0."""
    _conv(sd, key + "patch_embed.proj.", lv, _j(path, "patch_embed"))
    sd[key + "pos_embed"] = lv.take(_j(path, "pos_embed"))
    i = 0
    while lv.has(_j(path, f"block_{i}")):
        bp, bk = _j(path, f"block_{i}"), f"{key}blocks.{i}."
        _norm(sd, bk + "norm1.", lv, _j(bp, "norm1"))
        _norm(sd, bk + "norm2.", lv, _j(bp, "norm2"))
        _dense(sd, bk + "attn.qkv.", lv, _j(bp, "attn/qkv"))
        _dense(sd, bk + "attn.proj.", lv, _j(bp, "attn/proj"))
        sd[bk + "attn.rel_pos_h"] = lv.take(_j(bp, "attn/rel_pos_h"))
        sd[bk + "attn.rel_pos_w"] = lv.take(_j(bp, "attn/rel_pos_w"))
        _dense(sd, bk + "mlp.fc1.", lv, _j(bp, "mlp1"))
        _dense(sd, bk + "mlp.fc2.", lv, _j(bp, "mlp2"))
        i += 1
    w = lv.take(_j(path, "up_res3/kernel"))                # (in, 4*out)
    cin = w.shape[0]
    sd[key + "fpn1.0.weight"] = w.reshape(cin, 2, 2, -1).transpose(0, 3, 1, 2)
    b = lv.take(_j(path, "up_res3/bias")).reshape(4, -1)
    if not (b == b[:1]).all():
        raise ValueError("up_res3 bias differs between the four sub-pixels; "
                         "a ConvTranspose2d bias cannot hold it")
    sd[key + "fpn1.0.bias"] = b[0]


def fill_bert(sd, key, lv, path):
    """HF BertModel names."""
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{key}embeddings.{name}.weight"] = lv.take(_j(path, f"{name}/embedding"))
    _norm(sd, key + "embeddings.LayerNorm.", lv, _j(path, "embeddings_ln"))
    i = 0
    while lv.has(_j(path, f"layer_{i}")):
        fill_bert_layer(sd, f"{key}encoder.layer.{i}.", lv, _j(path, f"layer_{i}"))
        i += 1


def fill_bert_layer(sd, key, lv, path):
    """One BERT layer (`models/bert.py:BertLayer`) with HF BertLayer names."""
    for n in ("query", "key", "value"):
        _dense(sd, f"{key}attention.self.{n}.", lv, _j(path, f"attention/{n}"))
    _dense(sd, key + "attention.output.dense.", lv, _j(path, "attention/output"))
    _norm(sd, key + "attention.output.LayerNorm.", lv, _j(path, "attention_ln"))
    _dense(sd, key + "intermediate.dense.", lv, _j(path, "intermediate"))
    _dense(sd, key + "output.dense.", lv, _j(path, "ffn_output"))
    _norm(sd, key + "output.LayerNorm.", lv, _j(path, "output_ln"))


def fill_msda(sd, key, lv, path):
    for n in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _dense(sd, f"{key}{n}.", lv, _j(path, n))


def fill_encoder_layer(sd, key, lv, path):
    fill_msda(sd, key + "self_attn.", lv, _j(path, "self_attn"))
    for n in ("norm1", "norm2"):
        _norm(sd, f"{key}{n}.", lv, _j(path, n))
    for n in ("linear1", "linear2"):
        _dense(sd, f"{key}{n}.", lv, _j(path, n))


def fill_decoder_layer(sd, key, lv, path):
    fill_msda(sd, key + "cross_attn.", lv, _j(path, "cross_attn"))
    sa = _j(path, "self_attn")
    sd[key + "self_attn.in_proj_weight"] = np.concatenate(
        [lv.take(_j(sa, f"{n}/kernel")).T for n in ("q_proj", "k_proj", "v_proj")])
    sd[key + "self_attn.in_proj_bias"] = np.concatenate(
        [lv.take(_j(sa, f"{n}/bias")) for n in ("q_proj", "k_proj", "v_proj")])
    _dense(sd, key + "self_attn.out_proj.", lv, _j(sa, "out_proj"))
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{key}{n}.", lv, _j(path, n))
    for n in ("linear1", "linear2"):
        _dense(sd, f"{key}{n}.", lv, _j(path, n))


def fill_vl_fuse(sd, key, lv, path):
    """VLFuse -> `<key>b_attn.*`."""
    k = key + "b_attn."
    sd[k + "gamma_v"] = lv.take(_j(path, "gamma_v"))
    sd[k + "gamma_l"] = lv.take(_j(path, "gamma_l"))
    _norm(sd, k + "layer_norm_v.", lv, _j(path, "layer_norm_v"))
    _norm(sd, k + "layer_norm_l.", lv, _j(path, "layer_norm_l"))
    for n in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
              "out_v_proj", "out_l_proj"):
        _dense(sd, f"{k}attn.{n}.", lv, _j(path, f"attn/{n}"))


def _unstack_encoder(lv, path):
    """encoder_scan/layer/<leaf> (n, ...) -> encoder_layer_{i}/<leaf>."""
    scan = _j(path, "encoder_scan/layer") + "/"
    for p in [p for p in lv.flat if p.startswith(scan)]:
        stacked = lv.flat.pop(p)
        for i in range(stacked.shape[0]):
            lv.flat[_j(path, f"encoder_layer_{i}/{p[len(scan):]}")] = stacked[i]


def fill_transformer(sd, key, lv, path):
    sd[key + "level_embed"] = lv.take(_j(path, "level_embed"))
    sd[key + "tgt_embed.weight"] = lv.take(_j(path, "tgt_embed_weight"))
    _dense(sd, key + "enc_output.", lv, _j(path, "enc_output"))
    _norm(sd, key + "enc_output_norm.", lv, _j(path, "enc_output_norm"))
    _dense(sd, key + "resizer.fc.", lv, _j(path, "resizer/fc"))
    _norm(sd, key + "resizer.layer_norm.", lv, _j(path, "resizer/ln"))
    _mlp(sd, key + "decoder.ref_point_head.", lv, _j(path, "ref_point_head"))
    _unstack_encoder(lv, path)
    i = 0
    while lv.has(_j(path, f"encoder_layer_{i}")):
        fill_encoder_layer(sd, f"{key}encoder.layers.{i}.", lv,
                           _j(path, f"encoder_layer_{i}"))
        i += 1
    i = 0
    while lv.has(_j(path, f"vl_layer_{i}")):
        fill_vl_fuse(sd, f"{key}encoder.vl_layers.{i}.", lv, _j(path, f"vl_layer_{i}"))
        i += 1
    # USE_ADDITIONAL_BERT: `lang_layer_{i}` (a BERT layer) -> the reference
    # encoder's `lang_layers.{i}` with HF BERT names
    i = 0
    while lv.has(_j(path, f"lang_layer_{i}")):
        fill_bert_layer(sd, f"{key}encoder.lang_layers.{i}.", lv, _j(path, f"lang_layer_{i}"))
        i += 1
    i = 0
    while lv.has(_j(path, f"decoder_layer_{i}")):
        fill_decoder_layer(sd, f"{key}decoder.layers.{i}.", lv,
                           _j(path, f"decoder_layer_{i}"))
        i += 1


def fill_vl_align(sd, key, lv, path):
    _dense(sd, key + "dot_product_projection_text.", lv,
           _j(path, "dot_product_projection_text"))
    for n in ("log_scale", "bias_lang", "bias0"):
        sd[key + n] = lv.take(_j(path, n))


def fill_heads(sd, key, lv, path):
    """class_embed.{i} (VLAlign) and .{dec} (the encoder's head: a
    StillClassifier, or a VLAlign when the tree's `enc_class_embed` is one,
    STILL_CLS_FOR_ENCODER off), bbox_embed.{0..dec}, and iou_head.{i} when
    the tree has the IoU branch (`iou_head_0`)."""
    dec = 0
    iou = lv.has(_j(path, "iou_head_0"))
    while lv.has(_j(path, f"class_embed_{dec}")):
        fill_vl_align(sd, f"{key}class_embed.{dec}.", lv, _j(path, f"class_embed_{dec}"))
        if iou:
            _dense(sd, f"{key}iou_head.{dec}.", lv, _j(path, f"iou_head_{dec}"))
        dec += 1
    enc = _j(path, "enc_class_embed")
    if lv.has(_j(enc, "body")):
        _dense(sd, f"{key}class_embed.{dec}.body.", lv, _j(enc, "body"))
    else:
        fill_vl_align(sd, f"{key}class_embed.{dec}.", lv, enc)
    for i in range(dec + 1):
        _mlp(sd, f"{key}bbox_embed.{i}.", lv, _j(path, f"bbox_embed_{i}"))


def fill_mask_head(sd, key, lv, path):
    """The controller MLP and the five 3x3 convolutions of the mask head."""
    _mlp(sd, key + "controller.", lv, _j(path, "controller"))
    for n in ("lay1", "lay2", "lay3", "lay4", "jia_dcn"):
        _conv(sd, f"{key}mask_head.{n}.", lv, _j(path, f"mask_head/{n}"))


def fill_reid(sd, key, lv, path):
    """The reid head: [DeformableReidHead, MLP] when the tree has
    `reid_dec_0`, else the MLP alone."""
    if lv.has(_j(path, "reid_dec_0")):
        i = 0
        while lv.has(_j(path, f"reid_dec_{i}")):
            fill_decoder_layer(sd, f"{key}reid_embed_head.0.layers.{i}.", lv,
                               _j(path, f"reid_dec_{i}"))
            i += 1
        _mlp(sd, key + "reid_embed_head.0.ref_point_head.", lv,
             _j(path, "reid_ref_point_head"))
        _mlp(sd, key + "reid_embed_head.1.", lv, _j(path, "reid_embed"))
    else:
        _mlp(sd, key + "reid_embed_head.", lv, _j(path, "reid_embed"))


# the SOT/VOS template branch (`uninext_tpu/models/detr.py:294-307`)
TEMPLATE_BRANCH = ("template_backbone", "sot_fuser", "adjust_layer")


def fill_template(sd, key, lv, path, fill_backbone):
    """The template branch as the tree holds it: `template_backbone` (filled
    by `fill_backbone`, the main backbone's family), the fuser's
    `sot_fuser/refine_{i}`, and `adjust_layer`."""
    tb = _j(path, "template_backbone")
    if lv.has(tb):
        fill_backbone(sd, key + ROOT + "ref_backbone.0.backbone.", lv, tb)
    i = 0
    while lv.has(_j(path, f"sot_fuser/refine_{i}")):
        _conv(sd, f"{key}detr.sot_fuser.refine.{i}.", lv, _j(path, f"sot_fuser/refine_{i}"))
        i += 1
    _dense(sd, key + "detr.adjust_layer.", lv, _j(path, "adjust_layer"))


def fill_model(sd, key, lv, path):
    """The whole detection model (`UninextDETR` of the JAX package), with
    the backbone the tree holds and, if it has them, the mask head, the
    reid head and the SOT/VOS template branch."""
    fill_backbone = backbone_filler(lv, _j(path, "backbone"))
    if any(lv.has(_j(path, n)) for n in TEMPLATE_BRANCH):
        fill_template(sd, key, lv, path, fill_backbone)
    fill_backbone(sd, key + ROOT + "backbone.0.backbone.", lv, _j(path, "backbone"))
    i = 0
    while lv.has(_j(path, f"input_proj_{i}")):
        _conv(sd, f"{key}{ROOT}input_proj.{i}.0.", lv, _j(path, f"input_proj_{i}"))
        _norm(sd, f"{key}{ROOT}input_proj.{i}.1.", lv, _j(path, f"input_gn_{i}"))
        i += 1
    fill_bert(sd, key + BERT_ROOT, lv, _j(path, "bert"))
    fill_transformer(sd, key + ROOT + "transformer.", lv, _j(path, "transformer"))
    fill_heads(sd, key + ROOT, lv, path)
    # a tree of the video training path has no DN label encoder (that step
    # makes no DN queries, so flax never creates `dn_resizer`); every other
    # tree must hold it
    if lv.has(_j(path, "dn_resizer")) or not lv.has(_j(path, "reid_embed")):
        _dense(sd, key + DN_ROOT + "fc.", lv, _j(path, "dn_resizer/fc"))
        _norm(sd, key + DN_ROOT + "layer_norm.", lv, _j(path, "dn_resizer/ln"))
    if lv.has(_j(path, "controller")):
        fill_mask_head(sd, key + "detr.", lv, path)
    if lv.has(_j(path, "reid_embed")):
        fill_reid(sd, key + "detr.", lv, path)


_RESNET_KEY = re.compile(r"detr\.detr\.(backbone|ref_backbone)\.0\.backbone\.(?:stem\.conv1|"
                         r"(res\d)\.(\d+)\.(conv\d|shortcut))(\.norm)?\.(\w+)")


def _resnet_leaf(port_key: str):
    """The JAX leaf of a ResNet parameter, e.g. `backbone/res2_block0/bn1/mean`
    for `detr.detr.backbone.0.backbone.res2.0.conv1.norm.running_mean`, or
    under `template_backbone/` for the template backbone's
    (`detr.detr.ref_backbone.0.backbone.*`); None for any other key."""
    m = _RESNET_KEY.fullmatch(port_key)
    if m is None:
        return None
    root, stage, block, conv, norm, leaf = m.groups()
    if stage is None:
        module = "stem_bn" if norm else "stem_conv"
    else:
        module = f"{stage}_block{block}/{_RESNET_BN[conv] if norm else conv}"
    leaf = {d: s for s, d in _FROZEN_BN}[leaf] if norm else "kernel"
    return f"{'template_' if root == 'ref_backbone' else ''}backbone/{module}/{leaf}"


_CONVNEXT_KEY = re.compile(r"detr\.detr\.(backbone|ref_backbone)\.0\.backbone\.(?:"
                           r"downsample_layers\.(\d)\.(\d)|stages\.(\d)\.(\d+)\.(\w+)|"
                           r"norm(\d))\.(weight|bias)")


def _convnext_leaf(port_key: str):
    """The JAX leaf of a ConvNeXt parameter, e.g. `backbone/stem_norm/scale`
    for `detr.detr.backbone.0.backbone.downsample_layers.0.1.weight`,
    `backbone/stage2_block5/gamma` for `...stages.2.5.gamma.weight`, or
    under `template_backbone/` for the template backbone's; None for any
    other key."""
    m = _CONVNEXT_KEY.fullmatch(port_key)
    if m is None:
        return None
    root, down, pos, stage, block, part, norm, leaf = m.groups()
    prefix = f"{'template_' if root == 'ref_backbone' else ''}backbone/"
    if down is not None:            # the stem is (conv, norm), the others (norm, conv)
        is_norm = (down == "0") == (pos == "1")
        kind = "norm" if is_norm else "conv"
        module = f"stem_{kind}" if down == "0" else f"down_{kind}_{down}"
    elif stage is not None:
        if part == "gamma":         # a parameter of the block itself
            return f"{prefix}stage{stage}_block{block}/gamma"
        module, is_norm = f"stage{stage}_block{block}/{part}", part == "norm"
    else:
        module, is_norm = f"out_norm_res{int(norm) + 2}", True
    name = "bias" if leaf == "bias" else "scale" if is_norm else "kernel"
    return f"{prefix}{module}/{name}"


# port-key patterns -> the JAX module each is filled from (by `fill_model`
# and the fill functions it calls); the rest of the key keeps the port's
# names. First match wins.
_MODULE_PATHS = tuple((re.compile(p), r) for p, r in (
    (r"detr\.detr\.backbone\.0\.backbone\.(.*)", r"backbone/\1"),
    (r"detr\.detr\.ref_backbone\.0\.backbone\.(.*)", r"template_backbone/\1"),
    (r"detr\.sot_fuser\.refine\.(\d+)\.(.*)", r"sot_fuser/refine_\1/\2"),
    (r"detr\.adjust_layer\.(.*)", r"adjust_layer/\1"),
    (r"detr\.controller\.layers\.(\d+)\.(.*)", r"controller/layer_\1/\2"),
    (r"detr\.mask_head\.(.*)", r"mask_head/\1"),
    (r"detr\.reid_embed_head\.0\.layers\.(\d+)\.(.*)", r"reid_dec_\1/\2"),
    (r"detr\.reid_embed_head\.0\.ref_point_head\.layers\.(\d+)\.(.*)",
     r"reid_ref_point_head/layer_\1/\2"),
    (r"detr\.reid_embed_head\.(?:1\.)?layers\.(\d+)\.(.*)", r"reid_embed/layer_\1/\2"),
    (r"text_encoder\.body\.model\.(.*)", r"bert/\1"),
    (r"detr\.resizer\.(.*)", r"dn_resizer/\1"),
    (r"detr\.detr\.transformer\.encoder\.vl_layers\.(\d+)\.b_attn\.(.*)",
     r"transformer/vl_layer_\1/\2"),
    (r"detr\.detr\.transformer\.encoder\.lang_layers\.(\d+)\.(.*)",
     r"transformer/lang_layer_\1/\2"),
    (r"detr\.detr\.transformer\.encoder\.layers\.(\d+)\.(.*)",
     r"transformer/encoder_layer_\1/\2"),
    (r"detr\.detr\.transformer\.decoder\.layers\.(\d+)\.(.*)",
     r"transformer/decoder_layer_\1/\2"),
    (r"detr\.detr\.transformer\.(.*)", r"transformer/\1"),
    (r"detr\.detr\.input_proj\.(\d+)\.0\.(.*)", r"input_proj_\1/\2"),
    (r"detr\.detr\.input_proj\.(\d+)\.1\.(.*)", r"input_gn_\1/\2"),
    (r"detr\.detr\.(.*)", r"\1"),
))


def jax_module_path(port_key: str) -> str:
    """The JAX module path a port parameter of `UninextDETR` is filled from,
    e.g. `transformer/vl_layer_0/attn/v_proj/weight` for
    `detr.detr.transformer.encoder.vl_layers.0.b_attn.attn.v_proj.weight`
    (module names as the JAX tree's, the leaf as the port's; the additional
    BERT layers' `transformer/lang_layer_{i}/...` hold no "bert", so they
    fall in the optimizer's "base" group, as in JAX), and the JAX
    leaf itself for the ResNets' and ConvNeXts' (`_resnet_leaf`,
    `_convnext_leaf`): the optimizer's
    `classify_param` keys on `/mean`, `/var`, `/stem` and `res2_block`, and
    puts `template_backbone/*` in its backbone and frozen groups as the
    main backbone's, `sot_fuser` and `adjust_layer` in "base"."""
    leaf = _resnet_leaf(port_key) or _convnext_leaf(port_key)
    if leaf is not None:
        return leaf
    for pattern, repl in _MODULE_PATHS:
        m = pattern.fullmatch(port_key)
        if m:
            return m.expand(repl).replace(".", "/")
    raise KeyError(f"no JAX module for port parameter {port_key!r}")


def state_dict_from_jax(params, fill: Callable = fill_model
                        ) -> Dict[str, torch.Tensor]:
    """Run `fill` over a JAX tree; every leaf must be consumed."""
    lv = _Leaves(params)
    sd: Dict[str, np.ndarray] = {}
    fill(sd, "", lv, "")
    lv.check_empty()
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def load_jax_params(module: torch.nn.Module, params,
                    fill: Callable = fill_model, mesh=None) -> None:
    """Fill `module` (by default a whole `UninextDETR`) from a JAX tree.
    Raises if a JAX leaf is left over or a port parameter is not filled,
    with one exception: a video tree (one with the reid head) initialised
    through the video training path has no DN label encoder (that step makes
    no DN queries, so flax never creates `dn_resizer`), and the port's
    `detr.resizer.*` then keeps the values it has. An image tree without
    `dn_resizer` raises. A module cut over a `mesh`'s model group
    (`parallel/sharding.py:shard_module`) is filled from the whole tree,
    each parameter cut to the rank's shard."""
    sd = state_dict_from_jax(params, fill)
    if mesh is not None:
        from ..parallel.sharding import cut_state_dict
        sd = cut_state_dict(module, sd, mesh)
    with torch.no_grad():
        missing, unexpected = module.load_state_dict(sd, strict=False)
    if fill is fill_model and any(k.startswith(REID_ROOT) for k in sd):
        missing = [k for k in missing if not k.startswith(DN_ROOT)]
    if missing or unexpected:
        raise RuntimeError(f"port parameters not filled: {missing}; "
                           f"keys the port does not have: {unexpected}")


# ---- reference checkpoints (.pth) --------------------------------------------------

def require_real_vocab_for(sd: Dict) -> None:
    """`uninext_tpu/engine/convert.py:507 _require_real_vocab_for`: refuse a
    state dict whose BERT word-embedding table was trained against a real
    WordPiece vocab when the tokenizer has none (the hash-vocab fallback of
    `data/tokenizer.py` would silently mis-tokenize every prompt), unless
    `UNINEXT_ALLOW_HASH_VOCAB=1` (for synthetic fixtures)."""
    import os
    if os.environ.get("UNINEXT_ALLOW_HASH_VOCAB") == "1":
        return
    probe = "embeddings.word_embeddings.weight"
    if not any(k.endswith(probe) for k in sd):
        return                      # no language tower in this checkpoint
    from ..data.tokenizer import BertTokenizer
    if BertTokenizer().vocab is None:
        raise RuntimeError(
            "This checkpoint carries a BERT word-embedding table trained "
            "against a real WordPiece vocab, but no vocab.txt is available "
            "— the hash-vocab fallback would silently mis-tokenize every "
            "prompt. Supply bert-base-uncased vocab.txt via the "
            "UNINEXT_BERT_VOCAB env var (see docs/DATA.md), or set "
            "UNINEXT_ALLOW_HASH_VOCAB=1 only for synthetic fixtures.")


def _listed(names, limit: int = 20) -> str:
    shown = ", ".join(str(n) for n in names[:limit])
    return shown + (f", ... ({len(names) - limit} more)" if len(names) > limit else "")


@torch.no_grad()
def load_reference_state_dict(model: torch.nn.Module, sd: Dict, mesh=None,
                              verbose: bool = True) -> Dict:
    """Copy every tensor of `sd` (the reference's names, which are the
    port's) whose name and shape `model` has into it, in the model's dtype.
    Returns the report of `uninext_tpu/engine/convert.py:444
    convert_checkpoint`: {"loaded": count, "missing": the model's tensors
    `sd` lacks (left as they were), "shape_mismatch": [(name, model shape,
    file shape)], "unused_source": `sd`'s names the model lacks}, with
    `num_batches_tracked` ignored as there. A model cut over a `mesh`'s
    model group gets each tensor cut to the rank's shard."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          for k, v in sd.items()}
    if mesh is not None:
        from ..parallel.sharding import cut_state_dict
        sd = cut_state_dict(model, sd, mesh)
    target = model.state_dict()
    report = {"loaded": 0, "missing": [], "shape_mismatch": [], "unused_source": []}
    for name, t in target.items():
        if name not in sd:
            report["missing"].append(name)
            continue
        s = sd[name]
        if tuple(s.shape) != tuple(t.shape):
            report["shape_mismatch"].append((name, tuple(t.shape), tuple(s.shape)))
            continue
        t.copy_(s.to(dtype=t.dtype))
        report["loaded"] += 1
    report["unused_source"] = sorted(k for k in sd if k not in target
                                     and not k.endswith("num_batches_tracked"))
    if verbose:
        print(f"[convert] loaded {report['loaded']} tensors; "
              f"{len(report['missing'])} missing, "
              f"{len(report['shape_mismatch'])} shape mismatches, "
              f"{len(report['unused_source'])} unused")
        for what in ("missing", "shape_mismatch", "unused_source"):
            if report[what]:
                print(f"[convert] {what}: {_listed(report[what])}")
    return report


def read_reference_checkpoint(path: str) -> Dict:
    """The state dict of a detectron2-style `{"model": state_dict, ...}`
    `.pth` (the reference's checkpoints, and this package's
    `CheckpointManager` files) or of a bare state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if "model" in sd else sd


def load_reference_checkpoint(model: torch.nn.Module, path: str, mesh=None,
                              verbose: bool = True) -> Dict:
    """`uninext_tpu/engine/convert.py:535 load_torch_checkpoint` for the
    port: read a reference `.pth` (`read_reference_checkpoint`) and load it
    into `model` by name and shape (`load_reference_state_dict`), refusing a
    BERT table under the hash vocab (`require_real_vocab_for`). Returns
    the report."""
    sd = read_reference_checkpoint(path)
    require_real_vocab_for(sd)
    return load_reference_state_dict(model, sd, mesh, verbose)
