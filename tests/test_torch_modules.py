"""BERT, VLFuse, the deformable transformer and the heads of the port vs
the JAX modules, on the CPU, in float32, with weights carried by the bridge
(`uninext_tpu_torch/engine/convert.py`)."""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch import nn

from tests.torch_port_common import perturb, tiny_vit_config
from uninext_tpu.models import bert as jbert
from uninext_tpu.models import heads as jheads
from uninext_tpu.models import layers as jlayers
from uninext_tpu.models import transformer as jtrans
from uninext_tpu.models import vl_fusion as jvl
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.models import bert, heads, layers, transformer, vl_fusion
from uninext_tpu_torch.models.detr import UninextDETR

CFG = tiny_vit_config()


def _lang(seed, B=2, T=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1000, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), np.int32)
    mask[0, :10] = 1
    mask[1, :13] = 1
    return ids, mask


def test_bert_matches_jax():
    """2 layers, width 64, with the +/-50000 clamp and padded keys."""
    ids, mask = _lang(0)
    jm = jbert.BertEncoder(CFG.language)
    params = perturb(jm.init(jax.random.PRNGKey(0), ids, mask))
    want = jm.apply(params, ids, mask)
    tm = bert.BertModel(CFG.language)
    convert.load_jax_params(tm, params, fill=convert.fill_bert)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for key in ("hidden", "aggregate"):
        # two post-LN layers of fp32 matmuls (eps 1e-12)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_vl_fuse_matches_jax(scale):
    """Bi-attention with the clamps, the text-side max subtraction and the
    -9e15 mask on padded tokens. At input scale 1e-3 the variance (1e-6)
    is the size of the LayerNorm epsilon, so a torch default eps (1e-5)
    instead of flax's 1e-6 would show (trap 2)."""
    rng = np.random.RandomState(1)
    visual = rng.randn(2, 30, 64).astype(np.float32) * scale
    lang = rng.randn(2, 16, 64).astype(np.float32) * scale
    _, lmask = _lang(1)
    jm = jvl.VLFuse(CFG.transformer, CFG.language)
    params = perturb(jm.init(jax.random.PRNGKey(1), visual, lang, lmask), scale=0.2)
    want = jm.apply(params, visual, lang, lmask)
    tm = vl_fusion.VLFuse(CFG.transformer, CFG.language)
    convert.load_jax_params(tm, params, fill=convert.fill_vl_fuse)
    with torch.no_grad():
        got = tm(torch.from_numpy(visual), torch.from_numpy(lang),
                 torch.from_numpy(lmask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


class _JaxTransformerAndHeads(fnn.Module):
    """The transformer with the heads it calls, named as in UninextDETR so
    the bridge's `fill_heads` and `fill_transformer` apply."""

    @fnn.compact
    def __call__(self, srcs, masks, poses, lang_hidden, lang_mask):
        t = CFG.transformer
        bbox = [jlayers.MLP(t.d_model, 4, 3, name=f"bbox_embed_{i}")
                for i in range(t.dec_layers + 1)]
        trans = jtrans.UninextTransformer(t, CFG.language, remat=False,
                                          name="transformer")(
            srcs, masks, poses, lang_hidden, lang_mask, "detection",
            enc_class_head=jheads.StillClassifier(name="enc_class_embed"),
            enc_bbox_head=bbox[t.dec_layers], bbox_heads=bbox[:t.dec_layers])
        logits = [jheads.VLAlign(t, lang_dim=CFG.language.hidden_dim,
                                 name=f"class_embed_{i}")(
                      trans["hs"][i], trans["lang_hidden"])
                  for i in range(t.dec_layers)]
        ious = [fnn.Dense(1, name=f"iou_head_{i}")(trans["hs"][i])
                for i in range(t.dec_layers)]
        return trans, logits, ious


class _TorchTransformerAndHeads(nn.Module):
    def __init__(self):
        super().__init__()
        t = CFG.transformer
        self.transformer = transformer.UninextTransformer(t, CFG.language)
        self.class_embed = nn.ModuleList(
            [heads.VLAlign(t, CFG.language.hidden_dim) for _ in range(t.dec_layers)]
            + [heads.StillClassifier(t.d_model)])
        self.bbox_embed = nn.ModuleList(
            layers.MLP(t.d_model, t.d_model, 4, 3) for _ in range(t.dec_layers + 1))
        self.iou_head = nn.ModuleList(layers.Linear(t.d_model, 1)
                                      for _ in range(t.dec_layers))

    def forward(self, srcs, masks, poses, lang_hidden, lang_mask):
        t = CFG.transformer
        trans = self.transformer(srcs, masks, poses, lang_hidden, lang_mask,
                                 enc_class_head=self.class_embed[t.dec_layers],
                                 enc_bbox_head=self.bbox_embed[t.dec_layers],
                                 bbox_heads=self.bbox_embed[:t.dec_layers])
        logits = [self.class_embed[i](trans["hs"][i], trans["lang_hidden"])
                  for i in range(t.dec_layers)]
        ious = [self.iou_head[i](trans["hs"][i]) for i in range(t.dec_layers)]
        return trans, logits, ious


def _fill_transformer_and_heads(sd, key, lv, path):
    convert.fill_transformer(sd, key + "transformer.", lv, "transformer")
    convert.fill_heads(sd, key, lv, path)


def test_transformer_and_heads_match_jax():
    """VLFuse + 2 scan-stacked encoder layers (unstacked by the bridge),
    two-stage top-60 over 128 tokens with padded image 0, 2 decoder layers
    with box refinement, VLAlign / StillClassifier / IoU heads."""
    rng = np.random.RandomState(2)
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    d = CFG.transformer.d_model
    srcs = [rng.randn(2, h, w, d).astype(np.float32) for h, w in shapes]
    poses = [rng.randn(2, h, w, d).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((2, h, w), bool)
        m[0, (3 * h + 3) // 4:] = True
        m[0, :, (3 * w + 3) // 4:] = True
        masks.append(m)
    lang_hidden = rng.randn(2, 16, CFG.language.hidden_dim).astype(np.float32)
    _, lmask = _lang(2)
    args = (srcs, masks, poses, lang_hidden, lmask)
    jm = _JaxTransformerAndHeads()
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(2), *args))
    assert "encoder_scan" in params["params"]["transformer"]
    want = jax.jit(jm.apply)(params, *args)
    tm = _TorchTransformerAndHeads()
    convert.load_jax_params(tm, params, fill=_fill_transformer_and_heads)
    with torch.no_grad():
        got = tm(*([torch.from_numpy(a) for a in x] if isinstance(x, list)
                   else torch.from_numpy(x) for x in args))
    for key in ("memory", "enc_class", "enc_coord_unact", "init_reference",
                "inter_references", "hs", "lang_hidden"):
        # fp32 through 2 + 2 layers; a top-k that picked another proposal
        # would move init_reference by far more than this
        np.testing.assert_allclose(got[0][key].numpy(), np.asarray(want[0][key]),
                                   atol=1e-4, err_msg=key)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_norm_epsilons_follow_flax():
    """Trap 2: flax LayerNorm/GroupNorm default to eps 1e-6, torch to 1e-5.
    Every norm of the port carries the JAX value: 1e-12 in BERT (its config)
    and the FeatureResizer, 1e-6 everywhere else (ViT, VLFuse, encoder,
    decoder, enc_output_norm, the input projections' GroupNorm)."""
    with torch.device("meta"):
        model = UninextDETR(CFG)
    seen = 0
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            want = (CFG.language.layer_norm_eps if name.startswith("text_encoder")
                    else 1e-12 if name.endswith("resizer.layer_norm") else 1e-6)
            assert mod.eps == want, (name, mod.eps)
            seen += 1
    assert seen > 20
