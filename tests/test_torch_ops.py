"""Parity of the port's ops and small layers with the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its PyTorch
counterpart in float32. On CPU tensors the kernel wrappers run their plain
versions, so these tests hold each plain version to the JAX semantics; the
kernels themselves are held to the plain versions on the card
(tests/test_torch_kernels_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_common import (MSDA_GEOMETRIES, TINY_LEVELS, msda_locations,
                                     one_torch_thread, perturb)
from uninext_tpu.models import layers as jlayers
from uninext_tpu.models import position_encoding as jpos
from uninext_tpu.models import vit as jvit
from uninext_tpu.ops import msda as jmsda
from uninext_tpu.ops import nms as jnms
from uninext_tpu.utils import box_ops as jbox
from uninext_tpu.utils import misc as jmisc
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.models import layers, position_encoding, vit
from uninext_tpu_torch.ops import msda, nms
from uninext_tpu_torch.utils import box_ops, misc

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


# ---- small parts -----------------------------------------------------------

def test_box_ops_match_jax_bit_for_bit():
    """NMS rests on box_iou's fp32 expression: identical op order gives
    identical bits."""
    rng = np.random.RandomState(0)
    cxcywh = rng.uniform(0.05, 0.6, (3, 40, 4)).astype(np.float32)
    xyxy = _np(box_ops.box_cxcywh_to_xyxy(torch.from_numpy(cxcywh)))
    np.testing.assert_array_equal(xyxy, np.asarray(jbox.box_cxcywh_to_xyxy(cxcywh)))
    iou, union = box_ops.box_iou(torch.from_numpy(xyxy), torch.from_numpy(xyxy))
    jiou, junion = jbox.box_iou(xyxy, xyxy)
    np.testing.assert_array_equal(_np(iou), np.asarray(jiou))
    np.testing.assert_array_equal(_np(union), np.asarray(junion))


def test_misc_match_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.2, 1.2, (5, 7)).astype(np.float32)
    # elementwise log of the same fp32 ratios: 1 ulp-level agreement
    np.testing.assert_allclose(_np(misc.inverse_sigmoid(torch.from_numpy(x))),
                               np.asarray(jmisc.inverse_sigmoid(x)), atol=1e-6)
    feats = rng.randn(2, 9, 6).astype(np.float32)
    mask = (rng.rand(2, 9) > 0.4).astype(np.int32)
    # masked mean of 9 terms: summation order only
    np.testing.assert_allclose(
        _np(misc.agg_lang_feat(torch.from_numpy(feats), torch.from_numpy(mask))),
        np.asarray(jmisc.agg_lang_feat(feats, mask)), atol=1e-6)


def test_stable_topk_orders_ties_like_lax_top_k():
    """Trap: lax.top_k and argsort put the lower index first among ties,
    torch.topk promises nothing. The two-stage top-k really ties (rows
    zeroed at invalid proposals), so the port sorts stably."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 4, (3, 200)).astype(np.float32)      # many ties
    got = _np(misc.stable_topk_indices(torch.from_numpy(x), 50))
    want = np.asarray(jax.lax.top_k(x, 50)[1])
    np.testing.assert_array_equal(got, want)


def test_position_embedding_sine_matches_jax():
    rng = np.random.RandomState(3)
    mask = np.zeros((2, 6, 9), bool)
    mask[0, 4:] = True
    mask[0, :, 7:] = True
    mask[1] = rng.rand(6, 9) > 0.8
    got = position_encoding.position_embedding_sine(torch.from_numpy(mask), 16)
    want = jpos.position_embedding_sine(mask, 16)
    # sin/cos of up to 2*pi arguments through two pow implementations
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


def test_get_sine_pos_embed_matches_jax():
    pos = np.random.RandomState(4).rand(2, 5, 4).astype(np.float32)
    got = layers.get_sine_pos_embed(torch.from_numpy(pos))
    want = jlayers.get_sine_pos_embed(pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


# ---- MSDA (the plain version, the card kernel's yardstick) -------------------

SHAPES = ((6, 7), (3, 4), (2, 2))


def _msda_inputs(seed, Lq=11, M=2, D=8, P=3, geometry="uniform"):
    """value, loc, att and the level shapes. "uniform" at SHAPES is the
    original draw; the other geometries come from `msda_locations` ("tiny"
    at its levels of 1x1, 1x2 and odd widths)."""
    rng = np.random.RandomState(seed)
    shapes = TINY_LEVELS if geometry == "tiny" else SHAPES
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(2, S, M, D).astype(np.float32)
    if geometry == "uniform":
        # about a fifth of the samples fall outside [0, 1]: zero-padding path
        loc = rng.uniform(-0.15, 1.15, (2, Lq, M, L, P, 2)).astype(np.float32)
    else:
        loc = msda_locations(rng, shapes, 2, Lq, M, P, geometry)
    att = rng.rand(2, Lq, M, L, P).astype(np.float32)
    att /= att.reshape(2, Lq, M, -1).sum(-1)[..., None, None]
    return value, loc, att, shapes


_JAX_MSDA = ("ms_deform_attn", "ms_deform_attn_unpacked")


@pytest.mark.parametrize("jax_fn,geometry", [
    *(pytest.param(fn, "uniform", id=fn) for fn in _JAX_MSDA),
    *(pytest.param(fn, geo, id=f"{fn}-{geo}") for geo in MSDA_GEOMETRIES[1:]
      for fn in _JAX_MSDA)])
def test_msda_plain_matches_jax(jax_fn, geometry):
    """Uniform locations, samples clustered in 2 x 2 pixels (also across the
    frame's edge), levels of 1x1 and 1x2 with odd widths, and locations on
    the frame's edges, pixel edges and pixel centres."""
    value, loc, att, shapes = _msda_inputs(5, geometry=geometry)
    got = msda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                    torch.from_numpy(loc), torch.from_numpy(att))
    want = getattr(jmsda, jax_fn)(jnp.asarray(value), shapes, jnp.asarray(loc),
                                  jnp.asarray(att))
    # fp32 bilinear sums of 4 corners x 9 or 12 samples; grid_sample rescales
    # the location through [-1, 1], which moves the last bits of the weights
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_msda_wrapper_runs_plain_on_cpu_and_counts_nothing():
    value, loc, att, _ = _msda_inputs(6)
    before = msda.ms_deform_attn.launches
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
            torch.from_numpy(att))
    torch.testing.assert_close(msda.ms_deform_attn(*args),
                               msda.ms_deform_attn_plain(*args), rtol=0, atol=0)
    assert msda.ms_deform_attn.launches == before == 0


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn_module_matches_jax(ref_dim):
    d, M, L, P = 32, 4, len(SHAPES), 2
    S = sum(h * w for h, w in SHAPES)
    rng = np.random.RandomState(7 + ref_dim)
    query = rng.randn(2, 9, d).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, 9, L, ref_dim)).astype(np.float32)
    src = rng.randn(2, S, d).astype(np.float32)
    vmask = rng.rand(2, S) > 0.8
    jm = jlayers.MSDeformAttnModule(d_model=d, n_levels=L, n_heads=M, n_points=P)
    params = perturb(jm.init(jax.random.PRNGKey(0), query, ref, src, vmask, SHAPES),
                     scale=0.3)
    want = jm.apply(params, query, ref, src, vmask, SHAPES)
    tm = layers.MSDeformAttn(d, L, M, P)
    convert.load_jax_params(tm, params, fill=convert.fill_msda)
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref),
                 torch.from_numpy(src), torch.from_numpy(vmask), SHAPES)
    # two fp32 projections around the sampled sums
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_multihead_attention_matches_jax_with_blocking_mask():
    """Bool mask, True = blocked (uninext_tpu/models/layers.py:136-162)."""
    rng = np.random.RandomState(9)
    q = rng.randn(2, 7, 32).astype(np.float32)
    k = rng.randn(2, 7, 32).astype(np.float32)
    v = rng.randn(2, 7, 32).astype(np.float32)
    mask = rng.rand(7, 7) > 0.6
    np.fill_diagonal(mask, False)
    jm = jlayers.MultiHeadAttention(32, 4)
    params = perturb(jm.init(jax.random.PRNGKey(1), q, k, v, mask))
    want = jm.apply(params, q, k, v, mask)
    p = params["params"]
    sd = {"in_proj_weight": np.concatenate(
              [np.asarray(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")]),
          "in_proj_bias": np.concatenate(
              [np.asarray(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]),
          "out_proj.weight": np.asarray(p["out_proj"]["kernel"]).T,
          "out_proj.bias": np.asarray(p["out_proj"]["bias"])}
    tm = layers.MultiHeadAttention(32, 4)
    tm.load_state_dict({k_: torch.from_numpy(v_) for k_, v_ in sd.items()})
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# ---- NMS (the plain version) --------------------------------------------------

def _nms_inputs(seed, N=120):
    """Random boxes in 3 classes, 10% invalid, plus pairs whose IoU sits a
    few ulps either side of 0.7 (a shift d of a unit box gives
    IoU = (1-d)/(1+d)) and one pair whose IoU is 0.7f exactly (inter 7/256
    over union 10/256, both exact)."""
    rng = np.random.RandomState(seed)
    cxcywh = np.concatenate([rng.uniform(0.2, 0.8, (N, 2)),
                             rng.uniform(0.05, 0.3, (N, 2))], 1)
    boxes = np.array(jbox.box_cxcywh_to_xyxy(cxcywh.astype(np.float32)))
    d0 = np.float32(0.3 / 1.7)
    for t in range(12):
        d = np.nextafter(d0, np.float32(1), dtype=np.float32) if t % 2 else d0
        d = np.float32(d + np.float32(t - 6) * np.float32(1e-7))
        base = np.float32(t * 0.05)
        boxes[2 * t] = [base, base, base + 1, base + 1]
        boxes[2 * t + 1] = [base + d, base, base + d + 1, base + 1]
    boxes[24] = [0, 0, 10 / 16, 1 / 16]
    boxes[25] = [3 / 16, 0, 10 / 16, 1 / 16]
    scores = rng.rand(N).astype(np.float32)
    scores[::17] = scores[1]                               # equal scores
    classes = rng.randint(0, 3, N).astype(np.int64)
    classes[:26] = 1
    valid = rng.rand(N) > 0.1
    valid[24:26] = True
    return boxes.astype(np.float32), scores, classes, valid


# N = 120 (ids 0-2, as before) and the model's N = 900 queries
@pytest.mark.parametrize("seed,N", [(0, 120), (1, 120), (2, 120), (3, 900), (4, 900)],
                         ids=["0", "1", "2", "3-900", "4-900"])
def test_nms_plain_matches_jax_exactly(seed, N):
    per_image = [_nms_inputs(seed * 10 + i, N) for i in range(2)]
    stack = [np.stack(x) for x in zip(*per_image)]
    boxes, scores, classes, valid = (torch.from_numpy(a) for a in stack)
    got = _np(nms.batched_nms_plain(boxes, scores, classes, 0.7, valid))
    for i, (b, s, c, v) in enumerate(per_image):
        want = np.asarray(jnms.batched_nms(b, s, c.astype(np.int32), 0.7, v))
        np.testing.assert_array_equal(got[i], want)
    assert got.any() and not got.all()


def test_nms_wrapper_runs_plain_on_cpu_and_counts_nothing():
    boxes, scores, classes, valid = (torch.from_numpy(a) for a in _nms_inputs(3))
    args = (boxes[None], scores[None], classes[None], 0.7, valid[None])
    assert torch.equal(nms.batched_nms(*args), nms.batched_nms_plain(*args))
    assert nms.batched_nms.launches == 0


# ---- rel-pos attention (kernel A's plain version) ----------------------------

def _plain_flash(q, k, v, ab=None, segment_ids=None, *, causal=False,
                 sm_scale=1.0, block_sizes=None, debug=False):
    """Plain-XLA stand-in for the stock Pallas TPU flash kernel, as
    tests/test_vit_parity.py runs it on the CPU."""
    attn = jnp.einsum("bhqd,bhkd->bhqk", q * sm_scale, k)
    attn = jax.nn.softmax(attn.astype(jnp.float32), -1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", attn, v)


def _attn_inputs(seed, H, W, nh=4, hd=8):
    rng = np.random.RandomState(seed)
    S = H * W
    return (rng.randn(2, H, W, nh, hd).astype(np.float32),
            rng.randn(2, S, nh, hd).astype(np.float32),
            rng.randn(2, S, nh, hd).astype(np.float32),
            rng.randn(H, H, hd).astype(np.float32),
            rng.randn(W, W, hd).astype(np.float32))


def test_rel_pos_plain_matches_jax_flash_formulation(monkeypatch):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa_mod
    monkeypatch.setattr(fa_mod, "flash_attention", _plain_flash)
    H, W = 9, 11                 # S = 99, not a multiple of 256: key padding
    q, k, v, Rh, Rw = _attn_inputs(10, H, W)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = jvit.flash_rel_pos_attention(*(jnp.asarray(a) for a in (q, k, v, Rh, Rw)),
                                        scale)
    got = vit.rel_pos_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, Rh, Rw)),
                                      scale)
    # softmax over 99 keys of unit-scale logits, fp32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_pos_bias_matches_einsums(dtype):
    """Kernel A's bias tables (two batched products, read by the kernels
    through their strides) equal the einsums of the plain version, from the
    slices of one qkv tensor as in Attention. fp32 products of at most 8
    terms: 1e-5."""
    B, H, W, nh, hd = 2, 5, 7, 3, 8
    rng = np.random.RandomState(16)
    qkv = torch.from_numpy(rng.randn(B, H * W, 3, nh, hd).astype(np.float32)).to(dtype)
    q = qkv.unbind(2)[0].reshape(B, H, W, nh, hd)
    Rh = torch.from_numpy(rng.randn(H, H, hd).astype(np.float32)).to(dtype)
    Rw = torch.from_numpy(rng.randn(W, W, hd).astype(np.float32)).to(dtype)
    bh, bw = vit.rel_pos_bias(q, Rh, Rw)
    assert bh.dtype == bw.dtype == torch.float32
    assert bh.shape == (B, nh, H, W, H) and bw.shape == (B, nh, H, W, W)
    assert bh.stride(-1) == bw.stride(-1) == 1
    qf = q.float()
    torch.testing.assert_close(bh, torch.einsum("byxhd,yid->bhyxi", qf, Rh.float()),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(bw, torch.einsum("byxhd,xjd->bhyxj", qf, Rw.float()),
                               rtol=0, atol=1e-5)


def test_rel_pos_wrapper_runs_plain_on_cpu_and_counts_nothing():
    q, k, v, Rh, Rw = (torch.from_numpy(a) for a in _attn_inputs(11, 5, 6))
    got = vit.flash_rel_pos_attention(q, k, v, Rh, Rw, 0.3)
    assert torch.equal(got, vit.rel_pos_attention_plain(q, k, v, Rh, Rw, 0.3))
    assert vit.flash_rel_pos_attention.launches == 0


def test_wrappers_refuse_other_devices():
    """No silent fallback: a device that is neither CPU nor CUDA raises."""
    q, k, v, Rh, Rw = (torch.from_numpy(a).to("meta") for a in _attn_inputs(12, 3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        vit.flash_rel_pos_attention(q, k, v, Rh, Rw, 0.3)
    value, loc, att = (torch.from_numpy(a).to("meta") for a in _msda_inputs(13)[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        msda.ms_deform_attn(value, SHAPES, loc, att)
    b, s, c, val = (torch.from_numpy(a)[None].to("meta") for a in _nms_inputs(14))
    with pytest.raises(ValueError, match="unsupported device"):
        nms.batched_nms(b, s, c, 0.7, val)


@pytest.mark.parametrize("span,size", [(15, 5), (127, 50), (7, 6)])
def test_interp_rel_pos_matches_jax_resize(span, size):
    """Trap: jax.image.resize(..., "linear") antialiases when it shrinks (a
    triangle widened by 1/scale); F.interpolate(mode="linear") does not.
    The port reproduces the JAX package. 15 -> 9 and 127 -> 99 shrink
    (127 -> 99 is ViT-H's global table at 800x1216); 7 -> 11 grows."""
    table = np.random.RandomState(span).randn(span, 16).astype(np.float32)
    got = _np(vit.interp_rel_pos(torch.from_numpy(table), size))
    want = np.asarray(jvit.interp_rel_pos(jnp.asarray(table), size))
    # a (2*size-1) x span weighted sum in fp32
    np.testing.assert_allclose(got, want, atol=1e-5)
    naive = F.interpolate(torch.from_numpy(table).T[None], size=2 * size - 1,
                          mode="linear", align_corners=False)[0].T.numpy()
    if 2 * size - 1 < span:
        assert np.abs(naive - want).max() > 0.05        # the trap is real
    else:
        np.testing.assert_allclose(naive, want, atol=1e-5)


def test_rel_pos_attention_module_matches_jax_xla_path():
    """Port Attention (through the wrapper) vs JAX Attention(use_flash=False)
    on a 5 x 7 grid with tables stored at span 15: both tables shrink."""
    x = np.random.RandomState(15).randn(2, 5, 7, 32).astype(np.float32)
    jm = jvit.Attention(32, 2, rel_pos_size=8, use_flash=False)
    params = perturb(jm.init(jax.random.PRNGKey(2), x), scale=0.2)
    want = jm.apply(params, x)
    p = params["params"]
    tm = vit.Attention(32, 2, rel_pos_size=8)
    sd = {"qkv.weight": np.asarray(p["qkv"]["kernel"]).T,
          "qkv.bias": np.asarray(p["qkv"]["bias"]),
          "proj.weight": np.asarray(p["proj"]["kernel"]).T,
          "proj.bias": np.asarray(p["proj"]["bias"]),
          "rel_pos_h": np.asarray(p["rel_pos_h"]),
          "rel_pos_w": np.asarray(p["rel_pos_w"])}
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    # fp32 attention over 35 keys plus two projections
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
