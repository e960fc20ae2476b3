"""The port's dynamic mask head (`uninext_tpu_torch/models/mask_head.py`,
`UninextDETR.predict_masks`) against the JAX package's on the CPU, fp32:
`aligned_bilinear`, `MaskHeadSmallConv` (both branches of its nearest
upsample: the repeat where the size divides, the index gather where it
does not, and the two mixed), `dynamic_mask_forward` and `predict_masks`.
Weights come from JAX inits, perturbed, through the weight bridge.
"""
import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import one_torch_thread, perturb
from uninext_tpu.config import MaskHeadConfig as JMaskHeadConfig
from uninext_tpu.config import tiny_test_config as jtiny
from uninext_tpu.models import mask_head as jmask
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu_torch.config import MaskHeadConfig, tiny_test_config
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.models import mask_head
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _close(got, want, rel=1e-5):
    """fp32 products of a few terms: summation order, relative to the
    largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_aligned_bilinear_matches_jax(factor):
    x = np.random.RandomState(factor).randn(2, 3, 7, 5).astype(np.float32)
    got = mask_head.aligned_bilinear(torch.from_numpy(x), factor)
    assert got.shape == (2, 3, 7 * factor, 5 * factor)
    _close(got, jmask.aligned_bilinear(x, factor))


# level sizes (s8, s16, s32): every step divides (repeat); (5, 7) -> (10, 14)
# divides and (3, 4) -> (5, 7) does not (gather); and the two mixed steps,
# where one axis divides and the other does not
LEVEL_SETS = {"divides": ((8, 12), (4, 6), (2, 3)),
              "gather": ((10, 14), (5, 7), (3, 4)),
              "mixed": ((10, 15), (5, 8), (3, 4))}


@pytest.mark.parametrize("levels", list(LEVEL_SETS))
def test_mask_head_small_conv_matches_jax(levels):
    rng = np.random.RandomState(7)
    feats = [rng.randn(2, h, w, 64).astype(np.float32) for h, w in LEVEL_SETS[levels]]
    jm = jmask.MaskHeadSmallConv(64)
    params = perturb(jm.init(jax.random.PRNGKey(0), feats))
    want = jax.jit(jm.apply)(params, feats)
    m = mask_head.MaskHeadSmallConv(64)

    def fill(sd, key, lv, path):
        for n in ("lay1", "lay2", "lay3", "lay4", "jia_dcn"):
            convert._conv(sd, f"{n}.", lv, n)

    convert.load_jax_params(m, params, fill=fill)
    with torch.no_grad():
        got = m([torch.from_numpy(f) for f in feats])
    assert got.shape == (2, *LEVEL_SETS[levels][0], 2)
    # five 3x3 convolutions of 64 channels in fp32
    _close(got, want, rel=1e-4)


@pytest.mark.parametrize("rel_coord,mask_out_stride", [(True, 4), (False, 4), (True, 8)])
def test_dynamic_mask_forward_matches_jax(rel_coord, mask_out_stride):
    """Three dynamic 1x1 layers per instance over [relative coordinates in
    input pixels, 8 mask channels], then `aligned_bilinear` by
    8 // mask_out_stride."""
    rng = np.random.RandomState(11)
    B, N, H, W, C = 2, 6, 9, 13, 8
    kw = dict(rel_coord=rel_coord, mask_out_stride=mask_out_stride)
    cfg, jcfg = MaskHeadConfig(**kw), JMaskHeadConfig(**kw)
    n_params = mask_head.num_gen_params(cfg, C)
    assert n_params == jmask.num_gen_params(jcfg, C)
    feats = rng.randn(B, H, W, C).astype(np.float32)
    centers = (rng.rand(B, N, 2) * [W * 8, H * 8]).astype(np.float32)
    # small enough that relative coordinates of ~100 px keep the logits O(10)
    params = (rng.randn(B, N, n_params) * 0.05).astype(np.float32)
    want = jax.jit(lambda *a: jmask.dynamic_mask_forward(*a, jcfg))(feats, centers, params)
    got = mask_head.dynamic_mask_forward(*map(torch.from_numpy, (feats, centers, params)), cfg)
    up = 8 // mask_out_stride
    assert got.shape == (B, N, H * up, W * up)
    _close(got, want)


@pytest.mark.parametrize("shapes", [((8, 12), (4, 6), (2, 3), (1, 2)),
                                    ((13, 19), (7, 10), (4, 5), (2, 3))],
                         ids=["divisible", "real"])
def test_predict_masks_matches_jax(shapes):
    """`predict_masks` of `tiny_test_config` (d_model 64) on the level
    shapes of a 64x96 input and on the real (ceil) shapes of a 100x150 one,
    with the controller and mask head of a JAX init carried by the bridge's
    `fill_mask_head`."""
    rng = np.random.RandomState(5)
    B, K, d = 2, 5, 64
    S = sum(h * w for h, w in shapes)
    memory = rng.randn(B, S, d).astype(np.float32)
    hs = rng.randn(B, K, d).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (B, K, 4)).astype(np.float32)
    sizes = np.array([[shapes[0][0] * 8 - 5, shapes[0][1] * 8 - 11],
                      [shapes[0][0] * 8, shapes[0][1] * 8]], np.int32)
    jm = JaxDETR(jtiny())
    args = (memory, shapes, hs, ref, sizes)
    params = perturb(jm.init(jax.random.PRNGKey(2), *args, method=JaxDETR.predict_masks))
    assert set(params["params"]) == {"controller", "mask_head"}
    want = jax.jit(lambda p, m, h, r, s: jm.apply(p, m, shapes, h, r, s,
                                                   method=JaxDETR.predict_masks))(
        params, memory, hs, ref, sizes)
    model = build_model(tiny_test_config(), "cpu")
    sd = convert.state_dict_from_jax(params, fill=convert.fill_mask_head)
    missing, unexpected = model.detr.load_state_dict(sd, strict=False)
    assert not unexpected
    assert not [k for k in missing if k.startswith(("controller.", "mask_head."))]
    with torch.no_grad():
        got = model.predict_masks(torch.from_numpy(memory), shapes, torch.from_numpy(hs),
                                  torch.from_numpy(ref), torch.from_numpy(sizes))
    assert got.shape == (B, K, shapes[0][0] * 2, shapes[0][1] * 2)
    _close(got, want, rel=1e-4)
