"""The port's ViT backbone vs the JAX `ViT`, on the CPU, through the bridge.

Small ViT: embed 32, depth 4, 2 heads, window 4, blocks 1 and 3 global.
The global blocks store their rel-pos tables at span 2*8-1 = 15, larger
than the runtime grid, so the tables shrink and the antialiased resize of
the JAX package (trap 1) is exercised; the abs-pos table is resized
bicubically from the 14 x 14 pretrain grid. The 80 x 112 input gives a
5 x 7 grid, which the windowed blocks must pad to 8 x 8.
"""
import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import one_torch_thread, perturb
from uninext_tpu.models.vit import ViT as JViT
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.models.vit import ViT

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

KW = dict(patch_size=16, embed_dim=32, depth=4, num_heads=2, window_size=4,
          global_blocks=(1, 3), rel_pos_init_size=8)


@pytest.mark.parametrize("hw", [(64, 96), (80, 112)])
def test_vit_matches_jax(hw):
    x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
    jm = JViT(**KW, drop_path_rate=0.0, use_flash=False, remat_blocks=False)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), x), scale=0.05)
    want = jax.jit(jm.apply)(params, x)
    tm = ViT(**KW)
    convert.load_jax_params(tm, params, fill=convert.fill_vit)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for key in ("res3", "res4", "res5"):
        assert got[key].shape == want[key].shape, key
        # 4 fp32 blocks of attention + MLP on unit-scale activations
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


def test_vit_bridge_rejects_untied_up_res3_bias():
    """A ConvTranspose2d bias holds one value per output channel; a JAX
    up_res3 bias that differs between sub-pixels cannot be carried."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jm = JViT(**KW, use_flash=False, remat_blocks=False)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    params["params"]["up_res3"]["bias"] = np.arange(64, dtype=np.float32)
    with pytest.raises(ValueError, match="up_res3 bias"):
        convert.load_jax_params(ViT(**KW), params, fill=convert.fill_vit)
