"""The port's ResNet-50 (`uninext_tpu_torch/models/resnet.py`) against the
JAX package's (`uninext_tpu/models/resnet.py`) on the CPU: fp32 outputs,
bf16 by distance from JAX fp32, the layout between convolutions, and the
weight bridge both ways (`fill_resnet`, then `convert_resnet`).

One JAX tree for the file, initialised at 72x104 and perturbed by 0.02:
the lecun-normal kernels of 2304 inputs have std 0.021, and the 0.05 of
the other parity tests would grow res5 by 1e5 over the 16 blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_common import one_torch_thread, perturb, shared_across_workers
from uninext_tpu.engine.convert import convert_resnet
from uninext_tpu.models import resnet as jresnet
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.models import resnet
from uninext_tpu_torch.models.layers import Conv2d

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

H, W = 72, 104
LEVELS = ("res3", "res4", "res5")


@pytest.fixture(scope="module")
def trunk(tmp_path_factory, worker_id):
    """Input, perturbed JAX tree and JAX's fp32 and bf16 levels (computed
    once per session)."""
    def make():
        x = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
        # the init under one jit: eagerly it compiles each op apart (the same tree)
        params = perturb(jax.jit(jresnet.ResNet(depth=50).init)(jax.random.PRNGKey(0), x),
                         scale=0.02)
        want = {n: jax.jit(lambda p, a, m=jresnet.ResNet(depth=50, dtype=dt): m.apply(p, a))(
                    params, x) for n, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16))}
        return x, params, {n: {k: np.asarray(v[k]).astype(np.float32) for k in LEVELS}
                           for n, v in want.items()}

    return shared_across_workers("resnet_trunk", make, tmp_path_factory, worker_id)


def _port(params, dtype):
    m = resnet.ResNet(dtype=dtype)
    convert.load_jax_params(m, params, fill=convert.fill_resnet)
    return m


def test_resnet_fp32_matches_jax(trunk):
    x, params, want = trunk
    with torch.no_grad():
        got = _port(params, torch.float32)(torch.from_numpy(x))
    assert set(got) == set(LEVELS)
    for k in LEVELS:
        w = want["j32"][k]
        assert got[k].shape == w.shape, k
        # fp32 through 53 convolutions: summation order, relative to the
        # level's largest magnitude
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_resnet_bf16_as_close_to_fp32_as_jax_bf16(trunk):
    """XLA and oneDNN accumulate bf16 convolutions differently, so the
    port's bf16 trunk is held by its distance from JAX fp32: at most 1.5x
    JAX bf16's, in the maximum and the median of each level."""
    x, params, want = trunk
    with torch.no_grad():
        got = _port(params, torch.bfloat16)(torch.from_numpy(x))
    for k in LEVELS:
        assert got[k].dtype == torch.bfloat16, k
        port = np.abs(got[k].float().numpy() - want["j32"][k])
        own = np.abs(want["j16"][k] - want["j32"][k])
        assert port.max() <= 1.5 * own.max(), (k, port.max(), own.max())
        assert np.median(port) <= 1.5 * np.median(own), (k, np.median(port), np.median(own))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batchnorm_matches_jax(dtype):
    """The fold in fp32, rounded to the compute dtype, then one multiply-add
    in it. fp32: to 1 ulp of the fold. bf16: by distance from JAX fp32, at
    most 1.5x JAX bf16's (XLA may fuse the multiply-add)."""
    rng = np.random.RandomState(3)
    C = 96
    x = (rng.randn(2, 5, 7, C) * 3).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, C), "bias": rng.randn(C),
         "mean": rng.randn(C), "var": rng.uniform(0.1, 3, C)}
    p = {"params": {k: v.astype(np.float32) for k, v in p.items()}}
    want = {dt: np.asarray(jresnet.FrozenBatchNorm(C, dtype=getattr(jnp, dt)).apply(
        p, x.astype(getattr(jnp, dt)))).astype(np.float32)
        for dt in ("float32", "bfloat16")}
    bn = resnet.FrozenBatchNorm(C, dtype=getattr(torch, dtype))
    with torch.no_grad():
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            getattr(bn, dst).copy_(torch.from_numpy(p["params"][src]))
        got = bn(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want["float32"], rtol=1e-6, atol=1e-6)
    else:
        port = np.abs(got - want["float32"])
        own = np.abs(want["bfloat16"] - want["float32"])
        assert port.max() <= 1.5 * own.max(), (port.max(), own.max())
        assert np.median(port) <= 1.5 * np.median(own), (np.median(port), np.median(own))


def test_resnet_stays_channels_last(trunk):
    """Every convolution gets an NHWC-contiguous input (its NCHW view is
    channels-last strided, cuDNN's layout) and the outputs are
    NHWC-contiguous: no layout copy between convolutions."""
    x, params, _ = trunk
    m = _port(params, torch.float32)
    seen = []
    for mod in m.modules():
        if isinstance(mod, Conv2d):
            mod.register_forward_pre_hook(lambda mod, a: seen.append(a[0].is_contiguous()))
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert len(seen) == 53 and all(seen)
    assert all(out[k].is_contiguous() for k in LEVELS)


def test_resnet_bridge_round_trip_through_convert_resnet(trunk):
    """JAX tree -> `fill_resnet` -> the port's state_dict (detectron2's
    keys) -> the JAX package's `convert_resnet` onto a zeroed tree gives
    back every leaf exactly; and the names the optimizer classifies by
    (`jax_module_path`) are the JAX leaves' own."""
    _, params, _ = trunk
    m = _port(params, torch.float32)
    sd = m.state_dict()
    assert "stem.conv1.norm.running_var" in sd and "res2.0.shortcut.norm.weight" in sd
    assert all("bias" not in k or ".norm." in k for k in sd)      # bias-free convs
    zeroed = {"backbone": jax.tree.map(np.zeros_like, params["params"])}
    report = {"loaded": 0, "missing_target": [], "shape_mismatch": []}
    convert_resnet(sd, zeroed, report, src_prefix="")
    leaves = jax.tree_util.tree_leaves_with_path(params["params"])
    assert report == {"loaded": len(leaves), "missing_target": [], "shape_mismatch": []}
    back = dict(jax.tree_util.tree_leaves_with_path(zeroed["backbone"]))
    names = {convert.jax_module_path("detr.detr.backbone.0.backbone." + k) for k in sd}
    assert names == {"backbone/" + "/".join(p.key for p in path) for path, _ in leaves}
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_resnet_gradients_match_jax_up_to_relu_ties(trunk):
    """The trunk's backward (every parameter's gradient and the input's, on
    random cotangents of res3-res5) against `jax.grad`: the port in fp64
    agrees with JAX in fp32 to 5e-5 of each leaf's largest gradient. The
    port in fp32 agrees with itself in fp64 except where a block's
    pre-activation sits within fp32 rounding of zero: there the two ReLU
    masks differ, and the one element's gradient goes one way or the other
    (at these inputs one element of res4.3, 2e-6 against a largest of 19,
    moves res4.3.conv3's weight gradient by a few percent of its largest;
    JAX's fp32 rounding falls on fp64's side). The blocks after the last
    tie agree in fp32 and fp64. ROADMAP §3.24."""
    x, params, _ = trunk
    jm = jresnet.ResNet(depth=50)
    rng = np.random.RandomState(1)
    cot = {k: rng.randn(*v.shape).astype(np.float32)
           for k, v in jax.eval_shape(jm.apply, params, x).items() if k in LEVELS}

    def jloss(p, a):
        out = jm.apply(p, a)
        return sum((out[k] * cot[k]).sum() for k in LEVELS)

    jgrad, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, x)
    want = convert.state_dict_from_jax(jgrad, convert.fill_resnet)
    pre, grads, blocks = {}, {}, []
    for dt in (torch.float32, torch.float64):
        m = _port(params, dt).to(dt)
        acts = pre.setdefault(dt, [])
        blocks = [n for n, blk in m.named_modules() if isinstance(blk, resnet.Bottleneck)]
        for blk in m.modules():
            if isinstance(blk, resnet.Bottleneck):
                blk.register_forward_hook(
                    lambda mod, a, out, acts=acts: acts.append(_pre_activation(mod, a[0])))
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        out = m(xt)
        sum((out[k] * torch.from_numpy(cot[k]).to(dt)).sum() for k in LEVELS).backward()
        grads[dt] = {"input": xt.grad, **{k: p.grad for k, p in m.named_parameters()}}
    g64 = grads[torch.float64]
    for k, w in [("input", torch.from_numpy(np.asarray(jgx))), *want.items()]:
        np.testing.assert_allclose(g64[k].numpy(), w.double().numpy(), rtol=0,
                                   atol=5e-5 * float(w.abs().max()), err_msg=k)
    assert len(pre[torch.float32]) == len(blocks)          # the blocks in forward order
    flips = [(i, b, (a > 0) != (b > 0)) for i, (a, b) in enumerate(zip(pre[torch.float32],
                                                                       pre[torch.float64]))]
    flips = [(i, b, at) for i, b, at in flips if at.any()]
    assert sum(int(at.sum()) for _, _, at in flips) <= 2
    for _, b, at in flips:      # ties: within fp32 rounding of the block's scale
        assert float(b[at].abs().max()) <= 1e-6 * float(b.abs().max())
    # a tie moves the gradients of its block and of everything before it;
    # the blocks after the last one take the same gradients in fp32
    after = blocks[max(i for i, _, _ in flips) + 1:] if flips else None
    g32, held = grads[torch.float32], 0
    for k, w in g64.items():
        if after is None or k.startswith(tuple(n + "." for n in after)):
            np.testing.assert_allclose(g32[k].double().numpy(), w.numpy(), rtol=0,
                                       atol=5e-5 * float(w.abs().max()), err_msg=k)
            held += 1
    assert held > 0


def _pre_activation(block, x):
    """A bottleneck's sum before its last ReLU, recomputed without a
    gradient."""
    with torch.no_grad():
        out = block.conv3(F.relu(block.conv2(F.relu(block.conv1(x)))))
        return out + (x if block.shortcut is None else block.shortcut(x))
