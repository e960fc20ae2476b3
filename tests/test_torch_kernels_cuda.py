"""The port's CUDA kernels (A, A-bwd, B, B-bwd, C) vs their plain PyTorch
versions, on the card. A backward kernel is held to autograd through the
plain version of its forward.

CUDA kernels have no CPU or interpret mode, so every test here is marked
`cuda` and skips without a CUDA device (decided inside the `dev` fixture,
never at import). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: fp32 kernels against fp32 plain versions differ only in the
order of their fp32 sums; bf16 kernels read the same bf16 inputs as the
plain versions (which compute in fp32) and may differ by one bf16 rounding
of the output. Gradients are compared relative to their largest entry:
fp32 differs in summation order (B-bwd adds dvalue with atomics, in an
order that changes from run to run); bf16 gradients are rounded to bf16 on
both sides.
"""
import numpy as np
import pytest
import torch

from uninext_tpu_torch.models import vit
from uninext_tpu_torch.ops import msda, nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


TOL = {torch.float32: 2e-5, torch.bfloat16: 3.2e-2}   # bf16: 1 ulp at |x| < 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,nh,hd", [(2, 9, 11, 4, 8), (3, 14, 14, 4, 80),
                                         (1, 50, 76, 2, 80)])
def test_rel_pos_flash_attn_matches_plain(dev, dtype, B, H, W, nh, hd):
    g = torch.Generator(device=dev).manual_seed(B * H + hd)
    S = H * W
    qkv = torch.randn(B, S, 3, nh, hd, device=dev, generator=g).to(dtype)
    q, k, v = qkv.unbind(2)                      # strided views, as in Attention
    Rh = (0.1 * torch.randn(H, H, hd, device=dev, generator=g)).to(dtype)
    Rw = (0.1 * torch.randn(W, W, hd, device=dev, generator=g)).to(dtype)
    q5 = q.reshape(B, H, W, nh, hd)
    before = vit.flash_rel_pos_attention.launches
    got = vit.flash_rel_pos_attention(q5, k, v, Rh, Rw, hd ** -0.5)
    assert vit.flash_rel_pos_attention.launches == before + 1
    want = vit.rel_pos_attention_plain(q5, k, v, Rh, Rw, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, nh * hd)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Lq", [(32, 300), (16, 77), (40, 50)])
def test_ms_deform_attn_matches_plain(dev, dtype, D, Lq):
    g = torch.Generator(device=dev).manual_seed(D + Lq)
    shapes = ((20, 30), (10, 15), (5, 8), (3, 4))
    S = sum(h * w for h, w in shapes)
    B, M, L, P = 2, 8, 4, 4
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.3 - 0.15
    att = torch.rand(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
    att = att.reshape(B, Lq, M, L, P)
    before = msda.ms_deform_attn.launches
    got = msda.ms_deform_attn(value, shapes, loc, att)
    assert msda.ms_deform_attn.launches == before + 1
    want = msda.ms_deform_attn_plain(value, shapes, loc, att)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("B,N", [(2, 900), (3, 130), (1, 64)])
def test_nms_matches_plain_exactly(dev, B, N):
    rng = np.random.RandomState(N)
    centers = rng.uniform(0.2, 0.8, (B, 25, 2))
    pick = rng.randint(0, 25, (B, N))
    cxcy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 0.01, (B, N, 2))
    wh = rng.uniform(0.1, 0.2, (B, N, 2))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1).astype(np.float32)
    scores = rng.rand(B, N).astype(np.float32)
    scores[:, ::7] = scores[:, 1:2]                       # ties
    classes = rng.randint(0, 3, (B, N))
    valid = rng.rand(B, N) > 0.05
    args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, classes, valid)]
    before = nms.batched_nms.launches
    got = nms.batched_nms(args[0], args[1], args[2], 0.7, args[3])
    assert nms.batched_nms.launches == before + 1
    want = nms.batched_nms_plain(args[0], args[1], args[2], 0.7, args[3])
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(args[3].sum())        # it did suppress


def test_tiny_slice_on_card_matches_cpu(dev):
    """The tiny ViT slice with the same weights: kernels on the card vs the
    plain versions on the CPU, and the expected launches per request."""
    # the bare module name: pytest puts tests/ on sys.path, and the card's
    # machine runs this file without the JAX conftest that adds the root
    from torch_port_common import detection_inputs, tiny_vit_config
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import postprocess_detection

    cfg = tiny_vit_config()
    cpu = build_model(cfg, "cpu", seed=5)
    gpu = build_model(cfg, "cpu", seed=5).to(dev)
    inputs = [torch.from_numpy(a) for a in detection_inputs(2)]
    cmap = torch.eye(16, dtype=torch.bool)[1:6]
    counters = (vit.flash_rel_pos_attention, msda.ms_deform_attn, nms.batched_nms)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        want = cpu(*inputs)
        got = gpu(*(a.to(dev) for a in inputs))
        post = postprocess_detection(got, cmap.to(dev))
    t = cfg.transformer
    assert [c.launches - b for c, b in zip(counters, before)] == [
        cfg.backbone.vit_depth, t.enc_layers + t.dec_layers, 1]
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-4)
    assert post["scores"].shape == (2, 100)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}   # x max |grad|


def _close_rel(name, got, want, dtype, floor=1e-6):
    """max |got - want| <= tol x max(max |want|, floor)."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= GRAD_TOL[dtype] * max(scale, floor), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,nh,hd", [(2, 9, 11, 4, 8), (3, 14, 14, 4, 80),
                                         (1, 50, 76, 2, 80)])
def test_rel_pos_flash_attn_bwd_matches_plain(dev, dtype, B, H, W, nh, hd):
    g = torch.Generator(device=dev).manual_seed(B * W + hd)
    S = H * W
    base = torch.randn(B, S, 3, nh, hd, device=dev, generator=g)
    rh0 = 0.1 * torch.randn(H, H, hd, device=dev, generator=g)
    rw0 = 0.1 * torch.randn(W, W, hd, device=dev, generator=g)
    cot = torch.randn(B, H, W, nh * hd, device=dev, generator=g).to(dtype)
    grads = []
    for fn in (vit.flash_rel_pos_attention, vit.rel_pos_attention_plain):
        qkv = base.to(dtype).requires_grad_()
        rh, rw = rh0.to(dtype).requires_grad_(), rw0.to(dtype).requires_grad_()
        q, k, v = qkv.unbind(2)
        out = fn(q.reshape(B, H, W, nh, hd), k, v, rh, rw, hd ** -0.5)
        grads.append(torch.autograd.grad(out, (qkv, rh, rw), cot))
        if fn is vit.flash_rel_pos_attention:
            assert type(out.grad_fn).__name__ == "_RelPosFlashAttnBackward"
    torch.cuda.synchronize()
    for name, got, want in zip(("dqkv", "dRh", "dRw"), *grads):
        assert got.dtype == dtype
        _close_rel(name, got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Lq", [(32, 300), (16, 77)])
def test_ms_deform_attn_bwd_matches_plain(dev, dtype, D, Lq):
    g = torch.Generator(device=dev).manual_seed(D * Lq)
    shapes = ((20, 30), (10, 15), (5, 8), (3, 4))
    S = sum(h * w for h, w in shapes)
    B, M, L, P = 2, 8, 4, 4
    value0 = torch.randn(B, S, M, D, device=dev, generator=g)
    loc0 = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.3 - 0.15
    att0 = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    cot = torch.randn(B, Lq, M * D, device=dev, generator=g).to(dtype)
    grads = []
    before = msda.ms_deform_attn_bwd.launches
    for fn in (msda.ms_deform_attn, msda.ms_deform_attn_plain):
        value = value0.to(dtype).requires_grad_()
        loc, att = loc0.clone().requires_grad_(), att0.clone().requires_grad_()
        out = fn(value, shapes, loc, att)
        grads.append(torch.autograd.grad(out, (value, loc, att), cot))
    assert msda.ms_deform_attn_bwd.launches == before + 1
    torch.cuda.synchronize()
    for name, got, want in zip(("dvalue", "dloc", "datt"), *grads):
        _close_rel(name, got, want, dtype)


def test_tiny_train_step_on_card_matches_cpu(dev):
    """One train step's losses and gradients of the tiny ViT config, fp32:
    kernels (A, A-bwd, B, B-bwd) on the card vs the plain versions on the
    CPU, with the same weights, batch and DN noise."""
    from torch_port_common import detection_inputs, detection_targets, tiny_vit_config
    from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
    from uninext_tpu_torch.models.detr import build_model

    cfg = tiny_vit_config()
    images, img_mask, sizes, ids, tmask = (torch.from_numpy(a) for a in detection_inputs(3))
    boxes, valid, pm = (torch.from_numpy(a) for a in
                        detection_targets(3, G=cfg.data.max_insts))
    batch = {"images": images, "img_mask": img_mask, "image_sizes": sizes,
             "text_ids": ids.long(), "text_mask": tmask,
             "targets": {"boxes": boxes, "valid": valid, "positive_map": pm}}
    gen = torch.Generator().manual_seed(0)
    shape = (2, 5, 2, 20, 4)
    noise = (torch.randint(0, 2, shape, generator=gen).float() * 2 - 1,
             torch.rand(shape, generator=gen))
    results = []
    for device in ("cpu", dev):
        model = build_model(cfg, "cpu", seed=7)
        # off the initial sampling-offset ring: at init every MSDA sample sits
        # on a pixel centre, where bilinear sampling has a kink and the
        # gradient depends on which side rounding puts it
        with torch.no_grad():
            g = torch.Generator().manual_seed(11)
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        model = model.to(device)
        mv = lambda x: {k: mv(v) for k, v in x.items()} if isinstance(x, dict) \
            else x.to(device)
        _, losses = loss_and_grads(model, mv(batch), loss_weights(cfg),
                                   dn_noise=tuple(t.to(device) for t in noise))
        results.append((losses, {n: p.grad for n, p in model.named_parameters()}))
    (cl, cg), (gl, gg) = results
    assert set(cl) == set(gl)
    for k in cl:
        torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-4, atol=1e-5)
    for n in cg:
        want = cg[n] if cg[n] is not None else torch.zeros(1)
        got = gg[n].cpu() if gg[n] is not None else torch.zeros(1)
        # floor 1e-2: leaves whose exact gradient is 0 (the key bias of a
        # softmax attention) hold only rounding noise
        _close_rel(n, got, want, torch.float32, floor=1e-2)
