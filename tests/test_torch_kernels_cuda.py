"""The port's CUDA kernels (A on both routes, A-bwd, MSDA, MSDA-bwd, NMS,
and the labs' fold, gather and DMA-probe kernels) vs their plain PyTorch
versions, on the card. A backward kernel is held to autograd through the
plain version of its forward.

CUDA kernels have no CPU or interpret mode, so every test here is marked
`cuda` and skips without a CUDA device (decided inside the `dev` fixture,
never at import). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: fp32 kernels against fp32 plain versions differ only in the
order of their fp32 sums; bf16 kernels read the same bf16 inputs as the
plain versions (which compute in fp32) and may differ by one bf16 rounding
of the output (kernel A's tensor-core route also rounds each probability
to bf16 before the P.V product, as the Pallas kernel does: 2^-9 of each
term of a weighted mean, far below that rounding). Gradients are compared relative to their largest entry:
fp32 differs in summation order (MSDA-bwd adds dvalue with atomics, in an
order that changes from run to run); bf16 gradients are rounded to bf16 on
both sides.
"""
import numpy as np
import pytest
import torch

from uninext_tpu_torch.models import vit
from uninext_tpu_torch.ops import dma_gather, gather_fold, msda, nms
from uninext_tpu_torch.tools import msda_v6_lab

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


# kernel A's shapes: ragged grids (S = 99, 91), hd 8 (padded to one mma
# k-step), 64, 80 (ViT-H) and 128, the 50 x 76 global grid of an 800x1216
# image and 24 windows of 14 x 14 at ViT-H's 16 heads
A_CASES = [(2, 9, 11, 4, 8), (3, 14, 14, 4, 80), (1, 50, 76, 2, 80),
           (1, 7, 13, 2, 64), (1, 7, 13, 2, 128), (24, 14, 14, 16, 80)]


def _attention_case(dev, dtype, B, H, W, nh, hd):
    g = torch.Generator(device=dev).manual_seed(B * H + hd)
    S = H * W
    qkv = torch.randn(B, S, 3, nh, hd, device=dev, generator=g).to(dtype)
    q, k, v = qkv.unbind(2)                      # strided views, as in Attention
    Rh = (0.1 * torch.randn(H, H, hd, device=dev, generator=g)).to(dtype)
    Rw = (0.1 * torch.randn(W, W, hd, device=dev, generator=g)).to(dtype)
    return q.reshape(B, H, W, nh, hd), k, v, Rh, Rw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,nh,hd", A_CASES)
def test_rel_pos_flash_attn_matches_plain(dev, dtype, B, H, W, nh, hd):
    """Each dtype takes its own route and moves only its own counter: bf16
    the tensor-core kernel, fp32 the CUDA-core kernel."""
    q5, k, v, Rh, Rw = _attention_case(dev, dtype, B, H, W, nh, hd)
    routes = (vit.flash_rel_pos_attention, vit.rel_pos_flash_attn_mma,
              vit.rel_pos_flash_attn_fp32)
    before = [r.launches for r in routes]
    got = vit.flash_rel_pos_attention(q5, k, v, Rh, Rw, hd ** -0.5)
    bf16 = dtype == torch.bfloat16
    assert [r.launches - b for r, b in zip(routes, before)] == [1, int(bf16), int(not bf16)]
    want = vit.rel_pos_attention_plain(q5, k, v, Rh, Rw, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, nh * hd)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("B,H,W,nh,hd", A_CASES)
def test_rel_pos_flash_attn_mma_lse_matches_logsumexp(dev, B, H, W, nh, hd):
    """The tensor-core kernel's lse is the natural-log logsumexp of the
    biased scores, which A-bwd reads. Reference: torch.logsumexp of fp32
    scores from the same bf16 inputs. Tolerance 1e-4: the products are
    exact in fp32 and the sums of at most 128 terms and the base-2
    exponentials differ in rounding only (|lse| < 20)."""
    q5, k, v, Rh, Rw = _attention_case(dev, torch.bfloat16, B, H, W, nh, hd)
    scale = hd ** -0.5
    _, lse = vit.rel_pos_flash_attn_fwd(q5, k, v, Rh, Rw, scale, with_lse=True)
    S = H * W
    qf = q5.float()
    scores = torch.einsum("byxhd,bkhd->bhyxk", qf * scale, k.float())
    bh = torch.einsum("byxhd,yid->bhyxi", qf, Rh.float())
    bw = torch.einsum("byxhd,xjd->bhyxj", qf, Rw.float())
    scores = (scores.reshape(B, nh, H, W, H, W) + bh[..., :, None]
              + bw[..., None, :]).reshape(B, nh, S, S)
    want = torch.logsumexp(scores, -1)
    torch.cuda.synchronize()
    assert lse.shape == (B, nh, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hd", [12, 136])
def test_rel_pos_flash_attn_mma_refuses_other_head_dims(dev, hd):
    """bf16 with hd not a multiple of 8, or above 128, raises: it is
    launched on no kernel (neither route counts it)."""
    q5, k, v, Rh, Rw = _attention_case(dev, torch.bfloat16, 1, 5, 6, 2, hd)
    routes = (vit.flash_rel_pos_attention, vit.rel_pos_flash_attn_mma,
              vit.rel_pos_flash_attn_fp32)
    before = [r.launches for r in routes]
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        vit.flash_rel_pos_attention(q5, k, v, Rh, Rw, hd ** -0.5)
    assert [r.launches for r in routes] == before


MSDA_LEVELS = ((20, 30), (10, 15), (5, 8), (3, 4))
# (geometry, D, Lq). "card": inputs drawn on the card (`_msda_card_case`),
# uniform locations at D 32 and 16 (and 40 forward only). The others come
# from numpy (`_msda_case`): samples clustered in 2 x 2 pixels; levels of
# 1x1, 1x2 and odd widths; Lq that fill no whole warp, block or wave of
# tasks; locations on the frame's and the pixels' edges only forward (the
# gradient has kinks there).
_card = lambda D, Lq: pytest.param("card", D, Lq, id=f"{D}-{Lq}")
_numpy = lambda g, D, Lq: pytest.param(g, D, Lq, id=f"{g}-{D}-{Lq}")
MSDA_NEW_CASES = [_numpy("uniform", 40, 50), _numpy("clustered", 32, 257),
                  _numpy("clustered", 40, 31), _numpy("tiny", 16, 33),
                  _numpy("tiny", 32, 129)]
MSDA_FWD_CASES = ([_card(32, 300), _card(16, 77), _card(40, 50)] + MSDA_NEW_CASES[1:]
                  + [_numpy("edges", 32, 61), _numpy("edges", 16, 19)])
MSDA_BWD_CASES = [_card(32, 300), _card(16, 77)] + MSDA_NEW_CASES


def _msda_card_case(dev, D, Lq, g, att_softmax):
    """fp32 value, loc, att on the card from generator `g`: uniform
    locations in [-0.15, 1.15], B = 2."""
    S = sum(h * w for h, w in MSDA_LEVELS)
    B, M, L, P = 2, 8, 4, 4
    value = torch.randn(B, S, M, D, device=dev, generator=g)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.3 - 0.15
    if att_softmax:
        att = torch.rand(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att = att.reshape(B, Lq, M, L, P)
    else:
        att = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    return value, MSDA_LEVELS, loc, att


def _msda_case(dev, dtype, geometry, D, Lq, seed, margin=0.0):
    """value (dtype), loc, att and the levels from numpy; B = 2, each image
    with its own locations; `margin` as `msda_locations`'s."""
    from torch_port_common import TINY_LEVELS, msda_locations
    rng = np.random.RandomState(seed)
    shapes = TINY_LEVELS if geometry == "tiny" else MSDA_LEVELS
    S = sum(h * w for h, w in shapes)
    B, M, L, P = 2, 8, len(shapes), 4
    loc = msda_locations(rng, shapes, B, Lq, M, P, geometry, margin)
    value = rng.randn(B, S, M, D).astype(np.float32)
    att = rng.rand(B, Lq, M, L * P).astype(np.float32)
    att = np.exp(att) / np.exp(att).sum(-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(value).to(dtype), shapes, t(loc), t(att.reshape(B, Lq, M, L, P))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry,D,Lq", MSDA_FWD_CASES)
def test_ms_deform_attn_matches_plain(dev, dtype, geometry, D, Lq):
    if geometry == "card":
        g = torch.Generator(device=dev).manual_seed(D + Lq)
        value, shapes, loc, att = _msda_card_case(dev, D, Lq, g, att_softmax=True)
        value = value.to(dtype)
    else:
        value, shapes, loc, att = _msda_case(dev, dtype, geometry, D, Lq, D + Lq)
    before = msda.ms_deform_attn.launches
    got = msda.ms_deform_attn(value, shapes, loc, att)
    assert msda.ms_deform_attn.launches == before + 1
    want = msda.ms_deform_attn_plain(value, shapes, loc, att)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 12), (torch.bfloat16, 264),
                                     (torch.float32, 10), (torch.float32, 132)])
def test_ms_deform_attn_refuses_other_head_widths(dev, dtype, D):
    """D not a whole number of 16-byte pieces, or above 32 of them, raises
    before any launch: the forward, under autograd too, and the backward."""
    value, shapes, loc, att = _msda_case(dev, dtype, "uniform", D, 5, D)
    counters = (msda.ms_deform_attn, msda.ms_deform_attn_bwd)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="multiple of"):
        msda.ms_deform_attn(value, shapes, loc, att)
    with pytest.raises(ValueError, match="multiple of"):
        msda.ms_deform_attn(value.requires_grad_(), shapes, loc, att)
    with pytest.raises(ValueError, match="multiple of"):
        msda.ms_deform_attn_bwd(value.detach(), shapes, loc, att,
                                torch.zeros(2, 5, 8 * D, device=dev, dtype=dtype))
    assert [c.launches for c in counters] == before


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
                                         (1, 50, 76, 2, 80), (24, 14, 14, 16, 80),
                                         (1, 7, 13, 2, 64), (1, 7, 13, 2, 128)])
def test_rel_pos_flash_attn_bwd_matches_plain(dev, dtype, B, H, W, nh, hd):
    """Each dtype takes its own route of A-bwd and moves only its own
    counter: bf16 the tensor-core kernels, fp32 the CUDA-core kernels."""
    g = torch.Generator(device=dev).manual_seed(B * W + hd)
    S = H * W
    base = torch.randn(B, S, 3, nh, hd, device=dev, generator=g)
    rh0 = 0.1 * torch.randn(H, H, hd, device=dev, generator=g)
    rw0 = 0.1 * torch.randn(W, W, hd, device=dev, generator=g)
    cot = torch.randn(B, H, W, nh * hd, device=dev, generator=g).to(dtype)
    routes = (vit.rel_pos_flash_attn_bwd, vit.rel_pos_flash_attn_bwd_mma,
              vit.rel_pos_flash_attn_bwd_fp32)
    grads = []
    for fn in (vit.flash_rel_pos_attention, vit.rel_pos_attention_plain):
        qkv = base.to(dtype).requires_grad_()
        rh, rw = rh0.to(dtype).requires_grad_(), rw0.to(dtype).requires_grad_()
        q, k, v = qkv.unbind(2)
        out = fn(q.reshape(B, H, W, nh, hd), k, v, rh, rw, hd ** -0.5)
        before = [r.launches for r in routes]
        grads.append(torch.autograd.grad(out, (qkv, rh, rw), cot))
        if fn is vit.flash_rel_pos_attention:
            assert type(out.grad_fn).__name__ == "_RelPosFlashAttnBackward"
            bf16 = dtype == torch.bfloat16
            assert ([r.launches - n for r, n in zip(routes, before)]
                    == [1, int(bf16), int(not bf16)])
    torch.cuda.synchronize()
    for name, got, want in zip(("dqkv", "dRh", "dRw"), *grads):
        assert got.dtype == dtype
        _close_rel(name, got, want, dtype)


@pytest.mark.parametrize("hd", [12, 136])
def test_rel_pos_flash_attn_bwd_mma_refuses_other_head_dims(dev, hd):
    """bf16 with hd not a multiple of 8, or above 128, raises in A-bwd too:
    it is launched on no kernel (no route counts it)."""
    q5, k, v, Rh, Rw = _attention_case(dev, torch.bfloat16, 1, 5, 6, 2, hd)
    out = torch.zeros(1, 5, 6, 2 * hd, dtype=torch.bfloat16, device=dev)
    lse = torch.zeros(1, 2, 30, device=dev)
    routes = (vit.rel_pos_flash_attn_bwd, vit.rel_pos_flash_attn_bwd_mma,
              vit.rel_pos_flash_attn_bwd_fp32)
    before = [r.launches for r in routes]
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        vit.rel_pos_flash_attn_bwd(q5, k, v, Rh, Rw, hd ** -0.5, out, lse, out)
    assert [r.launches for r in routes] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry,D,Lq", MSDA_BWD_CASES)
def test_ms_deform_attn_bwd_matches_plain(dev, dtype, geometry, D, Lq):
    """The numpy cases keep every location 1e-3 px off a pixel centre (the
    kink of the gradient w.r.t. the location); the clustered cases stack
    the dvalue reductions of a head onto a few pixels."""
    g = torch.Generator(device=dev).manual_seed(D * Lq)
    if geometry == "card":
        value0, shapes, loc0, att0 = _msda_card_case(dev, D, Lq, g, att_softmax=False)
    else:
        value0, shapes, loc0, att0 = _msda_case(dev, torch.float32, geometry, D, Lq,
                                                D * Lq, margin=1e-3)
    B, M = value0.shape[0], value0.shape[2]
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
    kernels (A, A-bwd, MSDA, MSDA-bwd) on the card vs the plain versions on
    the CPU, with the same weights, batch and DN noise."""
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


# The labs' kernels (csrc/gather_fold.cu) return fp32 in both versions, which
# read the same fp32 or bf16 inputs: only the order of fp32 sums (and fused
# multiply-adds) of at most 64 terms below 10 differ.
LAB_TOL = 5e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,N,D", [(16, 1000, 32), (3, 77, 8), (5, 33, 40)])
def test_msda_fold_matches_plain(dev, dtype, S, N, D):
    g = torch.Generator(device=dev).manual_seed(S * N + D)
    rows = torch.randn(S, N, 4 * D, device=dev, generator=g).to(dtype)
    w = torch.rand(S, N, 4, device=dev, generator=g).to(dtype)
    before = gather_fold.msda_fold.launches
    got = gather_fold.msda_fold(rows, w)
    assert gather_fold.msda_fold.launches == before + 1
    want = gather_fold.msda_fold_plain(rows, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (N, D)
    torch.testing.assert_close(got, want, rtol=0, atol=LAB_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,TQ,SAMP,R,D", [(2, 37, 5, 61, 32), (3, 512, 16, 300, 32),
                                           (1, 3, 7, 5, 40)])
@pytest.mark.parametrize("kernel", ["scalar", "vec", "weighted"])
def test_gather_kernels_match_plain(dev, dtype, kernel, M, TQ, SAMP, R, D):
    g = torch.Generator(device=dev).manual_seed(M * TQ + SAMP * R + D)
    buf = torch.randn(R, 4 * D, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, R, (M, TQ, SAMP), device=dev, generator=g, dtype=torch.int32)
    w = torch.rand(M, TQ, SAMP, 4, device=dev, generator=g)
    fn, args, want = {
        "scalar": (gather_fold.gather_rowsum_scalar, (buf, idx),
                   gather_fold.gather_rowsum_plain(buf, idx)),
        "vec": (gather_fold.gather_rowsum_vec, (buf, idx),
                gather_fold.gather_rowsum_plain(buf, idx)),
        "weighted": (gather_fold.gather_weighted, (buf, idx, w),
                     gather_fold.gather_weighted_plain(buf, idx, w)),
    }[kernel]
    if kernel == "vec" and D != 32:
        with pytest.raises(ValueError, match="D = 32"):
            fn(*args)
        return
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, TQ, D)
    torch.testing.assert_close(got, want, rtol=0, atol=LAB_TOL)


def test_msda_v6_on_card_matches_plain_msda(dev):
    """The lab's parity on the card: index_select + kernel B against the
    plain MSDA, fp32, within the lab's 1e-4."""
    before = gather_fold.msda_fold.launches
    assert msda_v6_lab.parity(dev) < 1e-4
    assert gather_fold.msda_fold.launches == before + 1


# C3 and C4 at the DMA probe's row width (D4 = 128) and others: tile and
# block counts that fill the grid unevenly (C3 runs one block per tile,
# C4 8 warps per block up to 2112 blocks, grid-stride beyond), a table of
# 15708 rows whose last whole block is index 1962, and an fp32 table.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D4,K,tiles,rows_out", [(15708, 128, 32, 4096, 8), (61, 128, 5, 133, 8),
                                                   (300, 64, 32, 7, 3), (40, 256, 1, 1, 1)])
@pytest.mark.parametrize("l2_resident", [False, True])
def test_dma_gather_rowsum_matches_plain(dev, dtype, R, D4, K, tiles, rows_out, l2_resident):
    g = torch.Generator(device=dev).manual_seed(R + K * tiles)
    buf = torch.randn(R, D4, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, R, (tiles * K,), device=dev, generator=g, dtype=torch.int32)
    idx[-1] = R - 1
    before = dma_gather.dma_gather_rowsum.launches
    got = dma_gather.dma_gather_rowsum(buf, idx, k=K, rows_out=rows_out,
                                       l2_resident=l2_resident)
    assert dma_gather.dma_gather_rowsum.launches == before + 1
    want = dma_gather.dma_gather_rowsum_plain(buf, idx, K, rows_out)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (tiles * rows_out, D4)
    torch.testing.assert_close(got, want, rtol=0, atol=LAB_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D4,n", [(15708, 128, 131072), (15708, 128, 17), (64, 8, 2113),
                                    (17, 256, 3)])
def test_dma_block_gather_matches_plain(dev, dtype, R, D4, n):
    g = torch.Generator(device=dev).manual_seed(R + n)
    buf = torch.randn(R, D4, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, R // 8, (n,), device=dev, generator=g, dtype=torch.int32)
    idx[-1] = R // 8 - 1                         # 1962 at the probe's table
    before = dma_gather.dma_block_gather.launches
    got = dma_gather.dma_block_gather(buf, idx)
    assert dma_gather.dma_block_gather.launches == before + 1
    want = dma_gather.dma_block_gather_plain(buf, idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (8 * n, D4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dma_gather_wrappers_refuse_what_the_kernels_cannot_copy(dev):
    """Bulk copies and 16-byte loads need a 16-byte aligned table with rows
    of a multiple of 16 bytes; the wrappers raise rather than take another
    route."""
    flat = torch.randn(65 * 128 + 1, device=dev, dtype=torch.bfloat16)
    buf = flat[:-1].view(65, 128)
    idx = torch.zeros(32, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        dma_gather.dma_gather_rowsum(flat[1:].view(65, 128), idx)   # 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        dma_gather.dma_block_gather(buf[:, :4].contiguous(), idx)   # 8-byte rows
    with pytest.raises(ValueError, match="tiles of"):
        dma_gather.dma_gather_rowsum(buf, idx[:31])
