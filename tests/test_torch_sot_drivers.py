"""The SOT, VOS and R-VOS drivers of the port against the JAX package's on
the same scripted model outputs, and the host pieces bit-equal:
`SOTDriver` with online template updates, `VOSDriver` with
`inference_on_3f` and an object that starts late, `RVOSDriver` at
`rvos_temporal_weight` 0 and 0.3, `run_refdavis_offline`,
`soft_aggregate`, the x4 upsample of the VOS mask logits, `evaluate_sot`,
`evaluate_davis`, the DAVIS palette PNGs, and the referring mini-YTVIS with
`load_ytvis_json(has_expression=True)`.

Trackers and drivers turn a 1e-6 change into another decision, so the
model under both drivers is a scripted stand-in (`_JaxModel`, `_PortModel`)
whose outputs are read from the frame's pixels: per query its logit, IoU
logit, prompt weight, box and embedding. The real template crops
(`crop_template`) and frame steps (`make_sot_frame_step`,
`make_rvos_frame_step`) run around it; the prompt (a crop's channel means)
moves every logit by its mean times the query's weight, so templates
refreshed at other boxes choose other queries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_data import _same_tree
from tests.torch_port_common import one_torch_thread
from uninext_tpu import config as jcfg
from uninext_tpu.data import mini_coco as jmini
from uninext_tpu.data import video as jvideo
from uninext_tpu.engine import mot_inference as jmot
from uninext_tpu.engine import rvos_offline as jrvos
from uninext_tpu.engine import sot_inference as jsoti
from uninext_tpu.evaluation import davis_eval as jdavis
from uninext_tpu.evaluation import sot_eval as jsot_eval
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.utils.misc import agg_lang_feat as jagg
from uninext_tpu_torch import config as tcfg
from uninext_tpu_torch.data import mini_coco, video
from uninext_tpu_torch.engine import mot_inference, rvos_offline, sot_inference
from uninext_tpu_torch.evaluation import davis_eval, sot_eval
from uninext_tpu_torch.utils.misc import agg_lang_feat

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

Q, D = 16, 64                   # queries; d_model and the language width of the tiny configs
H, W = 80, 96                   # padded frame; the valid part is (72, 88)
SIZES = np.array([[72, 88]], np.int32)
PAT = np.random.RandomState(99).randn(H // 4, W // 4).astype(np.float32)


def _frames(n, seed):
    """Frames whose pixels carry the scripted outputs: row 0 the logits,
    IoU logits and prompt weights of the Q queries (channels 0-2), rows 1-4
    their cxcywh boxes, rows 5..5+D their embeddings (also their decoder
    states); noise elsewhere, which the crops see."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = (rng.randn(1, H, W, 3) * 0.5).astype(np.float32)
        f[0, 0, :Q, 0] = rng.randn(Q) * 2
        f[0, 0, :Q, 1] = rng.randn(Q) + 1
        f[0, 0, :Q, 2] = rng.randn(Q) * 30
        f[0, 1:3, :Q, 0] = rng.uniform(0.25, 0.75, (2, Q))
        f[0, 3:5, :Q, 0] = rng.uniform(0.1, 0.4, (2, Q))
        f[0, 5:5 + D, :Q, 0] = rng.randn(D, Q)
        out.append(f)
    return out


def _prompt(crop, xp):
    """A crop's channel means tiled to (1, 2, D), all tokens valid."""
    m = crop.mean((1, 2))                                     # (1, C)
    reps = D // m.shape[1] + 1
    hidden = (xp.tile(m, (1, 2 * reps)) if xp is jnp else m.repeat(1, 2 * reps))
    return hidden.reshape(1, 2, -1)[..., :D]


class _JaxModel:
    """`flax` `apply` of the scripted stand-in: the forward, `predict_masks`
    and `encode_template`, traceable under `jax.jit`."""

    def apply(self, variables, *args, method=None, **kw):
        if method is JaxDETR.encode_template:
            hidden = _prompt(args[0], jnp)
            masks = jnp.ones((1, 2), jnp.int32)
            return {"hidden": hidden, "masks": masks, "aggregate": jagg(hidden, masks)}
        if method is JaxDETR.predict_masks:
            hs = args[2]
            return hs[..., 0, None, None] * PAT + hs[..., 1, None, None]
        x = args[0][0]
        logits = x[0, :Q, 0] + kw["lang_dict"]["aggregate"].mean() * x[0, :Q, 2]
        boxes = x[1:5, :Q, 0].T[None]
        hs = x[5:5 + D, :Q, 0].T[None]
        return {"pred_logits": logits[None, :, None], "pred_boxious": x[0, :Q, 1][None, :, None],
                "pred_boxes": boxes, "base_reference": boxes, "hs": hs, "pred_embeds": hs,
                "memory": jnp.zeros((1, 1, D))}


class _PortModel(nn.Module):
    """The same stand-in as a module of the port's interface."""

    def __init__(self):
        super().__init__()
        self.unused = nn.Parameter(torch.zeros(1))
        self.templates = 0

    def encode_template(self, crop, pad):
        self.templates += 1
        hidden = _prompt(crop, torch)
        masks = torch.ones((1, 2), dtype=torch.int32)
        return {"hidden": hidden, "masks": masks, "aggregate": agg_lang_feat(hidden, masks)}

    def predict_masks(self, memory, shapes, hs, ref, sizes):
        return hs[..., 0, None, None] * torch.from_numpy(PAT) + hs[..., 1, None, None]

    def forward(self, images, img_mask, sizes, ids, lang_mask, task, lang_dict, reid=True):
        x = images[0]
        logits = x[0, :Q, 0] + lang_dict["aggregate"].mean() * x[0, :Q, 2]
        boxes = x[1:5, :Q, 0].T[None]
        hs = x[5:5 + D, :Q, 0].T[None]
        out = {"pred_logits": logits[None, :, None], "pred_boxious": x[0, :Q, 1][None, :, None],
               "pred_boxes": boxes, "base_reference": boxes, "hs": hs,
               "memory": torch.zeros((1, 1, D)), "spatial_shapes": ((H // 8, W // 8),)}
        if reid:
            out["pred_embeds"] = hs
        return out


def _configs(base, **sot_kw):
    jc = getattr(jcfg, base)()
    tc = getattr(tcfg, base)()
    return (dataclasses.replace(jc, sot=dataclasses.replace(jc.sot, **sot_kw)),
            dataclasses.replace(tc, sot=dataclasses.replace(tc.sot, **sot_kw)))


PAD = np.zeros((1, H, W), bool)


@pytest.mark.parametrize("online_update", [False, True])
def test_sot_driver_matches_jax(online_update):
    """10 frames, the box of frame 0 given: the same boxes in pixels, and
    with `online_update` (every 2 frames above 0.7) templates re-encoded
    at the boxes found, which change the later choices."""
    jc, tc = _configs("tiny_test_config", online_update=online_update, update_interval=2)
    frames = _frames(10, seed=1)
    frames[4][0, 0, :Q, 1] = -8.0            # every score of frame 4 below 0.7
    box0 = np.array([20.0, 14.0, 52.0, 40.0], np.float32)
    jdrv = jsoti.SOTDriver(_JaxModel(), None, jc, H, W)
    want, _ = jdrv.run_video(frames, PAD, SIZES, box0)
    model = _PortModel()
    drv = sot_inference.SOTDriver(model, tc, device="cpu")
    got, times = drv.run_video(frames, PAD, SIZES, box0)
    assert got.shape == want.shape == (10, 4) and len(times) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if online_update:
        assert model.templates == 4             # frames 2, 6 and 8; frame 4 scores low
    else:
        assert model.templates == 1


def test_vos_driver_matches_jax():
    """8 frames, two objects (the second from frame 2, each with its gt
    mask), `inference_on_3f`: the label maps equal frame by frame, with the
    previous-frame templates refreshed from the merged masks (new objects,
    low scores and empty masks skipped) and maps below
    `inst_threshold_vos` zeroed."""
    jc, tc = _configs("tiny_video_test_config", inference_on_3f=True)
    frames = _frames(8, seed=2)
    m1 = np.zeros((H, W), np.float32)
    m1[10:40, 8:50] = 1
    m2 = np.zeros((H, W), np.float32)
    m2[30:70, 40:52] = 1                       # a thin mask in a wide box
    init = {1: {"frame": 0, "box_xyxy": np.array([8.0, 10.0, 50.0, 40.0]), "mask": m1},
            4: {"frame": 2, "box_xyxy": np.array([40.0, 30.0, 85.0, 70.0]), "mask": m2}}
    want = jsoti.VOSDriver(_JaxModel(), None, jc, H, W).run_video(frames, PAD, SIZES, init)
    model = _PortModel()
    got = sot_inference.VOSDriver(model, tc, device="cpu").run_video(frames, PAD, SIZES, init)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == (72, 88) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert (want[0] == 1).any() and not (want[1] == 4).any()
    assert any((w == 4).any() for w in want[2:])
    assert model.templates > 2 + 2                   # 3f refreshes happened


def test_vos_upsample_matches_jax_image_resize():
    """The x4 upsample of the mask logits: `F.interpolate(bilinear,
    align_corners=False)` against `jax.image.resize(..., "linear")`, which
    for an upsample applies no antialias and renormalises its edge taps to
    the edge value, as torch's clamped source coordinate does; within 1e-6."""
    import jax
    lg = np.random.RandomState(3).randn(20, 24).astype(np.float32) * 4
    want = jax.image.resize(jnp.asarray(lg), (80, 96), "linear")
    got = sot_inference.upsample_mask_logits(torch.from_numpy(lg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _rvos_pair(weight):
    jc, tc = _configs("tiny_video_test_config")
    jc = dataclasses.replace(jc, rvos_temporal_weight=weight)
    tc = dataclasses.replace(tc, rvos_temporal_weight=weight)
    jdrv = jmot.RVOSDriver(_JaxModel(), None, jc, H, W)
    drv = mot_inference.RVOSDriver(_PortModel(), tc, device="cpu")
    return jdrv, drv


def _expression(seed, shift=0.0):
    """A 6-token expression's features (2 tokens padding), mean near `shift`."""
    rng = np.random.RandomState(seed)
    lh = (rng.randn(1, 6, D) * 0.3 + shift).astype(np.float32)
    lm = np.array([[1, 1, 1, 1, 0, 0]], np.int32)
    return lh, lm


@pytest.mark.parametrize("weight", [0.0, 0.3])
def test_rvos_driver_matches_jax(weight):
    """6 frames with a padded 6-token expression: the same mask per frame at
    the original size; at 0.3 the reid cosine to the previous frame's
    choice moves the choice on some frame, at 0 it is frame-independent."""
    frames = _frames(6, seed=4)
    lh, lm = _expression(5)
    jdrv, drv = _rvos_pair(weight)
    want = jdrv.run_video(frames, PAD, SIZES, jnp.asarray(lh), jnp.asarray(lm), (60, 70))
    got = drv.run_video(frames, PAD, SIZES, torch.from_numpy(lh), torch.from_numpy(lm),
                        (60, 70))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (60, 70)
        np.testing.assert_array_equal(g, w)
    if weight:
        alone = _rvos_pair(0.0)[1].run_video(frames, PAD, SIZES, torch.from_numpy(lh),
                                             torch.from_numpy(lm), (60, 70))
        assert any((a != g).any() for a, g in zip(alone, got))


def test_refdavis_offline_matches_jax():
    """Two objects with two expressions each over 4 frames: the per-frame
    label maps at the original size equal (PIL resizes, mean over
    expressions, soft aggregation)."""
    frames = _frames(4, seed=6)
    exprs = {2: [_expression(7, 0.5), _expression(8, 0.4)],
             5: [_expression(9, -0.5), _expression(10, -0.4)]}
    jdrv, drv = _rvos_pair(0.3)
    want = jrvos.run_refdavis_offline(
        jdrv, frames, PAD, SIZES,
        {o: [(jnp.asarray(a), jnp.asarray(b)) for a, b in e] for o, e in exprs.items()},
        (60, 70))
    got = rvos_offline.run_refdavis_offline(
        drv, frames, PAD, SIZES,
        {o: [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in e]
         for o, e in exprs.items()}, (60, 70))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert {2, 5} <= set(np.unique(np.stack(want)))


# ---- host pieces, bit-equal ------------------------------------------------------

def test_soft_aggregate_and_expression_mean_are_bit_equal():
    rng = np.random.RandomState(11)
    probs = rng.rand(3, 17, 23).astype(np.float32)
    probs[:, 0, :5] = 0.5                                      # ties
    np.testing.assert_array_equal(sot_inference.soft_aggregate(probs),
                                  jsoti.soft_aggregate(probs))
    per = [rng.rand(4, 9, 11).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(rvos_offline.aggregate_expressions(per),
                                  jrvos.aggregate_expressions(per))
    objs = {3: per[0], 1: per[1]}
    for g, w in zip(rvos_offline.merge_objects_per_frame(objs),
                    jrvos.merge_objects_per_frame(objs)):
        np.testing.assert_array_equal(g, w)


def test_sot_evaluation_is_bit_equal(tmp_path):
    rng = np.random.RandomState(12)
    per_seq = {}
    for i in range(4):
        gt = np.concatenate([rng.uniform(0, 100, (20, 2)), rng.uniform(5, 40, (20, 2))], 1)
        pred = gt + rng.randn(20, 4) * (3 + 4 * i)
        gt[3, 2:] = 0                                          # an invisible frame
        per_seq[f"v{i}"] = {"pred": pred.astype(np.float32), "gt": gt.astype(np.float32)}
    for v in per_seq.values():
        assert sot_eval.evaluate_sot(v["pred"], v["gt"]) == jsot_eval.evaluate_sot(
            v["pred"], v["gt"])
    assert sot_eval.evaluate_sot_dataset(per_seq) == jsot_eval.evaluate_sot_dataset(per_seq)
    boxes = rng.uniform(0, 50, (6, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    sot_eval.save_sot_results(str(tmp_path / "port"), "vid", boxes, np.arange(6) * 0.01)
    jsot_eval.save_sot_results(str(tmp_path / "jax"), "vid", boxes, np.arange(6) * 0.01)
    assert len(_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))) == 2


def test_davis_evaluation_and_pngs_are_bit_equal(tmp_path):
    rng = np.random.RandomState(13)
    gt = {o: [rng.rand(30, 40) > 0.6 for _ in range(6)] for o in (1, 2)}
    pred = {1: [m ^ (rng.rand(30, 40) > 0.9) for m in gt[1]]}          # object 2 missed
    assert davis_eval.evaluate_davis(pred, gt) == jdavis.evaluate_davis(pred, gt)
    for a, b in ((gt[1][0], gt[2][1]), (np.zeros((5, 5), bool), np.zeros((5, 5), bool))):
        assert davis_eval.f_measure(a, b) == jdavis.f_measure(a, b)
    np.testing.assert_array_equal(davis_eval.davis_palette(), jdavis.davis_palette())
    label = rng.randint(0, 4, (30, 40)).astype(np.uint8)
    davis_eval.save_davis_png(label, str(tmp_path / "port" / "00000.png"))
    jdavis.save_davis_png(label, str(tmp_path / "jax" / "00000.png"))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    np.testing.assert_array_equal(davis_eval.load_davis_png(str(tmp_path / "port" / "00000.png")),
                                  label)


def test_referring_mini_ytvis_is_the_same(tmp_path):
    """`make_mini_ytvis(referring=True)` writes the same files in both
    packages (2+ objects of distinct categories, the first annotated, an
    `expressions` table), and `load_ytvis_json(has_expression=True)` reads
    the same records: the expressions and the task "grounding"."""
    kw = dict(n_train=2, n_val=2, length=3, max_objects=3, referring=True)
    jpaths = jmini.make_mini_ytvis(str(tmp_path / "jax"), **kw)
    paths = mini_coco.make_mini_ytvis(str(tmp_path / "port"), **kw)
    assert len(_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 4 * 3 + 2
    for split in ("train", "val"):
        jr = jvideo.load_ytvis_json(jpaths[f"{split}_json"], paths[f"{split}_root"],
                                    has_expression=True)
        r = video.load_ytvis_json(paths[f"{split}_json"], paths[f"{split}_root"],
                                  has_expression=True)
        assert r == jr
        assert all(rec["task"] == "grounding" and len(rec["expressions"]) == 1
                   and len(rec["tracks"]) == 1 for rec in r[0])
