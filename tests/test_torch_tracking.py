"""The host side of the port's video family against the JAX package's, on
the same inputs: the IDOL and QDTrack trackers, `VISDriver` and
`MOTDriver` (with `associate`) on scripted frame outputs (the same ids,
scores, boxes and RLEs), the ytvis track mAP and CLEAR-MOT evaluators on
fixed results, the mini-YTVIS fixture (the same bytes on disk),
`load_ytvis_json`, `VideoPairMapper`, `collate_video`,
`pseudo_video_from_image` and the loader's pair batches, and
`Trainer(video=True)` with a checkpoint and a resume.

Trackers turn a 1e-6 change of an embedding into another track, so the
drivers are compared here on frame outputs scripted once and given to
both, never on whole videos tracked with random weights.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from tests.test_torch_data import _assert_same_sample, _same_tree
from tests.torch_port_common import one_torch_thread
from uninext_tpu.config import DataConfig as JDataConfig
from uninext_tpu.config import tiny_test_config as jax_tiny_config
from uninext_tpu.data import loader as jloader
from uninext_tpu.data import mini_coco as jmini
from uninext_tpu.data import video as jvideo
from uninext_tpu.data.tokenizer import BertTokenizer as JTokenizer
from uninext_tpu.engine import mot_inference as jmot
from uninext_tpu.engine import video_inference as jvis
from uninext_tpu.evaluation import mot_eval as jmot_eval
from uninext_tpu.evaluation import ytvis_eval as jytvis
from uninext_tpu.models import trackers as jtrackers
from uninext_tpu_torch.config import DataConfig, tiny_test_config, tiny_video_test_config
from uninext_tpu_torch.data import loader, mini_coco, video
from uninext_tpu_torch.data.masks import encode_mask
from uninext_tpu_torch.data.tokenizer import BertTokenizer
from uninext_tpu_torch.engine import mot_inference, video_inference
from uninext_tpu_torch.engine.checkpoint import state_differences
from uninext_tpu_torch.engine.trainer import Trainer
from uninext_tpu_torch.evaluation import mot_eval, ytvis_eval
from uninext_tpu_torch.models import trackers

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

K, C, D = video_inference.TOPK_VIS, 5, 8


# ---- scripted frame outputs ------------------------------------------------------

def _script(n_frames=12, seed=0, h=16, w=24):
    """Frame-step outputs (TOPK_VIS slots, normalised xyxy boxes) of a
    scripted video: four objects moving, each with its own embedding plus
    per-frame noise; object 2 leaves after frame 4 and comes back at
    frame 8, object 3 enters at frame 3; scores wander around 0.2-0.95 and
    a few low-score clutter boxes appear."""
    rng = np.random.RandomState(seed)
    objs = [dict(box=np.array([0.1, 0.1, 0.35, 0.4]), v=np.array([0.01, 0.005]),
                 label=1, score=0.9, emb=rng.randn(D) * 4),
            dict(box=np.array([0.55, 0.5, 0.85, 0.9]), v=np.array([-0.01, 0.0]),
                 label=3, score=0.8, emb=rng.randn(D) * 4),
            dict(box=np.array([0.4, 0.1, 0.6, 0.3]), v=np.array([0.0, 0.02]),
                 label=1, score=0.6, emb=rng.randn(D) * 4),
            dict(box=np.array([0.05, 0.6, 0.3, 0.95]), v=np.array([0.015, -0.01]),
                 label=2, score=0.55, emb=rng.randn(D) * 4)]
    frames = []
    for t in range(n_frames):
        out = {"query_idx": np.arange(K), "valid": np.zeros(K, bool),
               "scores_full": np.zeros((K, C), np.float32),
               "boxes": np.zeros((K, 4), np.float32),
               "boxes_cxcywh": np.zeros((K, 4), np.float32),
               "labels": np.zeros(K, np.int64), "max_scores": np.zeros(K, np.float32),
               "mask_logits": np.full((K, h, w), -5.0, np.float32),
               "embeds": np.zeros((K, D), np.float32)}
        present = [i for i in range(4) if not (i == 2 and 4 < t < 8) and not (i == 3 and t < 3)]
        dets = []
        for i in present:
            o = objs[i]
            shift = np.concatenate([o["v"], o["v"]]) * t
            score = float(np.clip(o["score"] + rng.uniform(-0.15, 0.1), 0.2, 0.95))
            dets.append((o["box"] + shift, o["label"], score,
                         o["emb"] + rng.randn(D) * 0.3))
        for _ in range(rng.randint(0, 3)):            # clutter
            xy = rng.uniform(0, 0.8, 2)
            dets.append((np.concatenate([xy, xy + 0.15]), rng.randint(C),
                         float(rng.uniform(0.1, 0.3)), rng.randn(D) * 4))
        order = rng.permutation(len(dets))
        for slot, j in enumerate(order):
            box, label, score, emb = dets[j]
            out["valid"][slot] = True
            out["boxes"][slot] = box
            out["labels"][slot] = label
            out["max_scores"][slot] = score
            out["scores_full"][slot] = rng.uniform(0, 0.05, C)
            out["scores_full"][slot, label] = score
            out["embeds"][slot] = emb
            x0, y0, x1, y1 = np.clip(box, 0, 1) * [w, h, w, h]
            out["mask_logits"][slot, int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))] = 5.0
        frames.append(out)
    return frames


@pytest.mark.parametrize("seed", [0, 1])
def test_trackers_match_jax(seed):
    """IDOL (with masks) and QDTrack on the same detections, frame by
    frame: the same kept detections and the same ids."""
    for jt, t, with_masks in ((jtrackers.IDOLTracker(), trackers.IDOLTracker(), True),
                              (jtrackers.QuasiDenseTracker(init_score_thr=0.5,
                                                           obj_score_thr=0.3),
                               trackers.QuasiDenseTracker(init_score_thr=0.5,
                                                          obj_score_thr=0.3), False)):
        ids_seen = set()
        for fi, o in enumerate(_script(seed=seed)):
            v = o["valid"]
            boxes = o["boxes"][v] * 256
            args = ([boxes, o["max_scores"][v], o["labels"][v]]
                    + ([o["mask_logits"][v]] if with_masks else []) + [o["embeds"][v], fi])
            jkeep, jids = jt.match(*[a.copy() if hasattr(a, "copy") else a for a in args])
            keep, ids = t.match(*args)
            np.testing.assert_array_equal(keep, jkeep)
            np.testing.assert_array_equal(ids, jids)
            ids_seen |= set(int(i) for i in ids if i >= 0)
        assert len(ids_seen) >= 3


class _JaxVIS(jvis.VISDriver):
    def __init__(self, cfg, script):
        self.cfg, self.params = cfg, None
        self.step = lambda params, frame, *a: script[int(frame)]


class _PortVIS(video_inference.VISDriver):
    def __init__(self, cfg, script):
        self.cfg = cfg
        self.encode_prompt = lambda ids, mask: None
        self.frame_outputs = lambda frame, *a: video_inference.to_host(
            {k: torch.from_numpy(v) for k, v in script[int(frame)].items()})


def test_vis_driver_matches_jax_on_scripted_frames():
    """12 scripted frames (pruning starts after frame 8) through both VIS
    drivers: the same tracks, labels, temporal scores and per-frame RLEs
    at the original size; the frame outputs pass `to_host`'s one copy."""
    script = _script(seed=2)
    frames = list(range(len(script)))
    sizes = np.array([[64, 96]])
    want = _JaxVIS(jax_tiny_config(), script).run_video(frames, None, sizes, None, None,
                                                        ori_size=(48, 80))
    got = _PortVIS(tiny_test_config(), script).run_video(frames, None, sizes, None, None,
                                                         ori_size=(48, 80))
    assert got == want
    assert len(want["pred_scores"]) >= 3
    assert any(sum(m is None for m in ms) for ms in want["pred_masks"])    # a gap


@pytest.mark.parametrize("with_masks", [False, True])
def test_mot_driver_matches_jax_on_scripted_frames(with_masks):
    """`MOTDriver.run_video` (detect, then `associate` with QDTrack) on the
    scripted frames: the same ids, categories, scores, boxes in original
    pixels and, for MOTS, masks."""
    script = _script(seed=3)
    frames = list(range(len(script)))
    sizes = np.array([[64, 96]])
    jd = object.__new__(jmot.MOTDriver)
    jd.cfg, jd.params, jd.with_masks = jax_tiny_config(), None, with_masks
    jd.step = lambda params, frame, *a: script[int(frame)]
    d = object.__new__(mot_inference.MOTDriver)
    d.cfg, d.with_masks = tiny_test_config(), with_masks
    d.encode_prompt = lambda ids, mask: None
    d.frame_outputs = lambda frame, *a: video_inference.to_host(
        {k: torch.from_numpy(v) for k, v in script[int(frame)].items()})
    want = jd.run_video(frames, None, sizes, None, None, ori_size=(48, 80))
    got = d.run_video(frames, None, sizes, None, None, ori_size=(48, 80))
    assert len(got) == len(want) == len(frames)
    n = 0
    for g_frame, w_frame in zip(got, want):
        assert len(g_frame) == len(w_frame)
        for g, w in zip(g_frame, w_frame):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), k)
            n += 1
    assert n > 10


def test_frame_step_outputs_reach_the_host_exactly():
    """`to_host` packs every output into one fp32 copy: booleans, indices
    and values come back with their dtypes and values."""
    rng = np.random.RandomState(0)
    outs = {"valid": torch.from_numpy(rng.rand(50) > 0.5),
            "query_idx": torch.from_numpy(rng.randint(0, 900, 50)),
            "embeds": torch.from_numpy(rng.randn(50, 256).astype(np.float32)),
            "mask_logits": torch.from_numpy(rng.randn(50, 4, 6).astype(np.float32))}
    got = video_inference.to_host(outs)
    for k, v in outs.items():
        assert got[k].dtype == v.numpy().dtype and np.array_equal(got[k], v.numpy()), k


# ---- evaluators ------------------------------------------------------------------

def _ytvis_case(seed=0, h=24, w=32, T=4):
    """Three videos: gts with gaps, predictions that match, shift, switch
    class or miss frames."""
    rng = np.random.RandomState(seed)

    def rect(x0, y0, x1, y1):
        m = np.zeros((h, w), bool)
        m[y0:y1, x0:x1] = True
        return encode_mask(m)

    videos, anns, results = [], [], []
    aid = 1
    for vid in range(1, 4):
        videos.append({"id": vid, "height": h, "width": w, "length": T,
                       "file_names": [f"{vid}/{t}.jpg" for t in range(T)]})
        for k in range(2):
            x0, y0 = rng.randint(0, 14), rng.randint(0, 10)
            segs = [rect(x0 + t, y0, x0 + t + 10, y0 + 9) if (t, k) != (2, 1) else None
                    for t in range(T)]
            anns.append({"id": aid, "video_id": vid, "category_id": 1 + (vid + k) % 3,
                         "segmentations": segs})
            aid += 1
            shift = rng.randint(0, 4)
            pred = [rect(x0 + t + shift, y0, x0 + t + shift + 10, y0 + 9)
                    if t != 3 or k == 0 else None for t in range(T)]
            results.append({"video_id": vid, "category_id": 1 + (vid + k + (vid == 3)) % 3,
                            "score": float(rng.uniform(0.3, 1.0)), "segmentations": pred})
    gt = {"videos": videos, "annotations": anns,
          "categories": [{"id": i, "name": str(i)} for i in (1, 2, 3)]}
    return gt, results


def test_ytvis_evaluation_matches_jax():
    gt, results = _ytvis_case()
    want = jytvis.evaluate_ytvis(results, gt)
    got = ytvis_eval.evaluate_ytvis(results, gt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_equal(got[k], want[k], k)
    assert 0 < want["AP"] < 1
    out = {"pred_scores": [0.9, 0.5], "pred_labels": [0, 2],
           "pred_masks": [[{"counts": "a"}, None], [None, None]]}
    assert ytvis_eval.video_output_to_ytvis(7, out) == jytvis.video_output_to_ytvis(7, out)


def test_mot_evaluation_matches_jax():
    """Three sequences of random tracks with misses, false positives and id
    switches: `evaluate_mot` per sequence and `pool_mot_metrics`."""
    rng = np.random.RandomState(4)
    per, jper = [], []
    for _ in range(3):
        gt, pred = [], []
        for t in range(8):
            n = rng.randint(1, 5)
            boxes = rng.uniform(0, 100, (n, 2))
            boxes = np.concatenate([boxes, boxes + rng.uniform(10, 30, (n, 2))], 1)
            ids = np.arange(n)
            gt.append({"ids": ids, "boxes": boxes})
            keep = rng.rand(n) > 0.2
            pboxes = boxes[keep] + rng.normal(0, 3, (keep.sum(), 4))
            pids = ids[keep] + (rng.rand(keep.sum()) > 0.9) * 10
            pred.append({"ids": pids, "boxes": pboxes})
        per.append(mot_eval.evaluate_mot(gt, pred))
        jper.append(jmot_eval.evaluate_mot(gt, pred))
        assert per[-1] == jper[-1]
    assert mot_eval.pool_mot_metrics(per) == jmot_eval.pool_mot_metrics(jper)


# ---- data ------------------------------------------------------------------------

DATA = dict(max_insts=8, max_text_len=32, min_size_train=(96,), max_size_train=128,
            min_size_test=96, max_size_test=128)


@pytest.fixture(scope="module")
def ytvis(tmp_path_factory):
    """Both packages' mini-YTVIS (3 train, 2 val videos of 6 frames),
    written from the same seed into two directories."""
    out = {}
    for name, mod in (("jax", jmini), ("port", mini_coco)):
        root = tmp_path_factory.mktemp(name)
        out[name] = (str(root), mod.make_mini_ytvis(str(root / "vis"), n_train=3, n_val=2))
    return out


def test_mini_ytvis_files_are_the_same(ytvis):
    (jroot, _), (root, _) = ytvis["jax"], ytvis["port"]
    names = _same_tree(jroot, root)
    assert len([n for n in names if n.endswith(".jpg")]) == (3 + 2) * 6
    assert len(names) == len(_same_tree(root, jroot))


def _video_records(ytvis, split="train"):
    _, paths = ytvis["port"]
    jr, jc = jvideo.load_ytvis_json(paths[f"{split}_json"], paths[f"{split}_root"])
    r, c = video.load_ytvis_json(paths[f"{split}_json"], paths[f"{split}_root"])
    assert (r, c) == (jr, jc) and len(r) > 0
    return jr, r, c


def _mappers(cats):
    jm = jvideo.VideoPairMapper(JDataConfig(**DATA), cats, JTokenizer(), is_train=True,
                                with_masks=True, sampling_frame_range=5)
    m = video.VideoPairMapper(DataConfig(**DATA), cats, BertTokenizer(), is_train=True,
                              with_masks=True, sampling_frame_range=5)
    return jm, m


def test_video_pair_mapper_and_collate_match_jax(ytvis):
    """Pairs of every train video (and of a pseudo-video from one frame) at
    three seeds: the same frames, crops, boxes, slots, validity, prompts
    and masks; `collate_video` of them equal."""
    jr, r, cats = _video_records(ytvis)
    jm, m = _mappers(cats)
    jpairs, pairs = [], []
    for rec_j, rec in zip(jr, r):
        for seed in range(3):
            jpairs.append(jm(rec_j, random.Random(seed)))
            pairs.append(m(rec, random.Random(seed)))
    still = {"file_name": r[0]["file_names"][0], "height": r[0]["height"],
             "width": r[0]["width"], "image_id": 5,
             "annotations": [{"bbox": t["bboxes"][0], "category_id": t["category_id"],
                              "segmentation": t["segmentations"][0]}
                             for t in r[0]["tracks"]]}
    pseudo = video.pseudo_video_from_image(still)
    assert pseudo == jvideo.pseudo_video_from_image(still)
    jpairs.append(jm(pseudo, random.Random(7)))
    pairs.append(m(pseudo, random.Random(7)))
    for (jk, jref), (k, ref) in zip(jpairs, pairs):
        _assert_same_sample(k, jk)
        _assert_same_sample(ref, jref)
    jb, b = jvideo.collate_video(jpairs[:2]), video.collate_video(pairs[:2])
    assert set(b) == set(jb)
    for key, v in jb.items():
        if isinstance(v, dict):
            assert set(b[key]) == set(v)
            for k2 in v:
                assert np.array_equal(b[key][k2], v[k2]), (key, k2)
        else:
            assert np.array_equal(b[key], v), key


def test_loader_pair_batches_match_jax(ytvis):
    """The weighted loader with the pair mapper (bs=2, 2 threads): the first
    two collated pair batches are bit-equal."""
    jr, r, cats = _video_records(ytvis)
    jm, m = _mappers(cats)
    jit = iter(jloader.MultiDatasetLoader([(jr, jm, 2)], [1.0], seed=1, num_workers=2))
    it = iter(loader.MultiDatasetLoader([(r, m, 2)], [1.0], seed=1, num_workers=2))
    try:
        for _ in range(2):
            jb, b = next(jit), next(it)
            assert set(b) == set(jb)
            for key, v in jb.items():
                if isinstance(v, dict):
                    for k2 in v:
                        assert np.array_equal(b[key][k2], v[k2]), (key, k2)
                else:
                    assert np.array_equal(b[key], v), key
            assert b["targets_ref"]["masks"].shape[:2] == (2, 8)
    finally:
        jit.close()
        it.close()


def test_trainer_video_checkpoint_and_resume(ytvis, tmp_path):
    """`Trainer(video=True)` on the CPU: 2 pair steps of
    `tiny_video_test_config` at 64x96 from the mini-YTVIS, with the reid
    losses and masks, a checkpoint at step 1 and at the end; a second
    trainer (other weights) resumes the final state bit-equal."""
    _, r, cats = _video_records(ytvis)
    base = tiny_video_test_config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, max_insts=8, max_text_len=32,
                                       min_size_train=(64,), max_size_train=96),
        solver=dataclasses.replace(base.solver, max_iter=2, checkpoint_period=1,
                                   warmup_iters=1))
    mapper = video.VideoPairMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                                   with_masks=True, sampling_frame_range=5)

    def trainer(seed):
        batches = iter(loader.MultiDatasetLoader([(r, mapper, 2)], [1.0], seed=0,
                                                 num_workers=1))
        return Trainer(cfg, batches, output_dir=str(tmp_path), device="cpu", seed=seed,
                       video=True, log_period=1)

    first = trainer(0)
    first.train()
    latest = first.storage.latest()
    assert {"loss_reid", "loss_reid_aux", "loss_mask", "grad_norm"} <= set(latest)
    assert first.state.step == 2 and first.ckpt.all_steps() == [1, 2]
    second = trainer(1)
    assert state_differences(first.state, second.state)            # other weights
    assert second.resume_or_load()
    assert state_differences(first.state, second.state) == []
    second.train()                                                  # nothing left to do
    assert second.state.step == 2


def test_video_train_step_refuses_sot():
    """The SOT step takes only (key, ref) pair batches, and only a model
    built with the template branch encodes a template."""
    from uninext_tpu_torch.engine.train import loss_and_grads
    from uninext_tpu_torch.models.detr import build_model
    with pytest.raises(ValueError, match="pair batch"):
        loss_and_grads(None, {"images": None}, {}, task="sot")
    model = build_model(tiny_test_config(), "cpu", seed=0)
    with pytest.raises(ValueError, match="template branch"):
        model.encode_template(torch.zeros(1, 64, 64, 3))


def test_trainer_refuses_a_pair_batch_without_video(ytvis, tmp_path):
    """`train_step` tells a pair batch by its `images_key`; `Trainer`'s
    `video` says which kind its loader must yield, and a batch of the other
    kind raises before any step."""
    _, r, cats = _video_records(ytvis)
    base = tiny_video_test_config()
    cfg = dataclasses.replace(base, data=dataclasses.replace(
        base.data, max_insts=8, max_text_len=32, min_size_train=(64,), max_size_train=96))
    mapper = video.VideoPairMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                                   with_masks=True, sampling_frame_range=5)
    batches = iter(loader.MultiDatasetLoader([(r, mapper, 2)], [1.0], seed=0,
                                             num_workers=1))
    t = Trainer(cfg, batches, output_dir=str(tmp_path), device="cpu", video=False)
    with pytest.raises(ValueError, match="pair batch"):
        t.train()
    assert t.state.step == 0
