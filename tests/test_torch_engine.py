"""The port's training loop and evaluation on the CPU: the COCO evaluator
(the C++ matcher built by g++, and its plain numpy version) against the JAX
package's on fixed detections; `DetectionEvaluator` against the JAX one on
mini-COCO images with the same weights (`load_jax_params`); and `Trainer`
with its checkpoints, resumed bit-equal, and with gradient accumulation.

The small ViT config of `tests/torch_port_common.py` at 64x96, fp32.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uninext_tpu.models.detr as jdetr
from tests.torch_port_common import (detection_inputs, detection_targets, one_torch_thread, perturb,
                                     tiny_vit_config, tiny_vit_init)
from uninext_tpu.data.coco import UniDatasetMapper as JMapper
from uninext_tpu.data.tokenizer import BertTokenizer as JTokenizer
from uninext_tpu.engine.evaluator import DetectionEvaluator as JEvaluator
from uninext_tpu.evaluation import coco_eval as jcoco_eval
from uninext_tpu_torch.data.coco import UniDatasetMapper, load_coco_json
from uninext_tpu_torch.data.loader import MultiDatasetLoader
from uninext_tpu_torch.data.mini_coco import make_mini_coco
from uninext_tpu_torch.data.prompts import create_label_token_map
from uninext_tpu_torch.data.tokenizer import BertTokenizer
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine.checkpoint import state_differences
from uninext_tpu_torch.engine.evaluator import DetectionEvaluator
from uninext_tpu_torch.engine.hooks import HookBase
from uninext_tpu_torch.engine.train import TrainState
from uninext_tpu_torch.engine.trainer import Trainer
from uninext_tpu_torch.evaluation import coco_eval, fast_eval
from uninext_tpu_torch.models import mask_head
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# eval images of the fixture (about 280 x 360) resized to 64 x ~82, padded to
# 64 x 96; training on a 64 x 64 LSJ canvas
SMALL = dict(min_size_test=64, max_size_test=96, max_text_len=32)


def _small_cfg(**solver):
    cfg = tiny_vit_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **SMALL),
        solver=dataclasses.replace(cfg.solver, **solver))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_coco")
    paths = make_mini_coco(str(root), n_train=4, n_val=3)
    train, cats = load_coco_json(paths["train_json"], paths["train_root"])
    val, _ = load_coco_json(paths["val_json"], paths["val_root"])
    return train, val, cats


# ---- COCO evaluation ---------------------------------------------------------------

def _coco_case(seed, n_img=6, C=3, H=40, W=56):
    """Per image: gts with boxes, classes and masks; detections near some of
    them (and some elsewhere), scores with ties."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(n_img):
        n = rng.randint(1, 6)
        xy = rng.uniform(0, 30, (n, 2))
        wh = rng.uniform(4, 25, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        cls = rng.randint(0, C, n)
        gm = [np.zeros((H, W), bool) for _ in range(n)]
        for m, b in zip(gm, boxes.astype(int)):
            m[b[1]:b[3], b[0]:b[2]] = True
        k = rng.randint(0, 9)
        src = rng.randint(0, n, k)
        pb = boxes[src] + rng.normal(0, 2, (k, 4)).astype(np.float32)
        pc = np.where(rng.rand(k) < 0.8, cls[src], rng.randint(0, C, k))
        scores = np.round(rng.rand(k), 1).astype(np.float32)       # ties
        pm = [np.roll(gm[s], rng.randint(-2, 3), axis=1) for s in src]
        gts.append({"boxes": boxes, "classes": cls, "masks": gm})
        preds.append({"boxes": pb, "scores": scores, "classes": pc, "masks": pm})
    return gts, preds


def test_cpp_matcher_equals_numpy():
    rng = np.random.RandomState(0)
    thrs = jcoco_eval.IOU_THRS
    for n_det, n_gt in ((7, 5), (1, 1), (12, 0), (0, 4), (30, 9)):
        ious = np.round(rng.rand(n_det, n_gt), 2).astype(np.float32)
        gt_ig = np.sort(rng.rand(n_gt) > 0.7).astype(np.uint8)        # ignored last
        dim = (rng.rand(n_det) > 0.8).astype(np.uint8)
        got = fast_eval.coco_match(ious, gt_ig, thrs, dim)
        want = fast_eval.coco_match_numpy(ious, gt_ig, thrs, dim)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert fast_eval.library_path().parent.name == "uninext_tpu_torch"


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("matcher", ["cpp", "numpy"])
def test_coco_evaluator_matches_jax(iou_type, matcher):
    """AP, AP50, AP75 and the area ranges equal the JAX evaluator's on the
    same detections (the same float64 accumulation, so exactly)."""
    gts, preds = _coco_case(1)
    ev = coco_eval.COCOEvaluator(iou_type, matcher={
        "cpp": fast_eval.coco_match, "numpy": fast_eval.coco_match_numpy}[matcher])
    jev = jcoco_eval.COCOEvaluator(iou_type)
    for g, p in zip(gts, preds):
        ev.add(g, p)
        jev.add(g, p)
    got, want = ev.evaluate(), jev.evaluate()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    assert 0 < got["AP"] < 1


# ---- DetectionEvaluator --------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory, worker_id):
    cfg = _small_cfg()
    inputs = detection_inputs(5)
    targets = detection_targets(6, G=cfg.data.max_insts)
    jm = jdetr.UninextDETR(cfg)
    params = perturb(tiny_vit_init(tmp_path_factory, worker_id))
    model = build_model(cfg, "cpu", seed=0)
    convert.load_jax_params(model, params)
    return cfg, jm, params, model


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_detection_evaluator_matches_jax(eval_pair, mini, iou_type):
    """Three mini-COCO val images: per image the same kept boxes, scores and
    classes (and with masks the same mask logits) as the JAX evaluator's
    step, then the AP dict within 1e-6."""
    cfg, jm, params, model = eval_pair
    _, val, cats = mini
    with_masks = iou_type == "segm"
    mapper = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=False,
                              with_masks=True)
    jmapper = JMapper(jm.cfg.data, cats, JTokenizer(), is_train=False, with_masks=True)
    _, _, cmap = create_label_token_map(cats, BertTokenizer(), cfg.data.max_text_len)
    ev = DetectionEvaluator(model, cfg, cmap, with_masks=with_masks)
    jev = JEvaluator(jm, jm.cfg, cmap, with_masks=with_masks)
    for rec in val:
        s = mapper(rec)
        got = ev.predict(s)
        want = jev._step_for(*s.bucket)(params["params"], *(jnp.asarray(x[None]) for x in (
            s.image, s.img_mask, s.image_size, s.text_ids, s.text_mask)))
        want = {k: np.asarray(v)[0] for k, v in want.items()}
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["classes"], want["classes"])
        np.testing.assert_array_equal(got["query_idx"], want["query_idx"])
        # fp32 through the model: ~1e-6 relative, as the serving tests
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=2e-6)
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=2e-6)
        if with_masks:
            scale = np.abs(want["mask_logits"]).max()
            np.testing.assert_allclose(got["mask_logits"], want["mask_logits"], rtol=0,
                                       atol=2e-5 * scale)
    res = ev.evaluate(val, mapper, score_thr=0.05)
    jres = jev.evaluate(params["params"], val, jmapper, score_thr=0.05, batched=False)
    assert set(res) == set(jres)
    for k, v in jres.items():
        np.testing.assert_allclose(res[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert len(ev.times) == 2 * len(val) and not model.training


def test_refcoco_evaluation_matches_jax(eval_pair, tmp_path):
    """REC (top-1 box) and RES (top-1 mask) metrics of four mini-RefCOCO
    expressions against the JAX package's `evaluate_refcoco` and
    `evaluate_res` with the same weights."""
    from uninext_tpu.engine import evaluator as jevaluator
    from uninext_tpu_torch.data.coco import load_refcoco_json
    from uninext_tpu_torch.data.mini_coco import make_mini_refcoco
    from uninext_tpu_torch.engine.evaluator import evaluate_refcoco, evaluate_res
    cfg, jm, params, model = eval_pair
    paths = make_mini_refcoco(str(tmp_path), n_train=1, n_val=2)
    recs = load_refcoco_json(paths["val_json"], paths["val_root"])[:4]
    mapper = UniDatasetMapper(cfg.data, ["object"], BertTokenizer(), is_train=False,
                              with_masks=False)
    jmapper = JMapper(jm.cfg.data, ["object"], JTokenizer(), is_train=False,
                      with_masks=False)
    for port_fn, jax_fn in ((evaluate_refcoco, jevaluator.evaluate_refcoco),
                            (evaluate_res, jevaluator.evaluate_res)):
        got = port_fn(model, recs, mapper)
        want = jax_fn(jm, jm.cfg, params["params"], recs, jmapper)
        assert set(got) == set(want)
        for k, v in want.items():
            # IoUs of boxes and thresholded masks from fp32 outputs ~1e-6 apart
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4, err_msg=k)


# ---- Trainer -----------------------------------------------------------------------

class _Snapshot(HookBase):
    """A copy of the train state after micro-step `at`."""

    def __init__(self, at):
        self.at, self.state = at, None

    def after_step(self, trainer, metrics):
        if trainer.storage.iter + 1 == self.at:
            s = trainer.state
            model, opt = copy.deepcopy((s.model, s.optimizer))
            gen = torch.Generator().set_state(s.generator.get_state())
            self.state = TrainState(model, opt, gen, s.step)


def _trainer(cfg, train, cats, out, seed, hooks=(), **kw):
    mapper = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                              with_masks=True, lsj=True, lsj_size=64)
    loader = MultiDatasetLoader([(train, mapper, 2)], [1.0], seed=0, num_workers=1)
    return Trainer(cfg, iter(loader), output_dir=str(out), device="cpu", seed=seed,
                   log_period=1, extra_hooks=list(hooks), **kw)


def test_trainer_checkpoint_resumes_bit_equal(mini, tmp_path):
    """3 steps with masks, saved at step 2 and at the end: a trainer with
    other weights restores step 2 bit-equal to the state the first had
    there, and `resume_or_load` the final state."""
    train, _, cats = mini
    cfg = _small_cfg(max_iter=3, checkpoint_period=2)
    snap = _Snapshot(2)
    first = _trainer(cfg, train, cats, tmp_path, seed=0, hooks=[snap])
    first.train()
    assert first.ckpt.all_steps() == [2, 3] and first.state.step == 3
    losses = [k for k in first.storage.latest() if k.startswith("loss_mask")]
    assert losses, "the fixture's masks must reach the losses"
    second = _trainer(cfg, train, cats, tmp_path, seed=1)
    assert state_differences(snap.state, second.state)           # other weights
    second.ckpt.restore(second.state, step=2)
    assert state_differences(snap.state, second.state) == []
    assert second.resume_or_load()
    assert state_differences(first.state, second.state) == []
    second.train()                                                 # nothing left to do
    assert second.state.step == 3


def test_trainer_accumulates_in_update_units(mini, tmp_path):
    """grad_accum_steps 2, max_iter 2: 4 micro-steps, 2 updates; the
    periodic hooks fire once per update (micro-steps 2 and 4): checkpoints,
    the learning rate and an evaluation with masks, whose best result is
    saved. Training after an evaluation (under inference mode) works."""
    train, val, cats = mini
    cfg = _small_cfg(max_iter=2, checkpoint_period=1, grad_accum_steps=2)
    _, _, cmap = create_label_token_map(cats, BertTokenizer(), cfg.data.max_text_len)
    eval_mapper = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=False,
                                   with_masks=True)
    evals = []

    def eval_fn(model):
        evals.append(t.state.step)
        ev = DetectionEvaluator(model, cfg, cmap, with_masks=True)
        return ev.evaluate(val[:1], eval_mapper, score_thr=0.05)

    mapper = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                              with_masks=True, lsj=True, lsj_size=64)
    loader = MultiDatasetLoader([(train, mapper, 2)], [1.0], seed=0, num_workers=1)
    t = Trainer(cfg, iter(loader), output_dir=str(tmp_path), device="cpu", log_period=1,
                eval_fn=eval_fn, eval_period=1)
    # an evaluation first, with nothing cached: what it caches under
    # inference mode (the mask head's interpolation matrices) training reuses
    mask_head._aligned_bilinear_matrix.cache_clear()
    eval_fn(t.model)
    t.train()
    assert t.state.step == 4 and t.state.optimizer.count == 2
    assert t.ckpt.all_steps() == [2, 4] and evals == [0, 2, 4]
    latest = t.storage.latest()
    assert {"eval/AP", "lr", "grad_norm"} <= set(latest) and t.model.training


def test_trainer_profiles_its_window(mini, tmp_path):
    """`profile_iters` (1, 2): micro-step 1 runs under torch.profiler, whose
    Chrome trace lands in <output_dir>/profile and holds the step's ops."""
    import json
    train, _, cats = mini
    t = _trainer(_small_cfg(max_iter=3, checkpoint_period=10), train, cats, tmp_path,
                 seed=0, profile_iters=(1, 2))
    t.train()
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"aten::convolution", "aten::mm"} <= names, sorted(names)[:20]
    assert t.state.step == 3


class _SaveMidUpdate(HookBase):
    def __init__(self):
        self.error = None

    def after_step(self, trainer, metrics):
        if trainer.storage.iter == 0:
            with pytest.raises(ValueError, match="pending") as e:
                trainer.ckpt.save(1, trainer.state)
            self.error = e.value


def test_checkpoint_refuses_a_save_inside_an_update(mini, tmp_path):
    """With grad_accum_steps 2, a save after the first micro-step of an
    update (a summed gradient pending) raises and writes nothing; the
    periodic save after the update is taken."""
    train, _, cats = mini
    cfg = _small_cfg(max_iter=1, checkpoint_period=1, grad_accum_steps=2)
    probe = _SaveMidUpdate()
    t = _trainer(cfg, train, cats, tmp_path, seed=0, hooks=[probe])
    t.train()
    assert probe.error is not None and t.ckpt.all_steps() == [2]
