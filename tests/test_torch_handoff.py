"""The training recipe's stage hand-off in the port against the JAX package
on the CPU: `load_stage_weights` on bridged trees (a tiny image tree into a
tiny video tree with the template branch) gives the weights of JAX's
`load_stage_weights` carried through `load_jax_params`, with counts that
agree through the bridge's leaf mapping; `tests/test_stage_handoff.py`'s
four cases on the port's names; `CheckpointManager.restore_params`; and a
routed `Trainer(video=True)` whose second batch is a SOT pair (ROADMAP
§3.23), whose state loads JAX's `init_all_paths` tree strictly. The JAX
trees come from `jax.eval_shape` and numpy, not a compiled init.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_sot import _random_tree
from tests.torch_port_common import bridge_sources, one_torch_thread
from uninext_tpu.engine.checkpoint import load_stage_weights as jax_load_stage_weights
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import init_all_paths
from uninext_tpu_torch.config import tiny_test_config, tiny_video_test_config
from uninext_tpu_torch.data.loader import MultiDatasetLoader
from uninext_tpu_torch.data.mini_coco import make_mini_ytvis
from uninext_tpu_torch.data.tokenizer import BertTokenizer
from uninext_tpu_torch.data.video import VideoPairMapper, load_ytvis_json
from uninext_tpu_torch.engine.checkpoint import (BACKBONE, TEMPLATE_BACKBONE,
                                                 CheckpointManager, inflate_conv_3c_to_4c,
                                                 load_stage_weights)
from uninext_tpu_torch.engine.convert import TEMPLATE_BRANCH, load_jax_params
from uninext_tpu_torch.engine.hooks import HookBase
from uninext_tpu_torch.engine.train import build_train_state
from uninext_tpu_torch.engine.trainer import Trainer
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


# ---- on bridged trees -------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """Random trees of `init_all_paths`'s shapes for `tiny_video_test_config`
    (the 4-channel template R50, the fuser, the reid head) and, with other
    values, of its image part, the tree of `tiny_test_config`'s training
    path with masks and DN (the video tree without the template branch and
    the reid head; the bridge's strict load into an image model checks
    that)."""
    img_cfg, vid_cfg = tiny_test_config(), tiny_video_test_config()
    shapes = jax.eval_shape(lambda r: init_all_paths(JaxDETR(vid_cfg), r, H=64, W=96),
                            jax.random.PRNGKey(0))
    image_part = {"params": {k: v for k, v in shapes["params"].items()
                             if k not in TEMPLATE_BRANCH and not k.startswith("reid_")}}
    return img_cfg, vid_cfg, _random_tree(image_part, seed=1), _random_tree(shapes, seed=2)


def test_load_stage_weights_matches_jax_through_the_bridge(trees):
    check_handoff_through_the_bridge(*trees, "stem.conv1.weight")


def check_handoff_through_the_bridge(img_cfg, vid_cfg, img_tree, vid_tree, stem):
    """The port's `load_stage_weights` on the bridged trees against JAX's
    carried through `load_jax_params`, the reports related through the
    bridge's leaf mapping, and the template backbone's stem convolution
    (`stem`, under the backbones' prefix) the image one with a zero 4th
    channel."""
    jout, jrep = jax_load_stage_weights(vid_tree["params"], img_tree["params"],
                                        verbose=False)
    img = build_model(img_cfg, "cpu", seed=0)
    load_jax_params(img, img_tree)
    vid = build_model(vid_cfg, "cpu", seed=1, template=True)
    load_jax_params(vid, vid_tree)
    sd, rep = load_stage_weights(vid.state_dict(), img.state_dict(), verbose=False)
    want = build_model(vid_cfg, "cpu", seed=3, template=True)
    load_jax_params(want, {"params": jax.tree.map(np.asarray, jout)})
    want_sd = want.state_dict()
    assert set(sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k
    # the report: JAX's in leaves, the port's in tensors, related by the
    # leaves each tensor is built from (the bridge unstacks the scan-stacked
    # encoder into per-layer paths: one JAX leaf for every layer's tensor)
    assert jrep["inflated"] == rep["inflated"] == 1
    assert not jrep["mismatched"] and not rep["mismatched"]
    sources = {k: {re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p) for p in src}
               for k, src in bridge_sources(vid_tree).items()}
    leaves = lambda keys: set().union(*(sources[k] for k in keys))
    j_missing = set(jrep["missing"])
    assert set(rep["missing"]) == {k for k, src in sources.items() if src <= j_missing}
    assert leaves(rep["missing"]) == j_missing
    assert rep["loaded"] + len(rep["missing"]) == len(sd)
    assert len(leaves(set(sd) - set(rep["missing"]))) == jrep["loaded"]
    template = [k for k in sd if k.startswith(TEMPLATE_BACKBONE)]
    assert rep["remapped_template"] == len(template)
    assert len(leaves(template)) == jrep["remapped_template"]
    conv1 = sd[TEMPLATE_BACKBONE + stem]
    assert torch.equal(conv1[:, :3], sd[BACKBONE + stem])
    assert not conv1[:, 3].any()
    return rep


# ---- tests/test_stage_handoff.py's cases on the port's names ---------------------

HEAD = "detr.detr.class_embed.0."


def _image_sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {BACKBONE + "stem.conv1.weight": torch.randn(8, 3, 7, 7, generator=g),
            BACKBONE + "res2.0.conv1.weight": torch.randn(16, 8, 1, 1, generator=g),
            HEAD + "weight": torch.randn(4, 16, generator=g),
            HEAD + "bias": torch.zeros(4)}


def _video_sd():
    sd = _image_sd(seed=99)
    sd[TEMPLATE_BACKBONE + "stem.conv1.weight"] = torch.full((8, 4, 7, 7), 0.5)
    sd[TEMPLATE_BACKBONE + "res2.0.conv1.weight"] = torch.full((16, 8, 1, 1), 0.5)
    sd["detr.reid_embed_head.layers.0.weight"] = torch.full((16, 16), 0.25)
    return sd


def test_exact_copy_and_report():
    src, tgt = _image_sd(1), _image_sd(2)
    out, rep = load_stage_weights(tgt, src, verbose=False)
    assert rep["loaded"] == 4 and not rep["missing"] and not rep["mismatched"]
    assert all(torch.equal(out[k], src[k]) for k in src)


def test_template_remap_with_inflation():
    src, tgt = _image_sd(3), _video_sd()
    out, rep = load_stage_weights(tgt, src, verbose=False)
    k = out[TEMPLATE_BACKBONE + "stem.conv1.weight"]
    assert k.shape == (8, 4, 7, 7)
    assert torch.equal(k[:, :3], src[BACKBONE + "stem.conv1.weight"])
    assert torch.equal(k[:, 3], torch.zeros(8, 7, 7))
    assert torch.equal(k, inflate_conv_3c_to_4c(src[BACKBONE + "stem.conv1.weight"]))
    assert torch.equal(out[TEMPLATE_BACKBONE + "res2.0.conv1.weight"],
                       src[BACKBONE + "res2.0.conv1.weight"])
    assert rep["inflated"] == 1 and rep["remapped_template"] == 2
    assert torch.equal(out["detr.reid_embed_head.layers.0.weight"],
                       tgt["detr.reid_embed_head.layers.0.weight"])
    assert rep["missing"] == ["detr.reid_embed_head.layers.0.weight"]


def test_shape_mismatch_skipped():
    src, tgt = _image_sd(4), _image_sd(5)
    src[HEAD + "weight"] = torch.zeros(11, 16)            # a wrong fan-out
    out, rep = load_stage_weights(tgt, src, verbose=False)
    assert torch.equal(out[HEAD + "weight"], tgt[HEAD + "weight"])
    assert len(rep["mismatched"]) == 1 and HEAD + "weight" in rep["mismatched"][0]
    assert rep["loaded"] == 3


def test_inflate_disabled():
    src, tgt = _image_sd(6), _video_sd()
    out, rep = load_stage_weights(tgt, src, inflate_4c=False, verbose=False)
    assert torch.equal(out[TEMPLATE_BACKBONE + "stem.conv1.weight"],
                       tgt[TEMPLATE_BACKBONE + "stem.conv1.weight"])
    assert rep["inflated"] == 0 and len(rep["mismatched"]) == 1


# ---- restore_params ---------------------------------------------------------------

def test_restore_params_round_trip(tmp_path):
    """The model's weights of a saved step into a model of other weights,
    bit-equal; the optimizer and step untouched; no file, no load."""
    cfg = tiny_test_config()
    state = build_train_state(cfg, "cpu", seed=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore_params(build_model(cfg, "cpu", seed=1))[1] is False
    state.step = 7
    mgr.save(7, state)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    mgr.save(9, state)
    other = build_train_state(cfg, "cpu", seed=2)
    model, found = mgr.restore_params(other.model, step=7)
    assert found and model is other.model and other.step == 0
    assert other.optimizer.count == 0
    saved = torch.load(mgr.path(7), weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    mgr.restore_params(model)                             # the latest, step 9
    assert torch.equal(next(model.parameters()), next(state.model.parameters()))


# ---- ROADMAP §3.23: a routed video Trainer -----------------------------------------

def test_routed_video_trainer_takes_a_later_sot_batch(trees, tmp_path):
    """`Trainer(video=True)` (task "detection") on a routed loader whose
    first batch is a VIS pair and second a SOT pair builds the template
    branch (JAX's `init_all`), takes both steps, and its checkpoint holds
    every branch: the state loads JAX's `init_all_paths` tree of the config
    strictly both ways (the config differs from `tiny_video_test_config` in
    its data, template size and schedule, none of which shapes a
    parameter). An unrouted one keeps JAX's single-task state (no
    template branch)."""
    base = tiny_video_test_config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, max_insts=8, max_text_len=32,
                                       min_size_train=(64,), max_size_train=96),
        sot=dataclasses.replace(base.sot, template_size=64),
        solver=dataclasses.replace(base.solver, max_iter=2, warmup_iters=1))
    paths = make_mini_ytvis(str(tmp_path / "vis"), n_train=2, n_val=1)
    recs, cats = load_ytvis_json(paths["train_json"], paths["train_root"])
    mapper = VideoPairMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                             with_masks=True, sampling_frame_range=5)
    its = [(task, iter(MultiDatasetLoader([(recs, mapper, 2)], [1.0], seed=i,
                                          num_workers=1)))
           for i, task in enumerate(("detection", "sot"))]

    def routed():                       # a detection pair, then a SOT pair, ...
        while True:
            for task, it in its:
                yield {**next(it), "__task__": task}

    class Log(HookBase):
        def __init__(self):
            self.keys = []

        def after_step(self, trainer, metrics):
            self.keys.append(set(metrics))

    log = Log()
    try:
        trainer = Trainer(cfg, routed(), output_dir=str(tmp_path / "run"), device="cpu",
                          seed=0, video=True, log_period=1, extra_hooks=[log])
        assert trainer.model.template
        trainer.train()
        single = Trainer(cfg, its[0][1], output_dir=str(tmp_path / "one"), device="cpu",
                         video=True)
        assert not single.model.template
    finally:
        for _, it in its:
            it.close()
    assert trainer.state.step == 2
    assert "loss_reid" in log.keys[0] and "loss_reid" not in log.keys[1]
    load_jax_params(trainer.model, trees[3])    # strict both ways (the same shapes)
    ckpt = trainer.ckpt.path(trainer.ckpt.latest_step())
    model = build_model(cfg, "cpu", seed=5, template=True)
    model.load_state_dict(torch.load(ckpt, weights_only=True)["model"])   # every branch saved
