"""The whole detection slice of the port vs the JAX `UninextDETR`, on the
CPU: forward + `postprocess_detection` at a small size, the weight bridge's
round trip through `convert_checkpoint`, and the port's independence from
JAX and the JAX package.

Config: `tiny_test_config()` with the small ViT backbone of
tests/test_model.py (embed 32, 2 blocks, block 1 global with its rel-pos
table stored at span 127 and shrunk to 7 and 11), fp32.
"""
import copy
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import (detection_inputs, detection_targets,
                                     jax_train_init, one_torch_thread, perturb,
                                     tiny_vit_config)
from uninext_tpu.engine.convert import convert_checkpoint
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.postprocess import postprocess_detection as jax_post
from uninext_tpu_torch.engine.convert import load_jax_params
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.models.postprocess import postprocess_detection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_vit_config()
    inputs = detection_inputs(0)
    jm = JaxDETR(cfg)
    # initialised through the training path, so the tree also holds the DN
    # label encoder (`dn_resizer`), which the port's model has
    params = perturb(jax_train_init(jm, inputs, detection_targets(0)))
    model = build_model(cfg, "cpu", seed=0)
    load_jax_params(model, params)
    return cfg, inputs, jm, params, model


def _class_token_map(C=5, T=16):
    m = np.zeros((C, T), bool)
    for c in range(C):
        m[c, 1 + 2 * c: 2 + 2 * c + (c % 2)] = True     # 1 or 2 tokens each
    return m


def test_detection_forward_and_postprocess_match_jax(pair):
    cfg, inputs, jm, params, model = pair
    want = jax.jit(lambda p: jm.apply(p, *inputs))(params)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs))
    for key in ("pred_logits", "pred_boxes", "pred_boxious"):
        assert got[key].shape == want[key].shape, key
        # fp32 through backbone, BERT, 2 + 2 transformer layers and heads
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    cmap = _class_token_map()
    jpost = jax.jit(lambda o: jax_post(o, cmap))(
        {k: want[k] for k in ("pred_logits", "pred_boxes", "pred_boxious")})
    with torch.inference_mode():
        post = postprocess_detection(got, torch.from_numpy(cmap))
    np.testing.assert_array_equal(post["query_idx"].numpy(),
                                  np.asarray(jpost["query_idx"]))
    np.testing.assert_array_equal(post["classes"].numpy(),
                                  np.asarray(jpost["classes"]))
    for key in ("boxes", "scores"):
        # same selections of values that agree to ~1e-6
        np.testing.assert_allclose(post[key].numpy(), np.asarray(jpost[key]),
                                   atol=1e-5, err_msg=key)


def test_bridge_round_trip_through_convert_checkpoint(pair):
    """JAX tree -> port (load_jax_params) -> port.state_dict() ->
    convert_checkpoint onto a zeroed tree gives back every JAX leaf
    exactly, with nothing missing, mismatched or unused."""
    cfg, inputs, jm, params, model = pair
    zeroed = jax.tree.map(np.zeros_like, params)
    back, report = convert_checkpoint(model.state_dict(), copy.deepcopy(zeroed))
    assert report["missing_target"] == []
    assert report["shape_mismatch"] == []
    assert report["unused_source"] == []
    # the template is zeroed: a leaf the port's state_dict did not fill would
    # come back as zeros, not as the perturbed value
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_port_runs_without_jax():
    """Importing the port, serving a request and taking a train step with
    the ViT and the R50 backbones (with R50 also the instance masks and
    REC/RES), running the three labs (`tools/`), the training loop with
    its data pipeline, checkpoints and COCO evaluation, and the video
    family (`VISDriver` over 2 frames, a two-frame train step, the VIS
    fixture tool's loop) and SOT (a template encode and a SOT frame through
    `SOTDriver`, a SOT train step), the C++ COCO matcher (built in the
    child if no earlier run left it), the parallel layer (one train step
    on a mesh of one rank), ConvNeXt (the fixture tool's loop, a template
    encode through a 4-channel ConvNeXt) and RoBERTa, at a tiny size, and
    importing the training
    recipe's modules (BoxInst's targets, the recipe's three fixture tools),
    leave jax, flax, optax, orbax and the JAX package (`uninext_tpu`,
    `uninext_tpu.*`) out of sys.modules: the H100 machine runs the port
    without them."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import uninext_tpu_torch
        from uninext_tpu_torch.config import BackboneConfig, tiny_test_config
        from uninext_tpu_torch.data.coco_categories import COCO_CATEGORIES
        from uninext_tpu_torch.data.prompts import create_label_token_map
        from uninext_tpu_torch.data.tokenizer import BertTokenizer
        from uninext_tpu_torch.engine.train import build_train_state, train_step
        from uninext_tpu_torch.models.detr import build_model
        from uninext_tpu_torch.models.postprocess import postprocess_detection
        import dataclasses
        cfg = dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
            name="vit_huge", vit_embed_dim=32, vit_depth=2, vit_num_heads=2,
            vit_window_size=4, vit_global_blocks=(1,), out_channels=(16, 32, 32)))
        p_ids, p_mask, cmap = create_label_token_map(COCO_CATEGORIES[:3],
                                                     BertTokenizer(), 16)
        model = build_model(cfg, "cpu", seed=3)
        rng = np.random.RandomState(1)
        images = torch.from_numpy(rng.randn(2, 64, 96, 3).astype(np.float32))
        img_mask = torch.zeros(2, 64, 96, dtype=torch.bool)
        img_mask[0, 48:] = True
        sizes = torch.tensor([[48, 96], [64, 96]])
        ids = torch.from_numpy(rng.randint(0, 1000, (2, 16)))
        tmask = torch.ones(2, 16, dtype=torch.int32)
        with torch.inference_mode():
            out = model(images, img_mask, sizes, ids, tmask)
            post = postprocess_detection(out, torch.eye(16, dtype=torch.bool)[:5])
        assert torch.isfinite(out["pred_logits"]).all()
        assert post["boxes"].shape == (2, 100, 4)
        state = build_train_state(cfg, "cpu", seed=3)
        G = cfg.data.max_insts                 # targets padded to max_insts
        boxes = torch.zeros(2, G, 4)
        boxes[:, 0] = torch.tensor([0.5, 0.5, 0.2, 0.3])
        valid = torch.zeros(2, G, dtype=torch.bool)
        valid[:, 0] = True
        pmap = torch.zeros(2, G, 16, dtype=torch.bool)
        pmap[:, 0] = torch.from_numpy(cmap[0])
        targets = {"boxes": boxes, "valid": valid, "positive_map": pmap}
        metrics = train_step(state, {"images": images, "img_mask": img_mask,
                                     "image_sizes": sizes,
                                     "text_ids": torch.from_numpy(p_ids).long()[None].expand(2, 16),
                                     "text_mask": torch.from_numpy(p_mask)[None].expand(2, 16),
                                     "targets": targets})
        assert torch.isfinite(metrics["total_loss"])
        # the R50 paths: detection, instance masks, REC/RES and a train step
        from uninext_tpu_torch.models.postprocess import postprocess_instseg, postprocess_rec
        r50 = tiny_test_config()
        model = build_model(r50, "cpu", seed=4)
        with torch.inference_mode():
            out = model(images, img_mask, sizes, ids, tmask)
            inst = postprocess_instseg(model, out, torch.eye(16, dtype=torch.bool)[:5], sizes)
            rec = postprocess_rec(model, model(images, img_mask, sizes, ids, tmask,
                                               task="grounding"), sizes)
        assert inst["mask_logits"].shape == (2, 100, 16, 24)
        assert rec["mask_logits"].shape == (2, 1, 16, 24) and rec["box"].shape == (2, 4)
        assert torch.isfinite(inst["mask_logits"]).all() and torch.isfinite(rec["box"]).all()
        state = build_train_state(r50, "cpu", seed=4)
        metrics = train_step(state, {"images": images, "img_mask": img_mask,
                                     "image_sizes": sizes,
                                     "text_ids": torch.from_numpy(p_ids).long()[None].expand(2, 16),
                                     "text_mask": torch.from_numpy(p_mask)[None].expand(2, 16),
                                     "targets": targets})
        assert torch.isfinite(metrics["total_loss"])
        from uninext_tpu_torch.tools import gather_probe, msda_v6_lab
        assert msda_v6_lab.parity("cpu") < 1e-4
        small = dict(r=64, tq=8, samp=4, m_steps=2)
        for probe in gather_probe.PROBES.values():
            out, ms = probe(device="cpu", **small)
            assert out.shape == (2, 8, 32) and torch.isfinite(out).all() and ms is None
        from uninext_tpu_torch.tools import dma_probe
        for key, probe in dma_probe.PROBES.items():
            out, ms = probe(device="cpu", r=64, k=4, tiles=8)
            rows = 8 * 8 if key != "3" else 8 * 4 * 8
            assert out.shape == (rows, 128) and torch.isfinite(out).all() and ms is None
        # the training loop and evaluation through the fixture AP tool at
        # tiny_test_config: mini-COCO, the LSJ mapper and the loader, 2
        # Trainer steps with masks and the final checkpoint, one evaluated
        # image (bbox and segm, the C++ matcher)
        import json
        import os
        import tempfile
        from uninext_tpu_torch.evaluation import fast_eval
        from uninext_tpu_torch.tools import ap_check
        with tempfile.TemporaryDirectory() as root:
            res = ap_check.main(["--steps", "2", "--n-train", "2", "--n-val", "1",
                                 "--device", "cpu", "--out", root + "/ap.json"])
            assert json.load(open(root + "/ap.json")) == json.loads(json.dumps(res))
        assert res["step_ms"]["steps"] == 2 and res["eval_seconds_per_image"]["images"] == 2
        assert all(res[k][m] is not None for k in ("bbox", "segm") for m in ("AP", "AP50"))
        # the C++ matcher itself, built here if no earlier run left it in
        # build/: the 2-step run above may match no detection at all
        ious = np.array([[0.9, 0.2], [0.6, 0.55], [0.1, 0.8]], np.float32)
        args = (ious, np.array([0, 1], np.uint8), np.array([0.5, 0.75], np.float32),
                np.zeros(3, np.uint8))
        got = fast_eval.coco_match(*args)
        assert all((a == b).all() for a, b in zip(got, fast_eval.coco_match_numpy(*args)))
        assert fast_eval.library.cache_info().currsize == 1
        assert fast_eval.library_path().exists()
        # the video family: VISDriver over 2 frames of tiny_video_test_config
        # with the deformable reid head, one two-frame train step, and the
        # fixture tool's loop (mini-YTVIS, Trainer(video=True), VISDriver,
        # the ytvis track mAP) at a tiny size
        from uninext_tpu_torch.config import tiny_video_test_config
        from uninext_tpu_torch.engine.video_inference import VISDriver
        vcfg = dataclasses.replace(tiny_video_test_config(), use_deformable_reid=True,
                                   detach_reid=True)
        model = build_model(vcfg, "cpu", seed=5)
        drv = VISDriver(model, vcfg, cmap[:3], device="cpu")
        frames = [images[1:], images[1:].roll(4, dims=2)]
        vis = drv.run_video(frames, torch.zeros(1, 64, 96, dtype=torch.bool),
                            torch.tensor([[64, 96]]), p_ids[None], p_mask[None],
                            ori_size=(64, 96))
        assert all(len(m) == 2 for m in vis["pred_masks"])
        state = build_train_state(vcfg, "cpu", seed=5)
        tk = {**targets, "has_masks": False}
        metrics = train_step(state, {
            "images_key": images, "images_ref": images.roll(4, dims=2),
            "img_mask": img_mask, "image_sizes": sizes,
            "text_ids": torch.from_numpy(p_ids).long()[None].expand(2, 16),
            "text_mask": torch.from_numpy(p_mask)[None].expand(2, 16),
            "targets_key": tk, "targets_ref": tk})
        assert torch.isfinite(metrics["total_loss"]) and metrics["loss_reid"] >= 0
        from uninext_tpu_torch.tools import vis_check
        with tempfile.TemporaryDirectory() as root:
            res = vis_check.main(["--steps", "2", "--n-train", "2", "--n-val", "1",
                                  "--device", "cpu", "--out", root + "/vis.json"])
        assert res["per_seed"][0]["vis_map"] is not None
        # SOT: a template encode (the 4-channel template R50 and the fuser)
        # and a SOT frame through SOTDriver, and a SOT train step
        from uninext_tpu_torch.engine.sot_inference import SOTDriver
        scfg = dataclasses.replace(vcfg, sot=dataclasses.replace(vcfg.sot, template_size=64))
        model = build_model(scfg, "cpu", seed=6, template=True)
        track, _ = SOTDriver(model, scfg, device="cpu").run_video(
            frames, torch.zeros(1, 64, 96, dtype=torch.bool), torch.tensor([[64, 96]]),
            np.array([20.0, 10.0, 60.0, 50.0], np.float32))
        assert track.shape == (2, 4) and np.isfinite(track).all()
        state = build_train_state(scfg, "cpu", seed=6, template=True)
        metrics = train_step(state, {
            "images_key": images, "images_ref": images.roll(4, dims=2),
            "img_mask": img_mask, "image_sizes": sizes, "targets_key": tk,
            "targets_ref": tk}, task="sot")
        assert torch.isfinite(metrics["total_loss"]) and "loss_reid" not in metrics
        # the parallel layer: one train step of the small ViT config with
        # its towers cut, on a mesh of one rank (gloo, CPU)
        import socket
        import torch.distributed as dist
        import uninext_tpu_torch.parallel
        from uninext_tpu_torch.parallel.mesh import create_mesh, init_distributed, shard_batch
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        init_distributed("gloo", "cpu")
        mesh = create_mesh(1)
        state = build_train_state(cfg, "cpu", seed=3, mesh=mesh, tp=True)
        metrics = train_step(state, shard_batch({
            "images": images, "img_mask": img_mask, "image_sizes": sizes,
            "text_ids": torch.from_numpy(p_ids).long()[None].expand(2, 16),
            "text_mask": torch.from_numpy(p_mask)[None].expand(2, 16),
            "targets": targets}, mesh))
        assert torch.isfinite(metrics["total_loss"]) and state.mesh is mesh
        dist.destroy_process_group()
        # ConvNeXt: the fixture tool's 2 steps and evaluation (the small
        # ConvNeXt model through Trainer and DetectionEvaluator), a template
        # encode through a 4-channel ConvNeXt, and RoBERTa's ids
        from uninext_tpu_torch.config import roberta_base_language
        from uninext_tpu_torch.models.bert import BertModel
        from uninext_tpu_torch.tools import convnext_check
        with tempfile.TemporaryDirectory() as root:
            res = convnext_check.main(["--steps", "2", "--n-train", "2", "--n-val", "1",
                                       "--device", "cpu", "--out", root + "/cx.json"])
        assert res["train"]["det_ap"] is not None and "serve" not in res
        ccfg = dataclasses.replace(convnext_check.tiny_convnext_cfg(2), sot=dataclasses.replace(
            scfg.sot, extra_backbone_for_template=True, feature_fusion=True))
        model = build_model(ccfg, "cpu", seed=7, template=True)
        with torch.inference_mode():
            lang = model.encode_template(torch.zeros(1, 64, 64, 4))
        assert lang["hidden"].shape == (1, 64, 64) and torch.isfinite(lang["hidden"]).all()
        rcfg = dataclasses.replace(roberta_base_language(), hidden_dim=32, num_layers=1,
                                   num_heads=2, intermediate_dim=64)
        with torch.inference_mode():
            enc = BertModel(rcfg)(torch.tensor([[0, 5, 7, 2, 1, 1]]),
                                  torch.tensor([[1, 1, 1, 1, 0, 0]]))
        assert enc["hidden"].shape == (1, 6, 32)
        # the training recipe's modules (their 2-step runs are tests below)
        import uninext_tpu_torch.data.boxinst
        import uninext_tpu_torch.tools.joint_check
        import uninext_tpu_torch.tools.pipeline_check
        import uninext_tpu_torch.tools.rec_check
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "uninext_tpu"))
        print("JAX_MODULES", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    # one OpenMP thread: the child runs beside other pytest workers on the
    # same cores (tests/torch_port_common.py:one_torch_thread)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


# ---- the training recipe's fixture tools at a tiny size ---------------------------
# The loader seeds are picked so that every routed task takes a step in two
# or three steps (the tools refuse a run that did not route each task).

@pytest.mark.usefixtures(one_torch_thread.__name__)
def test_rec_check_tool_runs(tmp_path):
    from uninext_tpu_torch.tools import rec_check
    res = rec_check.main(["--steps", "2", "--n-train", "2", "--n-val", "1", "--device", "cpu",
                          "--out", str(tmp_path / "rec.json")])
    seed = res["per_seed"][0]
    assert seed["step_ms"]["steps"] == 2
    assert all(seed[k] is not None for k in ("rec_p_at_50", "rec_oiou", "res_mask_p_at_50",
                                              "res_mask_miou", "res_mask_oiou"))


@pytest.mark.usefixtures(one_torch_thread.__name__)
def test_pipeline_check_tool_runs(tmp_path):
    """Stage 1 (BoxInst) saves, stage 2 restores and routes detection and
    grounding, stage 3 takes the hand-off and routes a VIS pair, then a SOT
    pair."""
    from uninext_tpu_torch.tools import pipeline_check
    res = pipeline_check.main(["--steps1", "2", "--steps2", "2", "--steps3", "2",
                               "--n-train", "2", "--n-val", "1", "--first-seed", "13",
                               "--device", "cpu", "--out", str(tmp_path / "pipe.json")])
    s1, s2, s3 = (res["per_seed"][0][k] for k in ("1_pretrain", "2_image_joint",
                                                   "3_video_joint"))
    assert s1["steps"] == s2["steps"] == s3["steps"] == 2
    assert s1["mask_ap_vs_real_gt_masks"] is not None and s2["det_ap"] is not None
    probe = s1["mask_logit_probe"]          # stage 1's mask logits at step 1 (of 1, 10, ...)
    assert [r["step"] for r in probe] == [1] and np.isfinite(probe[0]["mean_mask_logit"])
    assert probe[0]["loss_prj"] > 0
    assert set(s2["batches_read_per_task"]) == {"detection", "grounding"}
    assert set(s3["batches_read_per_task"]) == {"detection", "sot"}
    h = s3["handoff"]
    assert h["inflated"] == 1 and h["remapped_template"] > 0 and not h["mismatched"]


@pytest.mark.usefixtures(one_torch_thread.__name__)
def test_joint_check_tool_runs(tmp_path):
    from uninext_tpu_torch.tools import joint_check
    res = joint_check.main(["--steps", "3", "--n-train", "2", "--n-val", "1",
                            "--first-seed", "13", "--device", "cpu",
                            "--out", str(tmp_path / "joint.json")])
    seed = res["per_seed"][0]
    assert set(seed["batches_read_per_task"]) == {"detection", "grounding", "sot"}
    assert all(seed[k] is not None for k in (
        "joint_vis_map", "joint_mot_mota", "joint_mot_idf1", "joint_sot_auc",
        "joint_vos_jf", "joint_rvos_jf"))
