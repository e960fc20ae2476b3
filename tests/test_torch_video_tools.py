"""The port's video tools against the JAX tools on the CPU:
`uninext_tpu_torch/tools/grid_search_track.py` (`run_grid` over
synthetic detection caches, the refusal of obj thresholds below the
caches' floor, the cache format both ways) and
`uninext_tpu_torch/tools/rvos_diag.py` (`decompose` on one referring
mini-YTVIS video from the same weights), and the optimizer groups of a ViT
template branch against JAX's `classify_param`.

`tools/` is no package: the JAX tools are imported by file path with
`sys.path` restored after (tools/rvos_diag.py's `decompose` imports
`_evidence_common` from `tools/` when called, so the path is put back for
that call). The model is the small ViT config
(`tests/torch_port_common.py:tiny_vit_config`) with the reid head (the
R-VOS frame step scores with it) and the 4-channel template branch, on
frames of 64x96; its JAX tree is `_random_tree` of `init_all_paths`'s
`jax.eval_shape` (no compiled init), bridged whole by `load_jax_params`.
"""
import contextlib
import dataclasses
import importlib.util
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_sot import _random_tree
from tests.torch_port_common import (bridge_sources, one_torch_thread, shared_across_workers,
                                     tiny_vit_config)
from uninext_tpu.engine import optimizer as joptim
from uninext_tpu.models.detr import UninextDETR as JaxDETR
from uninext_tpu.models.detr import init_all_paths
from uninext_tpu_torch.engine import convert
from uninext_tpu_torch.engine import optimizer as optim
from uninext_tpu_torch.models.detr import build_model
from uninext_tpu_torch.tools import eval_video, grid_search_track, rvos_diag

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
H, W = 64, 96                   # the R-VOS video's frames, the network's size


@contextlib.contextmanager
def _tools_on_path():
    saved = list(sys.path)
    sys.path.insert(0, TOOLS)
    try:
        yield
    finally:
        sys.path[:] = saved


def _jax_tool(name):
    """tools/<name>.py imported by path (it puts the repo and tools/ on
    sys.path when imported; both are taken out again)."""
    with _tools_on_path():
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                      os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


# ---- grid_search_track --------------------------------------------------------------

SELECT_THR = 0.1
INIT_THRS = [0.3, 0.5, 0.7, 0.9]
OBJ_THRS = [0.1, 0.2, 0.3, 0.5]


def _sequences(seed=0, n_seq=3, T=6, E=8):
    """Detection caches of `n_seq` sequences of T frames: 2-8 objects
    moving linearly (normalised xyxy boxes, each with an embedding of its
    own), each seen in a frame with probability 0.85 and detected with 0.8
    (boxes jittered, scores in [0.1, 1), the embedding plus noise), 0-4
    false positives (scores in [0.1, 0.6)); one frame with no detection.
    gt: the seen objects' ids and boxes in original pixels. Returns [(raw
    frames, image_size, ori_size, gt frames)]."""
    rng = np.random.RandomState(seed)
    seqs = []
    for s in range(n_seq):
        ori = (360, 640)
        scale = np.array([ori[1], ori[0]] * 2, np.float32)
        n_obj = rng.randint(2, 9)
        start = rng.uniform(0.05, 0.6, (n_obj, 2))
        size = rng.uniform(0.08, 0.3, (n_obj, 2))
        vel = rng.uniform(-0.03, 0.03, (n_obj, 2))
        emb = rng.randn(n_obj, E)
        raw, gt = [], []
        for t in range(T):
            xy = start + vel * t
            boxes = np.concatenate([xy, xy + size], 1).clip(0, 1)
            seen = rng.rand(n_obj) < 0.85
            gt.append({"ids": np.nonzero(seen)[0].astype(np.int64) + 10 * s,
                       "boxes": (boxes[seen] * scale).astype(np.float32)})
            det = seen & (rng.rand(n_obj) < 0.8)
            n_fp = rng.randint(0, 5)
            fp_xy = rng.uniform(0, 0.7, (n_fp, 2))
            b = np.concatenate([boxes[det] + rng.normal(0, 0.004, (det.sum(), 4)),
                                np.concatenate([fp_xy, fp_xy + 0.15], 1)])
            frame = {"boxes": b.astype(np.float32),
                     "scores": np.concatenate([rng.uniform(0.1, 1.0, det.sum()),
                                               rng.uniform(0.1, 0.6, n_fp)]).astype(np.float32),
                     "labels": rng.randint(0, 3, len(b)).astype(np.int64),
                     "embeds": np.concatenate([emb[det] + 0.2 * rng.randn(det.sum(), E),
                                               rng.randn(n_fp, E)]).astype(np.float32)}
            if s == 1 and t == 3:
                frame = {k: v[:0] for k, v in frame.items()}
            raw.append(frame)
        seqs.append((raw, (int(ori[0] * 0.9), int(ori[1] * 0.9)), ori, gt))
    return seqs


def test_run_grid_matches_jax():
    """Every grid entry equal to the JAX tool's (MOTA and IDF1 within 1e-12,
    IDS, FP and FN exactly, the same points skipped for init <= obj), the
    same best point; both refuse an obj threshold below the caches'
    `select_thr`."""
    jtool = _jax_tool("grid_search_track")
    seqs = _sequences()
    n_dets = [len(f["boxes"]) for raw, *_ in seqs for f in raw]
    assert min(n_dets) == 0 and max(n_dets) <= 12 and sum(n_dets) > 60
    got, best = grid_search_track.run_grid(seqs, INIT_THRS, OBJ_THRS,
                                           cache_select_thr=SELECT_THR)
    want, jbest = jtool.run_grid(seqs, INIT_THRS, OBJ_THRS, cache_select_thr=SELECT_THR)
    assert len(got) == len(want) == 13
    by_point = {(e["init_score_thr"], e["obj_score_thr"]): e for e in want}
    for e in got:
        w = by_point[(e["init_score_thr"], e["obj_score_thr"])]
        for k in ("MOTA", "IDF1"):
            assert abs(e[k] - w[k]) <= 1e-12, (e, w)
        assert (e["IDS"], e["FP"], e["FN"]) == (w["IDS"], w["FP"], w["FN"]), (e, w)
    assert len({(e["MOTA"], e["IDS"]) for e in got}) > 3      # the thresholds matter
    assert (best["init_score_thr"], best["obj_score_thr"]) == \
        (jbest["init_score_thr"], jbest["obj_score_thr"])
    for tool in (grid_search_track, jtool):
        with pytest.raises(ValueError, match="below the caches' select_thr"):
            tool.run_grid(seqs, INIT_THRS, [0.05, 0.3], cache_select_thr=SELECT_THR)
    assert grid_search_track._parse_range("0.2:0.7:0.1") == jtool._parse_range("0.2:0.7:0.1")


def _same_cache(a, b):
    (raw_a, size_a, ori_a, gt_a, thr_a), (raw_b, size_b, ori_b, gt_b, thr_b) = a, b
    assert (size_a, ori_a, thr_a) == (size_b, ori_b, thr_b)
    for fa, fb in zip(raw_a + gt_a, raw_b + gt_b, strict=True):
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def test_detection_cache_round_trips_between_the_tools(tmp_path):
    """A cache written by the port's `save_detections` (the one
    `eval_video --dump-dets` calls) loads identically through the port's
    and the JAX tool's `load_detections`, with its frames, gt and floor as
    written; a cache written by the JAX tool's loads identically through
    the port's."""
    jtool = _jax_tool("grid_search_track")
    raw, image_size, ori, gt = _sequences(seed=1)[1]
    assert grid_search_track.save_detections is eval_video.save_detections
    port_path, jax_path = str(tmp_path / "port" / "v.npz"), str(tmp_path / "jax" / "v.npz")
    eval_video.save_detections(port_path, raw, image_size, ori, gt_frames=gt,
                               select_thr=SELECT_THR)
    jtool.save_detections(jax_path, raw, image_size, ori, gt_frames=gt, select_thr=SELECT_THR)
    written = (raw, image_size, ori, gt, SELECT_THR)
    loaded = grid_search_track.load_detections(port_path)
    _same_cache(loaded, written)
    _same_cache(jtool.load_detections(port_path), loaded)
    _same_cache(grid_search_track.load_detections(jax_path), jtool.load_detections(jax_path))
    _same_cache(grid_search_track.load_detections(jax_path), loaded)


# ---- rvos_diag and the ViT template's groups ---------------------------------------

def video_vit_config():
    """The small ViT config with the reid head and the 4-channel template
    branch (128 crops), a 32-token prompt and rvos_temporal_weight 0.3 (the
    chained embedding moves the choice from frame 1 on)."""
    cfg = tiny_vit_config()
    return dataclasses.replace(
        cfg, use_reid=True, rvos_temporal_weight=0.3,
        data=dataclasses.replace(cfg.data, max_text_len=32),
        sot=dataclasses.replace(cfg.sot, template_size=128, extra_backbone_for_template=True,
                                feature_fusion=True))


def _rvos_video(root):
    """One referring mini-YTVIS val video of 3 frames at 64x96: the port's
    records and the JAX package's of the same json."""
    from uninext_tpu.data.video import load_ytvis_json as jax_load
    from uninext_tpu_torch.data.mini_coco import make_mini_ytvis
    from uninext_tpu_torch.data.video import load_ytvis_json
    os.makedirs(root, exist_ok=True)
    paths = make_mini_ytvis(root, n_train=0, n_val=1, size=(H, W), length=3, max_objects=3,
                            seed=37, referring=True)
    recs, _ = load_ytvis_json(paths["val_json"], paths["val_root"], has_expression=True)
    jrecs, _ = jax_load(paths["val_json"], paths["val_root"], has_expression=True)
    return recs, jrecs


@pytest.fixture(scope="module")
def rvos_case(tmp_path_factory, worker_id):
    """The tree (weights by `_random_tree` at 0.05) and the JAX tool's
    `decompose` of the video, made once per session."""
    root = str(tmp_path_factory.mktemp("rvos_video"))

    def make():
        cfg = video_vit_config()
        jm = JaxDETR(cfg)
        tree = _random_tree(jax.eval_shape(lambda r: init_all_paths(jm, r, H=H, W=W),
                                           jax.random.PRNGKey(0)), seed=3, scale=0.05)
        _, jrecs = _rvos_video(os.path.join(root, "jax"))
        with _tools_on_path():
            want = _jax_tool("rvos_diag").decompose(jm, tree["params"], cfg, jrecs, H, W)
        return tree, want

    tree, want = shared_across_workers("video_tools_rvos", make, tmp_path_factory, worker_id)
    return video_vit_config(), tree, want, root


def test_decompose_matches_jax(rvos_case):
    """The port's `decompose` (the R-VOS frame step with the chosen
    embedding chained, then `RVOSDriver` at the original size) against the
    JAX tool's, from the same weights: `n_frames` and the selection
    accuracy equal; the mean selection IoU, the mask Js and
    `RVOSDriver`'s J&F, which both tools round to 4 places, within one step of that
    rounding (1e-4; they came out equal: fp32 on both sides moves no
    boundary pixel of the resized logits here)."""
    cfg, tree, want, root = rvos_case
    recs, _ = _rvos_video(os.path.join(root, "port"))
    model = build_model(cfg, "cpu", seed=0, template=True)
    convert.load_jax_params(model, tree)
    got = rvos_diag.decompose(model, cfg, recs, H, W, device="cpu")
    assert got.keys() == want.keys()
    assert got["n_frames"] == want["n_frames"] == 3
    assert got["selection_acc_iou50"] == want["selection_acc_iou50"]
    assert (got["mask_j_when_selected"] is None) == (want["mask_j_when_selected"] is None)
    for k in ("mean_selection_iou", "mask_j_all_frames", "mask_j_when_selected", "driver_jf"):
        if want[k] is not None:
            assert abs(got[k] - want[k]) <= 1.01e-4, (k, got, want)
    assert got["mean_selection_iou"] > 0 and got["mask_j_all_frames"] > 0


def test_vit_template_optimizer_groups_match_classify_param(rvos_case):
    """The groups of a model with a ViT template branch equal JAX's
    `classify_param` of the leaves each parameter is built from, leaf by
    leaf: a ViT path has no stem, res2 or FrozenBN statistics, so both
    towers are wholly in "backbone" and nothing is frozen; `sot_fuser` and
    `adjust_layer` are in "base"."""
    cfg, tree, _, _ = rvos_case
    model = build_model(cfg, "cpu", seed=1, template=True)
    sources = bridge_sources(tree)
    opt = optim.AdamW(model.named_parameters(), cfg.solver)
    groups = {n: g for g, names in opt.names.items() for n in names}
    assert set(sources) == set(groups)
    seen, by_group = set(), {}
    for key, paths in sources.items():
        for p in paths:
            p_jax = re.sub(r"encoder_layer_\d+/", "encoder_scan/layer/", p)
            assert groups[key] == joptim.classify_param(tuple(p_jax.split("/"))), key
            seen.add(p_jax)
        branch = re.match(r"detr\.(?:detr\.)?(ref_backbone|sot_fuser|adjust_layer)\.", key)
        if branch:
            by_group.setdefault(groups[key], set()).add(branch.group(1))
    assert len(seen) == len(jax.tree_util.tree_leaves(tree))
    assert by_group == {"backbone": {"ref_backbone"}, "base": {"sot_fuser", "adjust_layer"}}
    assert not opt.names.get("frozen")
    tb = "detr.detr.ref_backbone.0.backbone."
    assert groups[tb + "patch_embed.proj.weight"] == "backbone"
    assert groups[tb + "blocks.1.attn.qkv.weight"] == "backbone"
    assert torch.Size(dict(model.named_parameters())[tb + "patch_embed.proj.weight"]
                      .shape)[1] == 4
