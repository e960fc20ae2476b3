"""The port's command line on the CPU: the reference-checkpoint loader
against the JAX package's, the tools against the JAX tools from the same
`.pth`, the other tool paths on the port alone, and `train_net`'s training
against the port's `Trainer`.

The `.pth` is the currency of both command lines: a random JAX tree of
`init_all_paths`'s shapes (`jax.eval_shape` and numpy, no compiled init)
through the weight bridge (`load_jax_params`) into the port, whose
`state_dict()` is saved as `{"model": sd}`, the reference's layout. JAX's
tools read it through `load_torch_checkpoint` (`--init-weights`,
`--weights`), the port's through `load_reference_checkpoint`. The JAX
tools' `init_all_paths` is replaced by zeros of its shapes: the `.pth`
overwrites every leaf, which `test_reference_pth_round_trips` shows.
Three JAX tool runs compile here: `train_net --eval-only`, `eval_video
--task vos` and `--task mots`, each in one test.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import uninext_tpu.models.detr as jdetr
from tests.test_torch_cli_host import _jax_tool
from tests.test_torch_sot import _random_tree
from tests.torch_port_common import bridge_sources, one_torch_thread, shared_across_workers
from uninext_tpu.engine import convert as jconvert
from uninext_tpu_torch import config
from uninext_tpu_torch.data.mini_coco import make_mini_coco, make_mini_ytvis
from uninext_tpu_torch.engine.convert import load_jax_params, load_reference_checkpoint
from uninext_tpu_torch.evaluation.davis_eval import davis_palette
from uninext_tpu_torch.models.detr import build_model

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CONFIGS = {"image": "tiny_test_config", "video": "tiny_video_test_config"}


def _make_pth(kind, path):
    """(the JAX tree, the .pth written to `path`) of `kind`'s config. The video tree's
    last decoder layer scores every query high (class and IoU biases + 4),
    so that MOT keeps detections with random weights."""
    cfg = getattr(config, CONFIGS[kind])()
    shapes = jax.eval_shape(lambda r: jdetr.init_all_paths(jdetr.UninextDETR(cfg), r),
                            jax.random.PRNGKey(0))
    tree = _random_tree(shapes, seed={"image": 11, "video": 12}[kind])
    if kind == "video":
        p = tree["params"]
        p["class_embed_1"]["bias0"] = p["class_embed_1"]["bias0"] + 4
        p["iou_head_1"]["bias"] = p["iou_head_1"]["bias"] + 4
    model = build_model(cfg, "cpu", seed=0, template=True)
    load_jax_params(model, tree)
    torch.save({"model": model.state_dict(), "iteration": 7}, path)
    return tree, str(path)


def _shared_pth(kind, tmp_path_factory, worker_id):
    """(the JAX tree, its zeros, the .pth path) of `kind`, made once for
    the session: the pytest-xdist workers share the first one's files."""
    tree, path = shared_across_workers(
        f"cli_{kind}", lambda: _make_pth(kind, tmp_path_factory.mktemp("pth") / f"{kind}.pth"),
        tmp_path_factory, worker_id)
    return tree, jax.tree.map(np.zeros_like, tree), path


@pytest.fixture(scope="module")
def image_pth(tmp_path_factory, worker_id):
    return _shared_pth("image", tmp_path_factory, worker_id)


@pytest.fixture(scope="module")
def video_pth(tmp_path_factory, worker_id):
    return _shared_pth("video", tmp_path_factory, worker_id)


@pytest.fixture
def hash_vocab(monkeypatch):
    monkeypatch.setenv("UNINEXT_ALLOW_HASH_VOCAB", "1")
    monkeypatch.delenv("UNINEXT_BERT_VOCAB", raising=False)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---- the reference-checkpoint loader ---------------------------------------------

def test_reference_pth_round_trips(image_pth, hash_vocab):
    """JAX's `load_torch_checkpoint` of the port's file onto zeros gives
    every JAX leaf exactly; the port's loader into a model of another seed
    gives a bit-equal state dict with nothing missing, mismatched or
    unused (`iteration` beside `model` is the reference's layout)."""
    tree, zeros, path = image_pth
    got = _leaves(jconvert.load_torch_checkpoint(path, zeros))
    want = _leaves(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = build_model(config.tiny_test_config(), "cpu", seed=5, template=True)
    rep = load_reference_checkpoint(model, path)
    sd = torch.load(path, weights_only=True)["model"]
    assert rep == {"loaded": len(sd), "missing": [], "shape_mismatch": [], "unused_source": []}
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_reference_loader_reports_what_jax_reports(image_pth, hash_vocab, tmp_path):
    """One tensor dropped, one renamed and one extra: the same unused names
    on both sides, and the port's missing names are JAX's unfilled leaves
    carried through the bridge (each of the two maps to one leaf here; the
    counts of all others relate by `bridge_sources`). A shape mismatch is
    skipped and reported on both sides."""
    tree, zeros, path = image_pth
    sd = dict(torch.load(path, weights_only=True)["model"])
    drop = "detr.detr.class_embed.0.bias0"
    rename = "text_encoder.body.model.encoder.layer.1.output.dense.bias"
    bad = "detr.detr.bbox_embed.0.layers.2.bias"
    sd.pop(drop)
    sd[rename.replace("layer.1", "layer.7")] = sd.pop(rename)
    sd["detr.detr.extra_head.weight"] = torch.ones(3)
    sd["detr.detr.backbone.0.backbone.stem.conv1.norm.num_batches_tracked"] = torch.tensor(1)
    sd[bad] = torch.zeros(5)
    torch.save(sd, tmp_path / "edited.pth")
    nan = jax.tree.map(lambda z: np.full(z.shape, np.nan, np.float32), zeros)
    jtree, jrep = jconvert.convert_checkpoint(sd, nan)
    model = build_model(config.tiny_test_config(), "cpu", seed=5, template=True)
    rep = load_reference_checkpoint(model, str(tmp_path / "edited.pth"))
    assert rep["unused_source"] == jrep["unused_source"] == sorted(
        [rename.replace("layer.1", "layer.7"), "detr.detr.extra_head.weight"])
    unfilled = sorted(k for k, v in _leaves(jtree).items() if np.isnan(v).any())
    sources = bridge_sources(tree)
    leaf = lambda p: "['params']" + "".join(f"['{s}']" for s in p.split("/"))
    assert unfilled == sorted(leaf(p) for k in rep["missing"] + [bad] for p in sources[k])
    assert rep["missing"] == sorted([drop, rename])
    assert [m[0] for m in rep["shape_mismatch"]] == [bad]
    assert [m[0] for m in jrep["shape_mismatch"]] == ["bbox_embed_0/layer_2/bias"]
    assert rep["loaded"] == len(model.state_dict()) - 3


def test_both_loaders_refuse_a_bert_table_under_the_hash_vocab(image_pth, monkeypatch):
    tree, zeros, path = image_pth
    monkeypatch.delenv("UNINEXT_ALLOW_HASH_VOCAB", raising=False)
    monkeypatch.delenv("UNINEXT_BERT_VOCAB", raising=False)
    with pytest.raises(RuntimeError, match="hash-vocab fallback") as jerr:
        jconvert.load_torch_checkpoint(path, zeros)
    model = build_model(config.tiny_test_config(), "cpu", seed=5)
    with pytest.raises(RuntimeError, match="hash-vocab fallback") as err:
        load_reference_checkpoint(model, path)
    assert str(err.value) == str(jerr.value)


def test_resume_or_load_takes_a_reference_pth_and_its_own_checkpoints(tmp_path,
                                                                      monkeypatch):
    """`CheckpointManager.resume_or_load` with nothing to resume: a file of
    a `CheckpointManager` loads strictly, with no vocab guard (its BERT
    table was trained under the hash vocab); a reference `.pth` goes
    through the loader, its guard included."""
    from uninext_tpu_torch.engine.checkpoint import CheckpointManager
    from uninext_tpu_torch.engine.train import build_train_state
    monkeypatch.delenv("UNINEXT_ALLOW_HASH_VOCAB", raising=False)
    monkeypatch.delenv("UNINEXT_BERT_VOCAB", raising=False)
    cfg = config.tiny_test_config()
    own = CheckpointManager(str(tmp_path / "own"))
    own.save(3, build_train_state(cfg, "cpu", seed=3))
    want = torch.load(own.path(3), weights_only=True)["model"]
    state = build_train_state(cfg, "cpu", seed=4)
    state, resumed = CheckpointManager(str(tmp_path / "new")).resume_or_load(state,
                                                                             own.path(3))
    assert not resumed and state.step == 0 and state.optimizer.count == 0
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())
    torch.save({"model": want, "iteration": 9}, tmp_path / "ref.pth")
    with pytest.raises(RuntimeError, match="hash-vocab fallback"):
        CheckpointManager(str(tmp_path / "new")).resume_or_load(state, str(tmp_path / "ref.pth"))
    monkeypatch.setenv("UNINEXT_ALLOW_HASH_VOCAB", "1")
    other = build_train_state(cfg, "cpu", seed=5)
    CheckpointManager(str(tmp_path / "new")).resume_or_load(other, str(tmp_path / "ref.pth"))
    assert all(torch.equal(v, want[k]) for k, v in other.model.state_dict().items())


def test_inflate4c_writes_what_jax_writes(tmp_path, monkeypatch):
    from uninext_tpu_torch.tools import convert_datasets
    key = "detr.detr.backbone.0.backbone.stem.conv1.weight"
    g = torch.Generator().manual_seed(0)
    torch.save({"model": {key: torch.randn(8, 3, 7, 7, generator=g),
                          "other": torch.randn(4, generator=g)}, "iteration": 3},
               tmp_path / "in.pth")
    convert_datasets.main(["inflate4c", "--input", str(tmp_path / "in.pth"),
                           "--output", str(tmp_path / "port.pth")])
    monkeypatch.setattr(sys, "argv", ["convert_datasets.py", "inflate4c", "--input",
                                      str(tmp_path / "in.pth"), "--output",
                                      str(tmp_path / "jax.pth")])
    _jax_tool("convert_datasets").main()
    got, want = (torch.load(tmp_path / f, weights_only=True) for f in ("port.pth", "jax.pth"))
    assert got["iteration"] == want["iteration"] == 3 and set(got["model"]) == set(want["model"])
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    assert got["model"][key].shape == (8, 4, 7, 7) and not got["model"][key][:, 3].any()


# ---- the tools against JAX's, from the same .pth ----------------------------------

def _run_jax_tool(name, argv, zeros, monkeypatch):
    """A JAX tool's main under `argv`, its `init_all_paths` returning zeros;
    returns what it printed."""
    monkeypatch.setattr(jdetr, "init_all_paths", lambda *a, **k: {"params": zeros["params"]})
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax_tool(name).main()
    return out.getvalue()


def _run_port_tool(name, argv):
    import importlib
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"uninext_tpu_torch.tools.{name}").main(argv)
    return out.getvalue()


def _last_json(text):
    """The JSON object printed last (indented, from its first line "{")."""
    lines = text.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def _pixels_differ(a_path, b_path):
    a, b = np.asarray(Image.open(a_path)), np.asarray(Image.open(b_path))
    assert a.shape == b.shape and Image.open(a_path).mode == Image.open(b_path).mode
    return float((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).mean())


def test_train_net_eval_only_matches_jax(image_pth, hash_vocab, tmp_path, monkeypatch):
    """`train_net --eval-only` on mini-COCO's val images at a 160 test size:
    the AP dicts within 1e-6 (as `tests/test_torch_engine.py` holds the
    evaluators)."""
    tree, zeros, path = image_pth
    paths = make_mini_coco(str(tmp_path / "mc"), n_train=1, seed=3)
    argv = ["--config", "tiny_test_config", "--eval-only", "--coco-json", paths["val_json"],
            "--image-root", paths["val_root"], "--init-weights", path,
            "--output-dir", str(tmp_path / "out"),
            "data.min_size_test=160", "data.max_size_test=208"]
    want = _last_json(_run_jax_tool("train_net", argv, zeros, monkeypatch))
    text = _run_port_tool("train_net", argv + ["--device", "cpu"])
    got = _last_json(text)
    assert "[convert] loaded" in text and set(got) == set(want) >= {"AP", "AP50", "AP75"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)


def _davis_layout(root):
    vdir = root / "JPEGImages" / "480p" / "toyvid"
    adir = root / "Annotations" / "480p" / "toyvid"
    vdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for fi in range(3):
        arr = (rng.rand(72, 104, 3) * 255).astype(np.uint8)
        arr[10:34, 12:42] = (200, 30, 30)
        arr[40:60, 50 + 3 * fi:80 + 3 * fi] = (30, 200, 60)
        Image.fromarray(arr).save(vdir / f"{fi:05d}.jpg")
    for fi in range(3):                 # the second object from frame 1
        ann = np.zeros((72, 104), np.uint8)
        ann[10:34, 12:42] = 1
        if fi:
            ann[40:60, 50 + 3 * fi:80 + 3 * fi] = 2
        img = Image.fromarray(ann, mode="P")
        img.putpalette(davis_palette().ravel().tolist())
        img.save(adir / f"{fi:05d}.png")


def test_eval_video_vos_matches_jax(image_pth, hash_vocab, tmp_path, monkeypatch):
    """`eval_video --task vos` on a DAVIS layout (the second object from
    frame 1): J&F within 1e-3 and each palette PNG equal but for at most
    0.1% of its pixels (threshold ties)."""
    tree, zeros, path = image_pth
    _davis_layout(tmp_path / "DAVIS")
    argv = lambda out: ["--task", "vos", "--data-root", str(tmp_path / "DAVIS"),
                        "--config", "tiny_test_config", "--bucket", "96", "128",
                        "--weights", path, "--output-dir", str(tmp_path / out)]
    want = _last_json(_run_jax_tool("eval_video", argv("jax"), zeros, monkeypatch))
    got = _last_json(_run_port_tool("eval_video", argv("port") + ["--device", "cpu"]))
    assert np.isfinite(want["J&F"]) and abs(got["J&F"] - want["J&F"]) <= 1e-3
    pngs = sorted(os.listdir(tmp_path / "jax" / "toyvid"))
    assert pngs == sorted(os.listdir(tmp_path / "port" / "toyvid")) and len(pngs) == 3
    for f in pngs:
        assert _pixels_differ(tmp_path / "jax" / "toyvid" / f,
                              tmp_path / "port" / "toyvid" / f) <= 1e-3, f


def test_eval_video_mots_matches_jax(video_pth, hash_vocab, tmp_path, monkeypatch):
    """`eval_video --task mots` on BDD-style frame directories: the same
    track ids and categories per frame in box_track.json, boxes within 1e-3
    px, the RGBA seg_track PNGs equal but for at most 0.1% of pixels."""
    tree, zeros, path = video_pth
    for v in range(2):
        vdir = tmp_path / "frames" / f"vid{v}"
        vdir.mkdir(parents=True)
        rng = np.random.RandomState(5 + v)
        for fi in range(3):
            arr = (rng.rand(72, 104, 3) * 255).astype(np.uint8)
            arr[20 + fi:44 + fi, 12:42] = (30, 160, 220)
            Image.fromarray(arr).save(vdir / f"{fi:05d}.jpg")
    argv = lambda out: ["--task", "mots", "--data-root", str(tmp_path / "frames"),
                        "--config", "tiny_video_test_config", "--bucket", "96", "128",
                        "--weights", path, "--output-dir", str(tmp_path / out)]
    _run_jax_tool("eval_video", argv("jax"), zeros, monkeypatch)
    _run_port_tool("eval_video", argv("port") + ["--device", "cpu"])
    want, got = (json.load(open(tmp_path / d / "box_track.json")) for d in ("jax", "port"))
    assert len(got) == len(want) == 6
    n = 0
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("name", "videoName", "frameIndex")} == \
            {k: w[k] for k in ("name", "videoName", "frameIndex")}
        assert [(lb["id"], lb["category"]) for lb in g["labels"]] == \
            [(lb["id"], lb["category"]) for lb in w["labels"]]
        for a, b in zip(g["labels"], w["labels"]):
            np.testing.assert_allclose([a["box2d"][k] for k in ("x1", "y1", "x2", "y2")],
                                       [b["box2d"][k] for k in ("x1", "y1", "x2", "y2")],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=1e-5)
        n += len(g["labels"])
    assert n > 0, "no tracked detection to compare"
    for v in range(2):
        seg = f"seg_track/vid{v}"
        pngs = sorted(os.listdir(tmp_path / "jax" / seg))
        assert pngs == sorted(os.listdir(tmp_path / "port" / seg)) and len(pngs) == 3
        for f in pngs:
            assert _pixels_differ(tmp_path / "jax" / seg / f, tmp_path / "port" / seg / f) <= 1e-3


# ---- the other tool paths, on the port alone ----------------------------------------

@pytest.fixture
def small_test_size(monkeypatch):
    """`tiny_test_config` and `tiny_video_test_config` at a 96 test size,
    as the tools see them by name."""
    for name in CONFIGS.values():
        base = getattr(config, name)
        monkeypatch.setattr(config, name, lambda base=base: dataclasses.replace(
            base(), data=dataclasses.replace(base().data, min_size_test=96,
                                             max_size_test=128)))


def _frames_dir(root, n=3, hw=(72, 104)):
    rng = np.random.RandomState(3)
    root.mkdir(parents=True)
    for i in range(n):
        arr = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        arr[20:44, 30 + 4 * i:60 + 4 * i] = (220, 40, 40)
        Image.fromarray(arr).save(root / f"{i:08d}.jpg")
    return root


def test_demo_image_frames_and_sot(small_test_size, tmp_path):
    from uninext_tpu_torch.tools import demo
    fdir = _frames_dir(tmp_path / "frames")
    img = str(fdir / "00000000.jpg")
    for extra, out in (([], "det.png"), (["--prompt", "the red thing"], "g.png")):
        demo.main(["--image", img, "--config", "tiny_test_config", "--output",
                   str(tmp_path / out), "--score-thr", "0.0", "--device", "cpu"] + extra)
        assert Image.open(tmp_path / out).size == (128, 89)
    demo.main(["--frames", str(fdir), "--config", "tiny_test_config", "--output",
               str(tmp_path / "fr"), "--score-thr", "0.0", "--device", "cpu"])
    demo.main(["--frames", str(fdir), "--config", "tiny_test_config", "--init-box", "30",
               "20", "60", "44", "--output", str(tmp_path / "sot"), "--device", "cpu"])
    assert len(os.listdir(tmp_path / "fr")) == len(os.listdir(tmp_path / "sot")) == 3


def _lasot_layout(root):
    seq = root / "toy" / "toy-1"
    _frames_dir(seq / "img")
    (seq / "groundtruth.txt").write_text("\n".join(f"{30 + 4 * i},20,30,24"
                                                   for i in range(3)) + "\n")
    (seq / "full_occlusion.txt").write_text("0,0,0\n")
    (seq / "out_of_view.txt").write_text("0,0,0\n")


def test_eval_video_vis_sot_and_rvos(tmp_path):
    """vis on a mini-YTVIS (results.json and the server zip, the local
    mAP), sot on a LaSOT layout (`<vid>.txt`, `<vid>_time.txt`, AUC/P/Pnorm;
    a second run resumes from the files) and rvos on a referring
    mini-YTVIS (Annotations/<vid>/<exp>/*.png palette PNGs, the mean J&F)."""
    import zipfile
    bucket = ["--bucket", "96", "128", "--device", "cpu"]
    yv = make_mini_ytvis(str(tmp_path / "yv"), n_train=1, n_val=2, seed=9, size=(96, 128),
                         length=3)
    text = _run_port_tool("eval_video", [
        "--task", "vis", "--data-root", os.path.dirname(yv["val_root"]), "--json",
        yv["val_json"], "--config", "tiny_video_test_config", "--output-dir",
        str(tmp_path / "vis")] + bucket)
    assert {"vis_AP", "vis_AP50"} <= set(_last_json(text))
    with zipfile.ZipFile(tmp_path / "vis" / "submission.zip") as z:
        assert z.namelist() == ["results.json"]
        assert json.loads(z.read("results.json")) == json.load(
            open(tmp_path / "vis" / "results.json"))
    _lasot_layout(tmp_path / "lasot")
    sot = ["--task", "sot", "--data-root", str(tmp_path / "lasot"), "--config",
           "tiny_video_test_config", "--output-dir", str(tmp_path / "sot")] + bucket
    first = _last_json(_run_port_tool("eval_video", sot))
    assert set(first) == {"AUC", "P", "Pnorm"} and np.isfinite(list(first.values())).all()
    boxes = np.loadtxt(tmp_path / "sot" / "toy-1.txt", delimiter=",")
    assert boxes.shape == (3, 4) and len(np.loadtxt(tmp_path / "sot" / "toy-1_time.txt")) == 3
    again = _run_port_tool("eval_video", sot)        # from the files' 2-decimal boxes
    assert "resuming from" in again
    for k, v in _last_json(again).items():
        assert abs(v - first[k]) < 0.02, k
    rv = make_mini_ytvis(str(tmp_path / "rv"), n_train=1, n_val=1, referring=True,
                         max_objects=2, seed=9, size=(96, 128), length=3)
    text = _run_port_tool("eval_video", [
        "--task", "rvos", "--data-root", rv["val_root"], "--json", rv["val_json"],
        "--config", "tiny_test_config", "--rvos-temporal-weight", "0.3", "--output-dir",
        str(tmp_path / "rvos")] + bucket)
    assert re.search(r"mean J&F over 1 \(video, expr\): [0-9.]+", text)
    (vid,) = os.listdir(tmp_path / "rvos" / "Annotations")
    pngs = os.listdir(tmp_path / "rvos" / "Annotations" / vid / "0")
    assert len(pngs) == 3 and Image.open(tmp_path / "rvos" / "Annotations" / vid / "0" /
                                         pngs[0]).mode == "P"


def test_vot_adapter_protocol(small_test_size):
    from uninext_tpu_torch.tools.vot_integration import UninextVOTTracker
    rng = np.random.RandomState(1)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8) for _ in range(3)]
    tr = UninextVOTTracker(config_name="tiny_test_config", device="cpu")
    tr.initialize(frames[0], [30.0, 20.0, 40.0, 30.0])
    for f in frames[1:]:
        box, conf = tr.track(f)
        assert len(box) == 4 and np.isfinite(box).all()
        assert box[2] > 0 and box[3] > 0 and 0.0 <= conf <= 1.0


def test_eval_seginw_make_mini(tmp_path, monkeypatch):
    from uninext_tpu_torch.tools import eval_seginw
    monkeypatch.setattr(eval_seginw.tempfile, "mkdtemp",
                        lambda prefix: str(tmp_path / prefix.rstrip("_")))
    monkeypatch.setenv("UNINEXT_DATA", str(tmp_path / "unused"))
    eval_seginw.main(["--make-mini", "--steps", "0", "--config", "tiny", "--device", "cpu",
                      "--out", str(tmp_path / "seginw.json")])
    res = json.load(open(tmp_path / "seginw.json"))
    assert res["n_datasets"] == 2 and res["skipped"] == [] and res["zero_shot"]
    for sub in ("Chicken", "Cows"):
        d = res["per_dataset"][sub]
        assert d["n_images"] == 6 and d["n_categories"] == 3
        assert set(d["bbox"]) >= {"AP", "AP50"} and set(d["segm"]) >= {"AP", "AP50"}


@pytest.mark.parametrize("tool", ["train_net", "eval_video", "demo", "eval_seginw"])
def test_tools_refuse_to_run_without_a_card(tool, tmp_path):
    """Without `--device cpu` a tool wants the card, and there is none here."""
    import importlib
    argv = {"train_net": ["--coco-json", "x.json"], "demo": ["--image", "x.jpg"],
            "eval_video": ["--task", "vos", "--data-root", str(tmp_path)],
            "eval_seginw": ["--out", str(tmp_path / "x.json")]}[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        importlib.import_module(f"uninext_tpu_torch.tools.{tool}").main(argv)


# ---- train_net's training ----------------------------------------------------------

def test_train_net_trains_as_the_trainer(tmp_path, hash_vocab):
    """Two steps of `tiny_test_config` through `train_net` (images at most
    128 wide, `--init-weights` a saved model of seed 3) end in the
    checkpoint of two steps of the port's `Trainer` on the same loader from
    the same weights: model, Adam moments, step and generator bit-equal."""
    from uninext_tpu_torch.data.coco import UniDatasetMapper, load_coco_json
    from uninext_tpu_torch.data.loader import MultiDatasetLoader, prefetch
    from uninext_tpu_torch.engine.checkpoint import CheckpointManager
    from uninext_tpu_torch.engine.trainer import Trainer
    from uninext_tpu_torch.tools import train_net
    paths = make_mini_coco(str(tmp_path / "mc"), n_train=4, n_val=1, seed=3,
                           img_size=(72, 104))
    init = build_model(config.tiny_test_config(), "cpu", seed=3)
    torch.save({"model": init.state_dict()}, tmp_path / "init.pth")
    opts = ["solver.max_iter=2", "data.max_size_train=128"]
    train_net.main(["--config", "tiny_test_config", "--coco-json", paths["train_json"],
                    "--image-root", paths["train_root"], "--output-dir", str(tmp_path / "cli"),
                    "--init-weights", str(tmp_path / "init.pth"), "--device", "cpu"] + opts)
    cfg = train_net.apply_overrides(config.tiny_test_config(), opts)
    recs, cats = load_coco_json(paths["train_json"], paths["train_root"])
    loader = prefetch(iter(MultiDatasetLoader(
        [(recs, UniDatasetMapper(cfg.data, cats, is_train=True), 2)], ratios=[1.0])))
    trainer = Trainer(cfg, loader, output_dir=str(tmp_path / "direct"), device="cpu")
    trainer.state.model.load_state_dict(init.state_dict())
    trainer.train()
    got, want = (CheckpointManager(str(tmp_path / d / "checkpoints")) for d in ("cli", "direct"))
    assert got.all_steps() == want.all_steps() == [2]
    a, b = (torch.load(m.path(2), weights_only=True) for m in (got, want))
    assert a["step"] == b["step"] == 2 and torch.equal(a["generator"], b["generator"])
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    assert not torch.equal(b["model"]["detr.detr.class_embed.0.bias0"],
                           init.state_dict()["detr.detr.class_embed.0.bias0"])
    for m in ("mu", "nu"):
        for g, ts in b["optimizer"][m].items():
            assert all(torch.equal(x, y) for x, y in zip(a["optimizer"][m][g], ts)), (m, g)
