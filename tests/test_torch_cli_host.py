"""The host modules under the port's command line against the JAX
package's, on the same generated layouts: the dataset registry and its
training recipes (`build_recipe`, `recipe_record_weights` on a generated
`$UNINEXT_DATA`), the GOT-10k / LaSOT / TrackingNet / BDD100K loaders, the
GOT-10k / TrackingNet and BDD100K / YTVIS submission writers (the same
files; zips by member contents), `make_mini_seginw` (the same bytes),
`analyze_sot_results` (the same printout) and the dataset converters
(`refer2json`, `ytbvos2json`, `coco2video`: the same JSON). Everything is
compared exactly; nothing here compiles JAX.
"""
import json
import os
import pickle
import shutil
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_data import _same_tree
from uninext_tpu import config as jconfig
from uninext_tpu.data import mini_coco as jmini
from uninext_tpu.data import registry as jregistry
from uninext_tpu.data import sot_datasets as jsot
from uninext_tpu.evaluation import bdd_submit as jbdd
from uninext_tpu.evaluation import sot_submit as jsubmit
from uninext_tpu_torch import config
from uninext_tpu_torch.data import mini_coco, registry, sot_datasets
from uninext_tpu_torch.evaluation import bdd_submit, sot_submit

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _same(a, b, where="record"):
    """Nested dicts, lists and arrays equal, arrays by value and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), where


def _jpeg(path, seed, hw=(24, 32)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(path)


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _jax_tool(name):
    """A JAX tool module of tools/ by its file name."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import importlib
    return importlib.import_module(name)


# ---- the registry and the recipes ---------------------------------------------------

def test_registry_lists_and_recipes_equal_jax():
    assert registry.list_datasets() == jregistry.list_datasets()
    assert registry._SEGINW_SUBSETS == jregistry._SEGINW_SUBSETS
    assert registry.video_joint_recipe() == jregistry.video_joint_recipe()
    assert set(registry.TRAIN_RECIPES) == set(jregistry.TRAIN_RECIPES)
    for name, (base, fn, sched, src) in registry.TRAIN_RECIPES.items():
        jbase, jfn, jsched, jsrc = jregistry.TRAIN_RECIPES[name]
        assert (base, sched, src) == (jbase, jsched, jsrc), name
        assert fn() == jfn(), name
        assert hasattr(config, base), base


def _recipe_layout(root):
    """COCO train2017 and Objects365v2 in the reference's datasets/ layout
    from one mini-COCO."""
    paths = mini_coco.make_mini_coco(str(root / "src"), n_train=5, n_val=1, seed=0,
                                     img_size=(48, 64))
    for img_dir, ann in (("coco/train2017", "coco/annotations/instances_train2017.json"),
                         ("Objects365V2/images", "Objects365V2/annotations/"
                          "zhiyuan_objv2_train_fixname_fixmiss.json")):
        shutil.copytree(paths["train_root"], root / "datasets" / img_dir)
        os.makedirs(os.path.dirname(root / "datasets" / ann), exist_ok=True)
        shutil.copy(paths["train_json"], root / "datasets" / ann)
    return root / "datasets"


@pytest.mark.parametrize("name", ["single_task_det", "obj365_pretrain"])
def test_build_recipe_and_record_weights_equal_jax(tmp_path, monkeypatch, name):
    """The same records, batch sizes, tasks, mapper settings, ratios and
    schedule; for the obj365 stage BoxInst's mapper and the class-aware
    weights."""
    monkeypatch.setenv("UNINEXT_DATA", str(_recipe_layout(tmp_path)))
    jcfg, jds, jratios, jvideo = jregistry.build_recipe(name, jconfig.tiny_test_config())
    cfg, ds, ratios, video = registry.build_recipe(name, config.tiny_test_config())
    assert (ratios, video) == (jratios, jvideo)
    assert cfg.solver.steps == jcfg.solver.steps and cfg.solver.max_iter == jcfg.solver.max_iter
    assert cfg.loss.boxinst == jcfg.loss.boxinst == (name == "obj365_pretrain")
    assert len(ds) == len(jds) == 1
    (recs, mapper, bs, task), (jrecs, jmapper, jbs, jtask) = ds[0], jds[0]
    _same(recs, jrecs)
    assert (bs, task) == (jbs, jtask) and len(recs) == 5
    for attr in ("categories", "is_train", "with_masks", "boxinst", "boxinst_bottom_pixels"):
        assert getattr(mapper, attr) == getattr(jmapper, attr), attr
    assert (mapper.cfg.min_size_train, mapper.cfg.max_size_train) == \
        (jmapper.cfg.min_size_train, jmapper.cfg.max_size_train)
    w, jw = (registry.recipe_record_weights(name, ds),
             jregistry.recipe_record_weights(name, jds))
    if name == "obj365_pretrain":
        assert len(w) == len(jw) == 1
        np.testing.assert_array_equal(w[0], jw[0])
    else:
        assert w is None and jw is None


# ---- the SOT and BDD loaders -------------------------------------------------------

def _sot_layouts(root):
    rng = np.random.RandomState(2)
    boxes = lambda n: "\n".join(",".join(f"{v:.2f}" for v in rng.uniform(1, 20, 4))
                                for _ in range(n)) + "\n"
    for i in range(2):                       # GOT-10k, one sequence without gt
        seq = root / "got" / "val" / f"GOT-10k_Val_00000{i + 1}"
        for f in range(3):
            _jpeg(str(seq / f"{f + 1:08d}.jpg"), f)
        if i == 0:
            (seq / "groundtruth.txt").write_text(boxes(3))
    for cls in ("cat", "dog"):               # LaSOT, one sequence without flags
        for j in (1, 2):
            seq = root / "lasot" / cls / f"{cls}-{j}"
            for f in range(2):
                _jpeg(str(seq / "img" / f"{f + 1:08d}.jpg"), f)
            (seq / "groundtruth.txt").write_text(boxes(2))
            if (cls, j) != ("dog", 2):
                (seq / "full_occlusion.txt").write_text("0,1\n")
                (seq / "out_of_view.txt").write_text("0,0\n")
    for name in ("b", "a"):                  # TrackingNet, frames sorted numerically
        (root / "tn" / "TEST" / "anno").mkdir(parents=True, exist_ok=True)
        (root / "tn" / "TEST" / "anno" / f"{name}.txt").write_text(boxes(11))
        for f in range(11):
            _jpeg(str(root / "tn" / "TEST" / "frames" / name / f"{f}.jpg"), f)
    frames = [{"videoName": v, "name": f"{v}-{k}.jpg", "frameIndex": k,
               "labels": [{"id": str(t), "category": "car",
                           "box2d": {"x1": 1.0 + t, "y1": 2.0, "x2": 9.0 + k, "y2": 7.0}}
                          for t in range(k + 1)] + ([{"id": "9", "category": "rider",
                                                      "rle": {"size": [4, 4],
                                                              "counts": "a"}}]
                                                    if k == 1 else [])}
              for v in ("v1", "v0") for k in (2, 0, 1)]
    (root / "bdd.json").write_text(json.dumps(frames))


def test_sot_and_bdd_loaders_equal_jax(tmp_path):
    _sot_layouts(tmp_path)
    r = str(tmp_path)
    pairs = [(sot_datasets.load_got10k(r + "/got"), jsot.load_got10k(r + "/got")),
             (sot_datasets.load_lasot(r + "/lasot"), jsot.load_lasot(r + "/lasot")),
             (sot_datasets.load_trackingnet(r + "/tn"), jsot.load_trackingnet(r + "/tn")),
             (sot_datasets.load_bdd100k_track(r + "/bdd.json", r + "/img"),
              jsot.load_bdd100k_track(r + "/bdd.json", r + "/img"))]
    for got, want in pairs:
        _same(got, want)
    assert [len(g) for g, _ in pairs] == [1, 4, 2, 2]
    assert pairs[1][0][3]["visible"] is None and pairs[1][0][0]["visible"].tolist() == [True, False]


# ---- the submission writers ---------------------------------------------------------

def _sot_results(src):
    os.makedirs(src)
    rng = np.random.RandomState(4)
    for name in ("seq1", "seq2", "all_seqs"):
        np.savetxt(os.path.join(src, f"{name}.txt"), rng.uniform(0, 99, (3, 4)),
                   fmt="%.2f", delimiter=",")
        np.savetxt(os.path.join(src, f"{name}_time.txt"), rng.rand(3), fmt="%.6f")


@pytest.mark.parametrize("server", ["got10k", "trackingnet"])
def test_sot_submissions_equal_jax(tmp_path, server):
    src = str(tmp_path / "results")
    _sot_results(src)
    fn = f"package_{server}_submission"
    zp = getattr(sot_submit, fn)(src, str(tmp_path / "port"), keep_dir=True)
    jzp = getattr(jsubmit, fn)(src, str(tmp_path / "jax"), keep_dir=True)
    members = _zip_members(zp)
    assert members == _zip_members(jzp) and len(members) == (4 if server == "got10k" else 2)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        getattr(sot_submit, fn)(str(tmp_path / "empty"))


def _tracked_frames(seed, H=20, W=30, n=3):
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        dets = []
        for tid in rng.permutation(300)[:4]:
            x0, y0 = rng.uniform(0, W / 2), rng.uniform(0, H / 2)
            dets.append({"id": int(tid), "category": int(rng.randint(10)),
                         "score": float(rng.rand()),
                         "box_xyxy": np.array([x0, y0, x0 + 5.5, y0 + 4.25]),
                         "mask": rng.rand(H, W) > 0.6})
        frames.append(dets)
    return frames


def test_bdd_and_ytvis_writers_equal_jax(tmp_path):
    frames = _tracked_frames(5)
    names = [f"f{i}.jpg" for i in range(3)]
    assert bdd_submit.box_track_to_bdd(frames, names, "v") == \
        jbdd.box_track_to_bdd(frames, names, "v")
    assert bdd_submit.det_to_bdd(frames, names) == jbdd.det_to_bdd(frames, names)
    out = {}
    for tag, mod in (("port", bdd_submit), ("jax", jbdd)):
        d = tmp_path / tag
        paths = mod.seg_track_to_bdd(frames, [f"v/{n}" for n in names], str(d / "seg"), (20, 30))
        ins = mod.ins_seg_to_bdd(frames, names, str(d / "ins"), (20, 30))
        mod.save_bdd_json(mod.box_track_to_bdd(frames, names, "v"), str(d / "box_track.json"))
        mod.package_ytvis_submission([{"video_id": 1, "score": 0.5}], str(d / "sub.zip"))
        out[tag] = (paths, ins, _zip_members(d / "sub.zip"))
    assert [os.path.relpath(p, tmp_path / "port") for p in out["port"][0]] == \
        [os.path.relpath(p, tmp_path / "jax") for p in out["jax"][0]]
    assert out["port"][1:] == out["jax"][1:]
    assert len(_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 3 + 3 + 2
    bitmask = np.asarray(Image.open(out["port"][0][0]))
    _same(bdd_submit.decode_bitmask(bitmask), jbdd.decode_bitmask(bitmask))
    assert bdd_submit.box2d([1.0, 2.0, 5.0, 6.0]) == {"x1": 1.0, "y1": 2.0, "x2": 4.0, "y2": 5.0}


# ---- the SegInW fixture, the SOT analysis and the converters -----------------------

def test_make_mini_seginw_writes_the_same_files(tmp_path):
    root = mini_coco.make_mini_seginw(str(tmp_path / "port"), n_val=2, seed=4)
    jroot = jmini.make_mini_seginw(str(tmp_path / "jax"), n_val=2, seed=4)
    names = _same_tree(jroot, root)
    assert len(names) == len(_same_tree(root, jroot)) == 2 * (2 + 1)
    assert "seginw_Cows_val" in registry.list_datasets()


def test_analyze_sot_results_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    from uninext_tpu_torch.tools import analyze_sot_results
    seq = tmp_path / "data" / "toy" / "toy-1"
    (seq / "img").mkdir(parents=True)
    (seq / "groundtruth.txt").write_text("\n".join(f"{20 + 2 * i},24,30,28"
                                                   for i in range(4)) + "\n")
    (seq / "full_occlusion.txt").write_text("0,0,1,0\n")
    (seq / "out_of_view.txt").write_text("0,0,0,0\n")
    pred = np.array([[20 + 3 * i, 25, 29, 28] for i in range(4)], float)
    for name, shift in (("good", 0), ("bad", 40)):
        (tmp_path / name).mkdir()
        np.savetxt(tmp_path / name / "toy-1.txt", pred + shift, fmt="%.2f", delimiter=",")
        np.savetxt(tmp_path / name / "toy-1_time.txt", np.full(4, 0.02 + shift / 1e3),
                   fmt="%.6f")
    (tmp_path / "none").mkdir()
    argv = ["--results", str(tmp_path / "good"), str(tmp_path / "bad"), str(tmp_path / "none"),
            "--data-root", str(tmp_path / "data")]
    analyze_sot_results.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["analyze_sot_results.py"] + argv)
    _jax_tool("analyze_sot_results").main()
    assert got == capsys.readouterr().out and len(got.splitlines()) == 4


def _converter_inputs(root):
    rng = np.random.RandomState(6)
    images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": 40, "width": 50}
              for i in range(3)]
    images[2]["expressions"] = ["the left one"]
    anns = [{"id": 10 + k, "image_id": 1 + k % 3, "category_id": 3 + k % 2,
             "bbox": [float(v) for v in rng.uniform(0, 20, 4)], "area": 12.5,
             **({"segmentation": [[1, 1, 5, 1, 5, 5]]} if k % 2 else {}),
             **({"iscrowd": 1} if k == 4 else {})} for k in range(6)]
    inst = {"images": images, "annotations": anns,
            "categories": [{"id": 3, "name": "a"}, {"id": 4, "name": "b"}]}
    (root / "instances.json").write_text(json.dumps(inst))
    refs = [{"ann_id": 10 + k, "image_id": 1 + k % 3, "split": ("train", "val")[k % 2],
             "sentences": [{"sent": f"thing {k}"}, {"raw": "Raw one", "sent": "raw one"}]}
            for k in range(6)] + [{"ann_id": 99, "image_id": 1, "split": "train",
                                   "sentences": []}]
    with open(root / "refs.p", "wb") as f:
        pickle.dump(refs, f)
    vos = root / "ytbvos"
    meta = {"videos": {"vb": {"objects": {"1": {"frames": ["00000", "00005"]},
                                          "2": {"frames": ["00005"]}}},
                       "va": {"objects": {"1": {"frames": ["00003"]}}}}}
    (vos).mkdir()
    (vos / "meta.json").write_text(json.dumps(meta))
    for v, frames in (("vb", ("00000", "00005")), ("va", ("00003",))):
        for k, fr in enumerate(frames):
            _jpeg(str(vos / "JPEGImages" / v / f"{fr}.jpg"), k, (18, 22))
            ann = np.zeros((18, 22), np.uint8)
            ann[2 + k:9, 3:11 + k] = 1
            ann[10:15, 12:20] = 2 if v == "vb" else 0
            os.makedirs(vos / "Annotations" / v, exist_ok=True)
            Image.fromarray(ann).save(vos / "Annotations" / v / f"{fr}.png")


@pytest.mark.parametrize("cmd", ["refer2json", "ytbvos2json", "coco2video", "coco2video_sot"])
def test_converters_write_what_jax_writes(tmp_path, monkeypatch, cmd):
    from uninext_tpu_torch.tools import convert_datasets
    _converter_inputs(tmp_path)
    args = {"refer2json": ["refer2json", "--refs", str(tmp_path / "refs.p"),
                           "--instances", str(tmp_path / "instances.json")],
            "ytbvos2json": ["ytbvos2json", "--root", str(tmp_path / "ytbvos")],
            "coco2video": ["coco2video", "--input", str(tmp_path / "instances.json")],
            "coco2video_sot": ["coco2video", "--sot", "--input",
                               str(tmp_path / "instances.json")]}[cmd]
    convert_datasets.main(args + ["--output", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["convert_datasets.py"] + args +
                        ["--output", str(tmp_path / "jax.json")])
    _jax_tool("convert_datasets").main()
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads(got)) > 0
