"""The port's copies of the host data pipeline against the JAX package's
modules, on the same seeds: the mini-COCO and mini-RefCOCO fixtures (the
same bytes on disk), `load_coco_json` and `load_refcoco_json`,
`UniDatasetMapper` (train with LSJ and masks, eval, grounding), the
weighted loader's first batches, and the mask utilities. Everything must
be bit-equal: the copies run the same numpy and PIL code.
"""
import filecmp
import os
import random

import numpy as np
import pytest


from tests.torch_port_common import one_torch_thread
from uninext_tpu.config import DataConfig as JDataConfig
from uninext_tpu.data import coco as jcoco
from uninext_tpu.data import loader as jloader
from uninext_tpu.data import masks as jmasks
from uninext_tpu.data import mini_coco as jmini
from uninext_tpu.data.tokenizer import BertTokenizer as JTokenizer
from uninext_tpu_torch.config import DataConfig
from uninext_tpu_torch.data import coco, loader, masks, mini_coco
from uninext_tpu_torch.data.tokenizer import BertTokenizer

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# small images keep the mapper and the loader cheap
DATA = dict(max_insts=8, max_text_len=32, min_size_train=(96,), max_size_train=160,
            min_size_test=96, max_size_test=160)
LSJ = dict(lsj=True, lsj_size=128, lsj_min_scale=0.6, lsj_max_scale=1.4)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Both packages' mini-COCO (4 train, 3 val) and mini-RefCOCO (3 train,
    2 val) written from the same seeds into two directories."""
    out = {}
    for name, mod in (("jax", jmini), ("port", mini_coco)):
        root = tmp_path_factory.mktemp(name)
        out[name] = (str(root), mod.make_mini_coco(str(root), n_train=4, n_val=3),
                     mod.make_mini_refcoco(str(root), n_train=3, n_val=2))
    return out


def _same_tree(a, b):
    """Every file under a equals the file at the same place under b."""
    names = []
    for dirpath, _, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), a)
            names.append(rel)
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
    return names


def test_mini_coco_files_are_the_same(fixtures):
    (jroot, jpaths, jref), (root, paths, ref) = fixtures["jax"], fixtures["port"]
    names = _same_tree(jroot, root)
    assert len([n for n in names if n.endswith(".jpg")]) == 4 + 3 + 3 + 2
    assert len(names) == len(_same_tree(root, jroot))
    assert {os.path.relpath(p, root) for p in paths.values()} == \
        {os.path.relpath(p, jroot) for p in jpaths.values()}


def _records(fixtures, which):
    """Both packages' records of one split from the port's files."""
    root, paths, ref = fixtures["port"]
    if which == "refcoco":
        return (jcoco.load_refcoco_json(ref["train_json"], ref["train_root"]),
                coco.load_refcoco_json(ref["train_json"], ref["train_root"]), None)
    (jr, jc) = jcoco.load_coco_json(paths[f"{which}_json"], paths[f"{which}_root"])
    (r, c) = coco.load_coco_json(paths[f"{which}_json"], paths[f"{which}_root"])
    assert c == jc
    return jr, r, c


@pytest.mark.parametrize("which", ["train", "val", "refcoco"])
def test_loaders_give_the_same_records(fixtures, which):
    jr, r, _ = _records(fixtures, which)
    assert r == jr and len(r) > 0


def _assert_same_sample(a, b):
    for f in ("image", "img_mask", "image_size", "text_ids", "text_mask", "boxes",
              "valid", "positive_map", "masks", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tuple(a.bucket) == tuple(b.bucket)


@pytest.mark.parametrize("mode", ["train_lsj", "eval", "grounding"])
def test_mapper_matches_jax(fixtures, mode):
    """Three seeds of each record through both mappers: images, masks at
    stride 4, boxes, prompts and positive maps are bit-equal."""
    split = {"train_lsj": "train", "eval": "val", "grounding": "refcoco"}[mode]
    jr, r, cats = _records(fixtures, split)
    cats = cats or ["object"]
    kw = dict(is_train=mode != "eval", with_masks=True)
    if mode == "train_lsj":
        kw.update(LSJ)
    jm = jcoco.UniDatasetMapper(JDataConfig(**DATA), cats, JTokenizer(), **kw)
    m = coco.UniDatasetMapper(DataConfig(**DATA), cats, BertTokenizer(), **kw)
    for rec_j, rec in zip(jr[:2], r[:2]):
        for seed in range(3):
            _assert_same_sample(m(rec, random.Random(seed)), jm(rec_j, random.Random(seed)))


def test_loader_first_batches_match_jax(fixtures):
    """The seeded weighted loader (LSJ, masks, bs=2, 2 threads): the first
    three collated batches are bit-equal."""
    jr, r, cats = _records(fixtures, "train")
    jm = jcoco.UniDatasetMapper(JDataConfig(**DATA), cats, JTokenizer(), is_train=True,
                                with_masks=True, **LSJ)
    m = coco.UniDatasetMapper(DataConfig(**DATA), cats, BertTokenizer(), is_train=True,
                              with_masks=True, **LSJ)
    jit = iter(jloader.MultiDatasetLoader([(jr, jm, 2)], [1.0], seed=3, num_workers=2))
    it = iter(loader.MultiDatasetLoader([(r, m, 2)], [1.0], seed=3, num_workers=2))
    try:
        for _ in range(3):
            jb, b = next(jit), next(it)
            assert set(b) == set(jb) and set(b["targets"]) == set(jb["targets"])
            for k in ("images", "img_mask", "image_sizes", "text_ids", "text_mask"):
                assert np.array_equal(b[k], jb[k]), k
            for k, v in jb["targets"].items():
                assert np.array_equal(b["targets"][k], v), k
            assert b["targets"]["masks"].shape == (2, 8, 32, 32)
    finally:
        jit.close()
        it.close()


def test_mask_utilities_match_jax():
    rng = np.random.RandomState(0)
    polys = [[10.5, 4.0, 40.0, 9.5, 30.2, 33.0, 6.0, 25.0], [50.0, 30.0, 60.0, 30.0, 55.0]]
    want = jmasks.polygons_to_mask(polys, 48, 64)
    assert np.array_equal(masks.polygons_to_mask(polys, 48, 64), want) and want.any()
    m = rng.rand(37, 29) > 0.6
    rle = masks.encode_mask(m)
    assert rle == jmasks.encode_mask(m)
    assert np.array_equal(masks.decode_mask(rle), m.astype(np.uint8))
    a, b = rng.rand(3, 20, 24) > 0.5, rng.rand(4, 20, 24) > 0.4
    assert np.array_equal(masks.mask_iou(a, b), jmasks.mask_iou(a, b))
