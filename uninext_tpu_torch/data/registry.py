"""A copy of `uninext_tpu/data/registry.py` on the port's loaders and mappers (the port imports nothing of the JAX package).

Dataset registry: named splits -> loader + paths.

Parity: reference data/datasets/builtin.py:13-343 (~40 registered splits
across COCO, RefCOCO/+/g, Objects365, YTVIS 2019/2021, OVIS, Ref-YTBVOS,
BDD100K det/inst/box_track/seg_track, SOT suites, SegInW). Paths resolve
under $UNINEXT_DATA (default ./datasets) with the reference's layout.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, List, Tuple

_REGISTRY: Dict[str, Tuple[Callable, str]] = {}


def data_root() -> str:
    return os.environ.get("UNINEXT_DATA", "datasets")


def register(name: str, loader: Callable, task: str):
    _REGISTRY[name] = (loader, task)


def get_dataset(name: str):
    """Returns (records, categories_or_None, task)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name}; known: {sorted(_REGISTRY)}")
    loader, task = _REGISTRY[name]
    out = loader(data_root())
    if isinstance(out, tuple):
        records, cats = out
    else:
        records, cats = out, None
    return records, cats, task


def list_datasets() -> List[str]:
    return sorted(_REGISTRY)


def _coco(root, json_rel, img_rel):
    from .coco import load_coco_json
    return load_coco_json(os.path.join(root, json_rel),
                          os.path.join(root, img_rel))


def _refcoco(root, json_rel, img_rel="coco/train2014"):
    from .coco import load_refcoco_json
    return load_refcoco_json(os.path.join(root, json_rel),
                             os.path.join(root, img_rel))


def _ytvis(root, json_rel, img_rel, has_expression=False):
    from .video import load_ytvis_json
    return load_ytvis_json(os.path.join(root, json_rel),
                           os.path.join(root, img_rel), has_expression)


def _bdd(root, json_rel, img_rel):
    from .sot_datasets import load_bdd100k_track
    return load_bdd100k_track(os.path.join(root, json_rel),
                              os.path.join(root, img_rel))


def _sot(root, kind, sub):
    from . import sot_datasets as sd
    fn = {"got10k": sd.load_got10k, "lasot": sd.load_lasot,
          "trackingnet": sd.load_trackingnet}[kind]
    return fn(os.path.join(root, sub))


# ---- detection / grounding (images) ----
register("coco_2017_train",
         partial(_coco, json_rel="coco/annotations/instances_train2017.json",
                 img_rel="coco/train2017"), "detection")
register("coco_2017_val",
         partial(_coco, json_rel="coco/annotations/instances_val2017.json",
                 img_rel="coco/val2017"), "detection")
register("objects365_v1_train",
         partial(_coco, json_rel="Objects365v1/annotations/objects365_train.json",
                 img_rel="Objects365v1/train"), "detection")
register("objects365_v2_train",
         partial(_coco, json_rel="Objects365V2/annotations/zhiyuan_objv2_train_fixname_fixmiss.json",
                 img_rel="Objects365V2/images"), "detection")
for split in ("train", "val", "testA", "testB"):
    register(f"refcoco-unc-{split}",
             partial(_refcoco, json_rel=f"annotations/refcoco-unc/instances_{split}.json"),
             "grounding")
    register(f"refcocoplus-unc-{split}",
             partial(_refcoco, json_rel=f"annotations/refcocoplus-unc/instances_{split}.json"),
             "grounding")
for split in ("train", "val", "test"):
    register(f"refcocog-umd-{split}",
             partial(_refcoco, json_rel=f"annotations/refcocog-umd/instances_{split}.json"),
             "grounding")
register("refcocog-google-val",
         partial(_refcoco, json_rel="annotations/refcocog-google/instances_val.json"),
         "grounding")
register("refcoco-mixed",
         partial(_refcoco, json_rel="annotations/refcoco-mixed/instances_train.json"),
         "grounding")
# dedup-filtered variant of the mixed split (builtin.py:31)
register("refcoco-mixed-filter",
         partial(_refcoco, json_rel="annotations/refcoco-mixed/instances_train_filter.json"),
         "grounding")
register("flickr30k_train",
         partial(_refcoco, json_rel="flickr30k/final_flickr_separateGT_train.json",
                 img_rel="flickr30k/flickr30k-images"), "grounding")
# reference's key resolves with the REFERENCE on-disk layout
# (builtin.py:48: $ROOT/flickr30k-images + OpenSource/final_flickr_...)
register("flicker-train",
         partial(_refcoco, json_rel="OpenSource/final_flickr_separateGT_train.json",
                 img_rel="flickr30k-images"), "grounding")

# ---- video instance segmentation ----
register("ytvis_2019_train",
         partial(_ytvis, json_rel="ytvis_2019/train.json",
                 img_rel="ytvis_2019/train/JPEGImages"), "detection")
register("ytvis_2019_val",
         partial(_ytvis, json_rel="ytvis_2019/valid.json",
                 img_rel="ytvis_2019/valid/JPEGImages"), "detection")
register("ytvis_2021_train",
         partial(_ytvis, json_rel="ytvis_2021/train.json",
                 img_rel="ytvis_2021/train/JPEGImages"), "detection")
register("ytvis_2021_val",
         partial(_ytvis, json_rel="ytvis_2021/valid.json",
                 img_rel="ytvis_2021/valid/JPEGImages"), "detection")
register("ytvis_2019_test",
         partial(_ytvis, json_rel="ytvis_2019/test.json",
                 img_rel="ytvis_2019/test/JPEGImages"), "detection")
register("ytvis_2019_dev",
         partial(_ytvis, json_rel="ytvis_2019/instances_train_sub.json",
                 img_rel="ytvis_2019/train/JPEGImages"), "detection")
register("ytvis_2021_test",
         partial(_ytvis, json_rel="ytvis_2021/test.json",
                 img_rel="ytvis_2021/test/JPEGImages"), "detection")
register("ytvis_2021_dev",
         partial(_ytvis, json_rel="ytvis_2021/instances_train_sub.json",
                 img_rel="ytvis_2021/train/JPEGImages"), "detection")
register("ytvis_2022_val_full",
         partial(_ytvis, json_rel="ytvis_2022/instances.json",
                 img_rel="ytvis_2022/val/JPEGImages"), "detection")
register("ytvis_2022_val_sub",
         partial(_ytvis, json_rel="ytvis_2022/instances_sub.json",
                 img_rel="ytvis_2022/val/JPEGImages"), "detection")
register("ovis_train",
         partial(_ytvis, json_rel="ovis/annotations_train.json",
                 img_rel="ovis/train"), "detection")
register("ovis_val",
         partial(_ytvis, json_rel="ovis/annotations_valid.json",
                 img_rel="ovis/valid"), "detection")
register("ytvis_ovis_train_sub",
         partial(_ytvis, json_rel="ovis/ovis_sub_train.json",
                 img_rel="ovis/train"), "detection")
register("ytvis_ovis_val_sub",
         partial(_ytvis, json_rel="ovis/ovis_sub_val.json",
                 img_rel="ovis/train"), "detection")
register("rvos-refytb-train",
         partial(_ytvis, json_rel="ref-youtube-vos/train.json",
                 img_rel="ref-youtube-vos/train/JPEGImages",
                 has_expression=True), "grounding")
register("rvos-refytb-val",
         partial(_ytvis, json_rel="ref-youtube-vos/valid.json",
                 img_rel="ref-youtube-vos/valid/JPEGImages",
                 has_expression=True), "grounding")

# ---- MOT / MOTS ----
register("bdd_box_track_train",
         partial(_bdd, json_rel="bdd/labels/box_track_20/train",
                 img_rel="bdd/images/track/train"), "detection")
register("bdd_box_track_val",
         partial(_bdd, json_rel="bdd/labels/box_track_20/val",
                 img_rel="bdd/images/track/val"), "detection")
register("bdd_seg_track_train",
         partial(_bdd, json_rel="bdd/labels/seg_track_20/train",
                 img_rel="bdd/images/seg_track_20/train"), "detection")
register("bdd_seg_track_val",
         partial(_bdd, json_rel="bdd/labels/seg_track_20/val",
                 img_rel="bdd/images/seg_track_20/val"), "detection")

# ---- SOT / VOS ----
register("got10k_train", partial(_sot, kind="got10k", sub="GOT10K"), "sot")
register("got10k_val", lambda r: _sot(r, "got10k", "GOT10K"), "sot")
def _got10k_split(root, split):
    from .sot_datasets import load_got10k
    return load_got10k(os.path.join(root, "GOT10K"), split=split)


register("sot_got10k_test", partial(_got10k_split, split="test"), "sot")
register("lasot_train", partial(_sot, kind="lasot", sub="LaSOT_trainingset"),
         "sot")
register("lasot_test", partial(_sot, kind="lasot", sub="LaSOT_testingset"),
         "sot")
register("trackingnet_test",
         partial(_sot, kind="trackingnet", sub="TrackingNet"), "sot")
register("ytbvos18_train",
         partial(_ytvis, json_rel="ytbvos18/train/train.json",
                 img_rel="ytbvos18/train/JPEGImages"), "sot")
register("ytbvos18_val",
         partial(_ytvis, json_rel="ytbvos18/val/val.json",
                 img_rel="ytbvos18/val/JPEGImages"), "sot")

# ---- pseudo-video / mixed / extra splits (builtin.py:105-300) ----
# COCO as single-frame pseudo-videos for the video joint stage
register("coco_2017_train_video",
         partial(_ytvis, json_rel="coco/annotations/instances_train2017_video.json",
                 img_rel="coco/train2017"), "detection")
register("coco_2017_val_video",
         partial(_ytvis, json_rel="coco/annotations/instances_val2017_video.json",
                 img_rel="coco/val2017"), "detection")
# RefCOCO-mixed as pseudo-videos (R-VOS joint training)
register("rvos-refcoco-mixed",
         partial(_ytvis, json_rel="annotations/refcoco-mixed/instances_train_video.json",
                 img_rel="coco/train2014", has_expression=True), "grounding")
# Ref-DAVIS eval splits (4 annotator sets)
for _i in range(4):
    register(f"rvos-refdavis-val-{_i}",
             partial(_ytvis, json_rel=f"ref-davis/valid_{_i}.json",
                     img_rel="ref-davis/valid/JPEGImages",
                     has_expression=True), "grounding")
# COCO boxes as SOT templates (sot joint training, builtin.py:283-284)
register("sot_coco_2017_train",
         partial(_ytvis, json_rel="coco/annotations/instances_train2017_video_sot.json",
                 img_rel="coco/train2017"), "sot")
register("sot_coco_2017_val",
         partial(_ytvis, json_rel="coco/annotations/instances_val2017_video_sot.json",
                 img_rel="coco/val2017"), "sot")
register("sot_davis17_val",
         partial(_ytvis, json_rel="DAVIS/2017_val.json",
                 img_rel="DAVIS/JPEGImages/480p"), "sot")
register("sot_lasot_ext_test",
         partial(_sot, kind="lasot", sub="LaSOT_extension_subset"), "sot")
register("sot_tnl2k_test",
         partial(_ytvis, json_rel="TNL-2K/test.json", img_rel="TNL-2K"),
         "sot")
register("sot_nfs",
         partial(_ytvis, json_rel="nfs/nfs.json", img_rel="nfs/sequences"),
         "sot")
register("sot_uav123",
         partial(_ytvis, json_rel="UAV123/UAV123.json",
                 img_rel="UAV123/data_seq/UAV123"), "sot")
# BDD100K single-image det / instance-seg splits (builtin.py:191-198)
register("bdd_det_train",
         partial(_coco, json_rel="bdd/labels/det_20/det_train_cocofmt_uni.json",
                 img_rel="bdd/images/100k/train"), "detection")
register("bdd_det_val",
         partial(_coco, json_rel="bdd/labels/det_20/det_val_cocofmt_uni.json",
                 img_rel="bdd/images/100k/val"), "detection")
register("bdd_inst_train",
         partial(_coco, json_rel="bdd/labels/ins_seg/polygons/ins_seg_train_cocoformat_uni.json",
                 img_rel="bdd/images/10k/train"), "detection")
register("bdd_inst_val",
         partial(_coco, json_rel="bdd/labels/ins_seg/polygons/ins_seg_val_cocoformat_uni.json",
                 img_rel="bdd/images/10k/val"), "detection")
# BDD detection+tracking frames mixed into one image-level split
# (builtin.py:215, det_trk_mix.json)
register("bdd_det_trk_mixed_train",
         partial(_coco, json_rel="bdd/labels/det_trk_mix.json",
                 img_rel="bdd/images"), "detection")
# reference-name aliases used verbatim by the joint-stage yaml recipes
for _ref, _ours in (("ytvis_ovis_train", "ovis_train"),
                    ("ytvis_ovis_val", "ovis_val"),
                    ("sot_got10k_train", "got10k_train"),
                    ("sot_got10k_val", "got10k_val"),
                    ("sot_lasot_train", "lasot_train"),
                    ("sot_lasot_test", "lasot_test"),
                    ("sot_trackingnet_test", "trackingnet_test"),
                    ("sot_ytbvos18_train", "ytbvos18_train"),
                    ("sot_ytbvos18_val", "ytbvos18_val")):
    _REGISTRY[_ref] = _REGISTRY[_ours]
_REGISTRY["sot_trackingnet_train"] = (
    partial(_sot, kind="trackingnet", sub="TrackingNet"), "sot")


def video_joint_recipe():
    """The stage-3 14-dataset joint recipe (video_joint_r50.yaml:38-172):
    per-dataset (name, ratio, batch_size, min_sizes, max_size,
    sampling_frame_range). Feed into MultiDatasetLoader as
    datasets=[(records_i, mapper_i, bs_i)], ratios=[ratio_i]."""
    vis_sizes = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
    small = (320, 352, 392, 416, 448, 480, 512, 544, 576, 608, 640)
    return [
        # VIS (VIS:COCO = 1:1)
        ("ytvis_ovis_train",      0.17, 2, vis_sizes, 1333, 10),
        ("ytvis_2019_train",      0.34, 4, small,     768,  10),
        ("coco_2017_train_video", 0.51, 2, vis_sizes, 1333, 10),
        # MOT & MOTS (MOT:MOTS = 10:1, det:track = 1:4)
        ("bdd_det_train",         0.18, 2, vis_sizes, 1333, 3),
        ("bdd_box_track_train",   0.72, 2, vis_sizes, 1333, 3),
        ("bdd_inst_train",        0.02, 2, vis_sizes, 1333, 3),
        ("bdd_seg_track_train",   0.08, 2, vis_sizes, 1333, 3),
        # R-VOS (ref-coco:ref-ytbvos = 2:1)
        ("rvos-refcoco-mixed",    0.67, 2, vis_sizes, 1333, 10),
        ("rvos-refytb-train",     0.33, 2, small,     768,  10),
        # SOT & VOS
        ("sot_got10k_train",      0.2,  2, vis_sizes, 1333, 200),
        ("sot_lasot_train",       0.2,  2, vis_sizes, 1333, 200),
        ("sot_trackingnet_train", 0.2,  2, vis_sizes, 1333, 200),
        ("sot_coco_2017_train",   0.2,  2, vis_sizes, 1333, 200),
        ("sot_ytbvos18_train",    0.2,  2, small,     768,  200),
    ]


_IMG_SIZES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)


def obj365_pretrain_recipe():
    """Stage-1 Objects365v2 pretraining (obj365v2_32g_r50.yaml): single
    dataset, class-aware sampling, BoxInst mask supervision (no gt masks in
    obj365). Image entries use frame_range=None."""
    return [("objects365_v2_train", 1.0, 2, _IMG_SIZES, 1333, None)]


def image_joint_recipe():
    """Stage-2 image-level joint recipe (image_joint_r50.yaml:27-63):
    detection (COCO) + grounding (refcoco-mixed) at ratio 1:1, per-dataset
    batch size 2."""
    return [
        ("coco_2017_train",  1.0, 2, _IMG_SIZES, 1333, None),
        ("refcoco-mixed",    1.0, 2, _IMG_SIZES, 1333, None),
    ]


def _single(names_rows):
    return [r for r in video_joint_recipe() if r[0] in names_rows]


# Training stages & task-specific runs (reference configs/; each value is
# (config_preset, recipe_fn, (lr-step, max_iter), provenance of WEIGHTS).
# The three-stage pipeline hands weights forward: obj365 -> image joint ->
# inflate4c (tools/convert_datasets.py) -> video joint (TRAIN.md:3,
# image_joint_r50.yaml:8, video_joint_r50.yaml:16).
TRAIN_RECIPES = {
    "obj365_pretrain": ("image_joint_r50", obj365_pretrain_recipe,
                        (312346, 340741), "imagenet R-50"),
    "image_joint": ("image_joint_r50", image_joint_recipe,
                    (76658, 91990), "obj365_pretrain"),
    "video_joint": ("video_joint_r50", video_joint_recipe,
                    (150000, 180000), "image_joint + inflate4c"),
    # single-task runs (single_task_*.yaml: 8-GPU, own schedules)
    "single_task_det": ("image_joint_r50",
                        lambda: [("coco_2017_train", 1.0, 2, _IMG_SIZES,
                                  1333, None)],
                        (148000, 177600), "imagenet R-50"),
    "single_task_rec": ("image_joint_r50",
                        lambda: [("refcoco-mixed", 1.0, 2, _IMG_SIZES,
                                  1333, None)],
                        (158635, 190362), "imagenet R-50"),
    "single_task_vis": ("video_joint_r50",
                        lambda: _single({"ytvis_ovis_train",
                                         "ytvis_2019_train",
                                         "coco_2017_train_video"}),
                        (75000, 90000), "single_task_det + inflate4c"),
    "single_task_sot": ("video_joint_r50",
                        lambda: _single({"sot_got10k_train",
                                         "sot_lasot_train",
                                         "sot_trackingnet_train",
                                         "sot_coco_2017_train",
                                         "sot_ytbvos18_train"}),
                        (75000, 90000), "single_task_det + inflate4c"),
    "single_task_rvos": ("video_joint_r50",
                         lambda: _single({"rvos-refcoco-mixed",
                                          "rvos-refytb-train"}),
                         (75000, 90000), "single_task_det + inflate4c"),
    # backbone variants: same dataset recipes, the reference's own preset +
    # schedule per yaml (obj365v2_32g_{vit_huge,convnext_large}.yaml and
    # {image,video}_joint_{vit_huge*,convnext_large}.yaml inherit the r50
    # schedules except image ViT-H's 40000/48000)
    "obj365_pretrain_vit_huge": ("image_joint_vit_huge",
                                 obj365_pretrain_recipe,
                                 (312346, 340741), "MAE ViT-H p14->16"),
    "obj365_pretrain_convnext": ("image_joint_convnext_large",
                                 obj365_pretrain_recipe,
                                 (312346, 340741), "convnext_large_22k_1k"),
    "image_joint_vit_huge": ("image_joint_vit_huge", image_joint_recipe,
                             (40000, 48000), "obj365_pretrain_vit_huge"),
    "image_joint_convnext": ("image_joint_convnext_large",
                             image_joint_recipe,
                             (76658, 91990), "obj365_pretrain_convnext"),
    "video_joint_vit_huge": ("video_joint_vit_huge", video_joint_recipe,
                             (150000, 180000),
                             "image_joint_vit_huge + inflate4c"),
    "video_joint_convnext": ("video_joint_convnext_large",
                             video_joint_recipe, (150000, 180000),
                             "image_joint_convnext + inflate4c"),
    # SegInW zero-shot checkpoints (seginw_{r50,vit_huge}.yaml): the image
    # joint recipe trained from the obj365 pretrain, evaluated zero-shot on
    # the 25 seginw/* splits (tools/eval_seginw.py)
    "seginw": ("image_joint_r50", image_joint_recipe,
               (76658, 91990), "obj365_pretrain"),
    "seginw_vit_huge": ("image_joint_vit_huge", image_joint_recipe,
                        (40000, 48000), "obj365_pretrain_vit_huge"),
}


def build_recipe(name: str, cfg, tokenizer=None):
    """Instantiate a TRAIN_RECIPES entry against the on-disk datasets.

    Returns (cfg', datasets, ratios, video) where cfg' carries the recipe's
    LR schedule, datasets is [(records, mapper, batch_size, task)] ready for
    MultiDatasetLoader, and video says whether batches are (key, ref) pairs
    (use the stage-3 video train step). Mirrors what the reference assembles
    from the yaml DATASETS/DATALOADER/SOLVER blocks (train_net.py:95,
    custom_dataset_dataloader.py:59). The obj365 pretrain recipe gets the
    reference's ClassAwareSampler distribution
    (loader.class_aware_weights); pass the returned `datasets` plus
    `record_weights=recipe_record_weights(name, datasets)` to the loader.
    """
    import dataclasses

    from .coco import UniDatasetMapper
    from .tokenizer import BertTokenizer
    from .video import VideoPairMapper

    _, recipe_fn, (step, max_iter), _ = TRAIN_RECIPES[name]
    rows = recipe_fn()
    tok = tokenizer or BertTokenizer()
    video = any(r[5] is not None for r in rows)
    # stage 1 trains with BoxInst box-supervised masks, exactly like the
    # reference (obj365v2_32g_r50.yaml:3-4 MODEL.BOXINST.ENABLED True —
    # obj365 has no gt masks, so the mask head learns from box projections
    # + LAB pairwise terms)
    boxinst = name == "obj365_pretrain"
    if boxinst:
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, boxinst=True))
    datasets, ratios = [], []
    for (ds_name, ratio, bs, min_sizes, max_size, frange) in rows:
        records, cats, ds_task = get_dataset(ds_name)
        dcfg = dataclasses.replace(cfg.data, min_size_train=tuple(min_sizes),
                                   max_size_train=max_size)
        cats = cats or ["object"]
        if video:
            # image datasets inside a video recipe stream as pseudo-videos
            # (builtin.py coco_2017_train_video; dataset_mapper_uni_vid.py:284)
            mapper = VideoPairMapper(dcfg, cats, tok,
                                     sampling_frame_range=frange or 1)
        elif boxinst:
            # box supervision replaces gt masks entirely
            mapper = UniDatasetMapper(
                dcfg, cats, tok, with_masks=False, boxinst=True,
                boxinst_bottom_pixels=cfg.loss.boxinst_bottom_pixels_removed)
        else:
            mapper = UniDatasetMapper(dcfg, cats, tok)
        # per-batch train-step routing (reference dataset_source semantics):
        # "sot" rows train the template path, "grounding" the expression path
        task = ds_task if ds_task in ("sot", "grounding") else "detection"
        datasets.append((records, mapper, bs, task))
        ratios.append(ratio)
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, steps=(step,),
                                        max_iter=max_iter))
    return cfg, datasets, ratios, video


def recipe_record_weights(name: str, datasets):
    """Per-dataset record-sampling weights for a recipe: the obj365 stage
    uses class-aware sampling (obj365v2_32g_r50.yaml SAMPLER_TRAIN:
    ClassAwareSampler); every shipped USE_RFS flag is False."""
    if name == "obj365_pretrain":
        from .loader import class_aware_weights
        return [class_aware_weights(ds[0]) for ds in datasets]
    return None


# ---- Segmentation-in-the-Wild (25 coco-format subsets) ----
_SEGINW_SUBSETS = (
    "Airplane-Parts", "Bottles", "Brain-Tumor", "Chicken", "Cows",
    "Electric-Shaver", "Elephants", "Fruits", "Garbage", "Ginger-Garlic",
    "Hand", "Hand-Metal", "House-Parts", "HouseHold-Items", "Nutterfly-Squireel",
    "Phones", "Poles", "Puppies", "Rail", "Salmon-Fillet", "Strawberry",
    "Tablets", "Toolkits", "Trash", "Watermelon")
for _sub in _SEGINW_SUBSETS:
    register(f"seginw_{_sub}_val",
             partial(_coco,
                     json_rel=f"seginw/{_sub}/valid/_annotations_min1cat.coco.json",
                     img_rel=f"seginw/{_sub}/valid"), "detection")
