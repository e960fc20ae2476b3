"""Video-task evaluation CLI, the port of `tools/eval_video.py` (the
reference's eval-vid workflow, projects/UNINEXT/configs/eval-vid/*.yaml):
pick an eval preset (`config.EVAL_PRESETS`: the test sizes), walk a dataset
directory in its official layout, stream every video through the matching
driver on the card, write the official output format and, where ground
truth is present, score it.

  --task vis|vis21|ovis  YTVIS json layout -> results.json + submission.zip, mAP
  --task sot             LaSOT layout      -> <vid>.txt + <vid>_time.txt, AUC/P
  --task vos             DAVIS layout      -> palette PNGs, J&F
  --task mot|mots        BDD frame dirs    -> box_track.json (+ seg_track RGBA PNGs)
  --task rvos            Ref-YTVOS json    -> Annotations/<vid>/<exp>/*.png, J&F

    python -m uninext_tpu_torch.tools.eval_video --task vos \\
        --data-root datasets/DAVIS --config video_joint_r50 \\
        --weights model.pth --output-dir out/ [--device cpu]

`--resume-dir` takes a `CheckpointManager` directory. The network runs at
one bucket (H, W): `--bucket`, else the preset's test size with the width
for 1333/800, both rounded up to 32. `--dump-dets DIR` (mot, mots) also
writes each sequence's raw detections (and the gt of a BDD labels json
beside the frames) as DIR/<vid>.npz for a tracker sweep.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from .cli_common import add_device_arg, config_by_name, device_of, load_weights

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True,
                   choices=["vis", "vis21", "ovis", "sot", "vos", "mot", "mots", "rvos"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--json", help="annotation json (vis/rvos)")
    p.add_argument("--config", default="video_joint_r50")
    p.add_argument("--weights", help=".pth reference checkpoint to load")
    p.add_argument("--resume-dir", help="CheckpointManager checkpoint dir")
    p.add_argument("--output-dir", default="eval_out")
    p.add_argument("--bucket", type=int, nargs=2, default=None,
                   help="static (H, W) network bucket; default from preset")
    p.add_argument("--max-videos", type=int, default=0)
    p.add_argument("--rvos-temporal-weight", type=float, default=None,
                   help="rvos only: blend selection with reid cosine to "
                        "the previous frame's pick (0/None = reference "
                        "frame-independent scoring)")
    p.add_argument("--dump-dets", metavar="DIR",
                   help="mot only: also cache per-sequence raw detections "
                        "(+gt when a BDD labels dir sits next to the "
                        "frames) as DIR/<vid>.npz")
    add_device_arg(p)
    return p.parse_args(argv)


def norm_frame(path, H, W):
    """A frame resized by its shortest edge into (H, W), normalised and
    zero-padded; returns it, the content size (h, w) and the original."""
    from PIL import Image

    from ..data.coco import resize_shortest_edge
    img = np.asarray(Image.open(path).convert("RGB"), np.float32)
    h0, w0 = img.shape[:2]
    h, w = resize_shortest_edge(h0, w0, H, W)
    img = np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR), np.float32)
    out = np.zeros((H, W, 3), np.float32)
    out[:h, :w] = (img - MEAN) / STD
    return out, (h, w), (h0, w0)


def build(args, device):
    """The preset's config, the bucket, the model on `device` (with the
    template branch for sot and vos) with its weights, and the preset's
    with-mask flag."""
    from ..config import eval_config
    from ..models.detr import build_model

    base = config_by_name(args.config)
    cfg, _, with_mask = eval_config(base, args.task)
    if args.bucket:
        H, W = args.bucket
    else:
        H = cfg.data.min_size_test
        W = min(cfg.data.max_size_test, (H * 1333) // 800)
        W = ((W + 31) // 32) * 32
        H = ((H + 31) // 32) * 32
    model = build_model(cfg, device, seed=0, template=args.task in ("sot", "vos"))
    load_weights(model, args.weights, args.resume_dir)
    return model, cfg, (H, W), with_mask


def frames_of(paths, H, W):
    """Normalised (1, H, W, 3) frames of a video, its pad mask (1, H, W),
    sizes (1, 2), the content size and the original size (of the last)."""
    frames, hw, ori = [], None, None
    for p in paths:
        f, hw, ori = norm_frame(p, H, W)
        frames.append(f[None])
    h, w = hw
    img_masks = (~(np.arange(H)[:, None] < h) | ~(np.arange(W)[None] < w))[None]
    sizes = np.array([[h, w]], np.int32)
    return frames, img_masks, sizes, hw, ori


def run_vis(args, model, cfg, HW, device):
    from ..data.prompts import create_label_token_map
    from ..data.tokenizer import BertTokenizer
    from ..data.video import load_ytvis_json
    from ..engine.video_inference import VISDriver
    from ..evaluation.bdd_submit import package_ytvis_submission
    from ..evaluation.ytvis_eval import save_ytvis_results, video_output_to_ytvis

    H, W = HW
    js = args.json or os.path.join(args.data_root, "valid.json")
    records, cats = load_ytvis_json(js, os.path.join(args.data_root, "JPEGImages"))
    tok = BertTokenizer()
    tids, tmask, cmap = create_label_token_map(cats, tok, cfg.data.max_text_len)
    drv = VISDriver(model, cfg, cmap, device)
    results = []
    for i, rec in enumerate(records):
        if args.max_videos and i >= args.max_videos:
            break
        frames, img_masks, sizes, _, _ = frames_of(rec["file_names"], H, W)
        t0 = time.perf_counter()
        out = drv.run_video(frames, img_masks, sizes, tids[None], tmask[None],
                            ori_size=(rec["height"], rec["width"]))
        print(f"[vis] video {rec['video_id']} "
              f"{len(frames) / (time.perf_counter() - t0):.1f} FPS")
        results.extend(video_output_to_ytvis(rec["video_id"], out))
    # predictions carry contiguous-index+1 category ids; map back to the
    # dataset's ids before writing the submission (identity for YTVIS)
    with open(js) as f:
        gt = json.load(f)
    id_map = {i + 1: c["id"] for i, c in enumerate(
        sorted(gt["categories"], key=lambda c: c["id"]))}
    results = [{**r, "category_id": id_map.get(r["category_id"], r["category_id"])}
               for r in results]
    path = save_ytvis_results(results, args.output_dir)
    package_ytvis_submission(results, os.path.join(args.output_dir, "submission.zip"))
    print(f"[vis] {len(results)} tracks -> {path}")
    # score locally when the json carries gt tracks (the official valid.json
    # has none: server-only, as in the reference)
    if any(a.get("segmentations") for a in gt.get("annotations", [])):
        from ..evaluation.ytvis_eval import evaluate_ytvis
        if args.max_videos:
            # gt of the processed videos (a total miss stays in the recall)
            keep = {r["video_id"] for r in records[:args.max_videos]}
            gt = {**gt, "videos": [v for v in gt["videos"] if v["id"] in keep],
                  "annotations": [a for a in gt["annotations"] if a["video_id"] in keep]}
        res = evaluate_ytvis(results, gt)
        print(json.dumps({"vis_" + k: round(v, 4) for k, v in res.items()}, indent=1))


def run_sot(args, model, cfg, HW, device):
    """LaSOT layout -> `<vid>.txt` and `<vid>_time.txt` at the original
    resolution, per-sequence and mean AUC / P / Pnorm. A finished
    `<vid>.txt` with one box per frame is reused (the reference skips saved
    videos, uninext_vid.py:469-471)."""
    from ..data.sot_datasets import load_lasot
    from ..engine.sot_inference import SOTDriver
    from ..evaluation.sot_eval import evaluate_sot, evaluate_sot_dataset, save_sot_results

    H, W = HW
    seqs = load_lasot(args.data_root)
    drv = SOTDriver(model, cfg, device)
    per_seq = {}
    for i, seq in enumerate(seqs):
        if args.max_videos and i >= args.max_videos:
            break
        gt = np.asarray(seq["gt_xywh"], np.float32)     # original pixels
        done = os.path.join(args.output_dir, f"{seq['name']}.txt")
        if os.path.exists(done):
            prev = np.loadtxt(done, delimiter=",", ndmin=2)
            if len(prev) == len(seq["frames"]):
                print(f"[sot] {seq['name']}: resuming from {done}")
                per_seq[seq["name"]] = {"pred": prev.astype(np.float32), "gt": gt,
                                        "visible": seq.get("visible")}
                continue
        frames, img_masks, sizes, (h, w), (h0, w0) = frames_of(seq["frames"], H, W)
        sx, sy = w / w0, h / h0
        init = gt[0] * [sx, sy, sx, sy]
        init_xyxy = np.array([init[0], init[1], init[0] + init[2], init[1] + init[3]])
        boxes, times = drv.run_video(frames, img_masks, sizes, init_xyxy)
        boxes_ori = boxes / [sx, sy, sx, sy]
        save_sot_results(args.output_dir, seq["name"], boxes_ori, times)
        pred_xywh = np.stack([boxes_ori[:, 0], boxes_ori[:, 1],
                              boxes_ori[:, 2] - boxes_ori[:, 0],
                              boxes_ori[:, 3] - boxes_ori[:, 1]], 1)
        per_seq[seq["name"]] = {"pred": pred_xywh, "gt": gt, "visible": seq.get("visible")}
        m = evaluate_sot(pred_xywh, gt, seq.get("visible"))
        print(f"[sot] {seq['name']} auc={m['AUC']:.3f}")
    agg = evaluate_sot_dataset(per_seq)
    print(json.dumps({k: float(v) for k, v in agg.items()}, indent=1))


def run_vos(args, model, cfg, HW, device):
    from ..engine.sot_inference import VOSDriver
    from ..evaluation.davis_eval import evaluate_davis, load_davis_png, save_davis_png

    H, W = HW
    img_root = os.path.join(args.data_root, "JPEGImages", "480p")
    ann_root = os.path.join(args.data_root, "Annotations", "480p")
    vids = sorted(os.listdir(img_root))
    drv = VOSDriver(model, cfg, device)
    js = {}
    for i, vid in enumerate(vids):
        if args.max_videos and i >= args.max_videos:
            break
        fns = sorted(os.listdir(os.path.join(img_root, vid)))
        frames, img_masks, sizes, (h, w), (h0, w0) = frames_of(
            [os.path.join(img_root, vid, f) for f in fns], H, W)
        # per-object init from the annotation of each object's first frame
        anns = sorted(os.listdir(os.path.join(ann_root, vid)))
        init = {}
        iy = (np.arange(h) * h0) // h
        ix = (np.arange(w) * w0) // w
        for fi, a in enumerate(anns):
            am = load_davis_png(os.path.join(ann_root, vid, a))
            for oid in np.unique(am):
                if oid == 0 or int(oid) in init:
                    continue
                ys, xs = np.nonzero(am == oid)
                gm = np.zeros((H, W), np.float32)
                gm[:h, :w] = (am == oid)[iy][:, ix]
                # exclusive max edge (+1), as the driver's 3f-refresh boxes
                box = np.array([xs.min() * w / w0, ys.min() * h / h0,
                                (xs.max() + 1) * w / w0, (ys.max() + 1) * h / h0],
                               np.float32)
                init[int(oid)] = {"frame": fi, "mask": gm, "box_xyxy": box}
        labels = drv.run_video(frames, img_masks, sizes, init)
        gt_by_obj, pred_by_obj = {}, {}
        # submission PNGs at the annotation's original resolution: a
        # nearest-neighbour upsample of the [:h, :w] content region
        oy = (np.arange(h0) * h) // h0
        ox = (np.arange(w0) * w) // w0
        for fi, lab in enumerate(labels):
            save_davis_png(lab[oy][:, ox], os.path.join(args.output_dir, vid,
                                                        fns[fi].replace(".jpg", ".png")))
        # score frames that have gt annotations, at network scale
        for fi, a in enumerate(anns):
            if fi >= len(labels):
                break
            am = load_davis_png(os.path.join(ann_root, vid, a))[iy][:, ix]
            for oid in init:
                gt_by_obj.setdefault(oid, []).append(am == oid)
                pred_by_obj.setdefault(oid, []).append(labels[fi][:h, :w] == oid)
        res = evaluate_davis(pred_by_obj, gt_by_obj)
        js[vid] = {k: float(v) for k, v in res.items()}
        print(f"[vos] {vid} {js[vid]}")
    if js:
        mean_jf = float(np.mean([v["J&F"] for v in js.values()]))
        print(json.dumps({"J&F": mean_jf, "per_video": js}, indent=1))


def save_detections(path, raw_frames, image_size, ori_size, gt_frames=None,
                    select_thr=0.0):
    """A sequence's detection cache (and gt) as one npz
    (`tools/grid_search_track.py:38`); `select_thr` is the score floor the
    detections were filtered at."""
    arrs = {"n_frames": np.array(len(raw_frames)),
            "image_size": np.asarray(image_size),
            "ori_size": np.asarray(ori_size),
            "select_thr": np.array(float(select_thr))}
    for i, o in enumerate(raw_frames):
        for k in ("boxes", "scores", "labels", "embeds"):
            arrs[f"{k}_{i}"] = np.asarray(o[k])
    if gt_frames is not None:
        for i, g in enumerate(gt_frames):
            arrs[f"gt_ids_{i}"] = np.asarray(g["ids"])
            arrs[f"gt_boxes_{i}"] = np.asarray(g["boxes"])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrs)


def _load_bdd_gt(frames_root, vid, fns):
    """Per-frame gt {ids, boxes} from a BDD scalabel labels json when one
    sits next to the frame dirs (<root>/../labels/<vid>.json, the official
    box_track_20 layout); None otherwise."""
    lab = os.path.join(os.path.dirname(frames_root.rstrip("/")), "labels", f"{vid}.json")
    if not os.path.exists(lab):
        return None
    with open(lab) as f:
        recs = json.load(f)
    by_name = {r["name"]: r for r in recs}
    gt = []
    for fn in fns:
        r = by_name.get(fn, {})
        ids, boxes = [], []
        for lb in r.get("labels", []):
            b = lb.get("box2d")
            if not b:
                continue
            ids.append(int(lb["id"]))
            boxes.append([b["x1"], b["y1"], b["x2"], b["y2"]])
        gt.append({"ids": np.array(ids, np.int64),
                   "boxes": np.array(boxes, np.float32).reshape(-1, 4)})
    return gt


def run_mot(args, model, cfg, HW, device, with_masks=False):
    """MOT (box_track json) or, with_masks, MOTS (seg_track: an RGBA bitmask
    PNG per frame, and the json) in BDD100K's submission formats."""
    from ..data.prompts import create_label_token_map
    from ..data.tokenizer import BertTokenizer
    from ..engine.mot_inference import MOTDriver, associate
    from ..evaluation.bdd_submit import (BDD_CATEGORIES, box_track_to_bdd, save_bdd_json,
                                         seg_track_to_bdd)
    H, W = HW
    tok = BertTokenizer()
    tids, tmask, cmap = create_label_token_map(list(BDD_CATEGORIES), tok,
                                               cfg.data.max_text_len)
    drv = MOTDriver(model, cfg, cmap, with_masks=with_masks, device=device)
    root = args.data_root
    vids = sorted(os.listdir(root))
    all_frames = []
    for i, vid in enumerate(vids):
        if args.max_videos and i >= args.max_videos:
            break
        fns = sorted(os.listdir(os.path.join(root, vid)))
        frames, img_masks, sizes, _, ori = frames_of(
            [os.path.join(root, vid, f) for f in fns], H, W)
        raw = drv.detect_video(frames, img_masks, sizes, tids[None], tmask[None])
        image_size = (int(sizes[0, 0]), int(sizes[0, 1]))
        if args.dump_dets:
            save_detections(os.path.join(args.dump_dets, f"{vid}.npz"), raw, image_size,
                            ori, gt_frames=_load_bdd_gt(root, vid, fns),
                            select_thr=drv.select_thr)
        tr = cfg.track
        per_frame = associate(raw, image_size, ori, with_masks=with_masks,
                              init_score_thr=tr.init_score_thr,
                              obj_score_thr=tr.obj_score_thr)
        all_frames.extend(box_track_to_bdd(per_frame, fns, vid))
        if with_masks:
            seg_track_to_bdd(per_frame, [os.path.join(vid, f) for f in fns],
                             os.path.join(args.output_dir, "seg_track"),
                             (int(ori[0]), int(ori[1])))
        print(f"[mot] {vid}: {sum(len(f['labels']) for f in all_frames)} dets")
    path = save_bdd_json(all_frames, os.path.join(args.output_dir, "box_track.json"))
    print(f"[mot] -> {path}" + (f" + seg_track PNGs in {args.output_dir}/seg_track"
                                if with_masks else ""))


def run_rvos(args, model, cfg, HW, device):
    """Ref-Youtube-VOS-style evaluation: per (video, expression) the
    streaming top-1 masks -> Annotations/<vid>/<exp_idx>/<frame>.png (the
    official server's layout); with the referred tracks' segmentations in
    the json, per-expression and mean J&F."""
    from ..data.masks import polygons_to_mask
    from ..data.tokenizer import BertTokenizer
    from ..data.video import load_ytvis_json
    from ..engine.mot_inference import RVOSDriver
    from ..evaluation.davis_eval import evaluate_davis, save_davis_png
    H, W = HW
    recs, _ = load_ytvis_json(args.json, args.data_root, has_expression=True)
    tok = BertTokenizer()
    drv = RVOSDriver(model, cfg, device)
    jf_all = []
    for i, rec in enumerate(recs):
        if args.max_videos and i >= args.max_videos:
            break
        frames, img_masks, sizes, _, (h0, w0) = frames_of(rec["file_names"], H, W)
        vname = os.path.basename(os.path.dirname(rec["file_names"][0]))
        for ei, expr in enumerate(rec["expressions"] or []):
            t = tok(expr, max_length=cfg.data.max_text_len)
            lang = drv.encode_prompt(t["input_ids"][None], t["attention_mask"][None])
            masks = drv.run_video(frames, img_masks, sizes, lang["hidden"], lang["masks"],
                                  ori_size=(h0, w0))
            for fi, m in enumerate(masks):
                fn = os.path.splitext(os.path.basename(rec["file_names"][fi]))[0] + ".png"
                save_davis_png(m.astype(np.uint8), os.path.join(
                    args.output_dir, "Annotations", vname, str(ei), fn))
            if rec["tracks"]:
                gt = []
                for fi in range(rec["length"]):
                    segs = rec["tracks"][0]["segmentations"][fi]
                    gt.append(polygons_to_mask(
                        [np.asarray(s, np.float64) for s in segs], h0, w0
                    ).astype(bool) if segs else np.zeros((h0, w0), bool))
                jf = evaluate_davis({1: [m.astype(bool) for m in masks]}, {1: gt})["J&F"]
                jf_all.append(jf)
                print(f"[rvos] {vname}/{ei} '{expr}' J&F={jf:.3f}")
            else:
                print(f"[rvos] {vname}/{ei} '{expr}' ({len(masks)} frames)")
    if jf_all:
        print(f"[rvos] mean J&F over {len(jf_all)} (video, expr): "
              f"{float(np.mean(jf_all)):.4f}")


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    model, cfg, HW, _ = build(args, device)
    if args.rvos_temporal_weight is not None:
        cfg = dataclasses.replace(cfg, rvos_temporal_weight=args.rvos_temporal_weight)
    if args.task in ("vis", "vis21", "ovis"):
        run_vis(args, model, cfg, HW, device)
    elif args.task == "sot":
        run_sot(args, model, cfg, HW, device)
    elif args.task == "vos":
        run_vos(args, model, cfg, HW, device)
    elif args.task in ("mot", "mots"):
        run_mot(args, model, cfg, HW, device, with_masks=args.task == "mots")
    else:
        run_rvos(args, model, cfg, HW, device)


if __name__ == "__main__":
    main()
