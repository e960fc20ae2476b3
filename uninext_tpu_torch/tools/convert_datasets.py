"""Dataset and checkpoint converters, the port of `tools/convert_datasets.py`
(the reference's conversion/).

Sub-commands:
  refer2json   REFER-style refs(unc).p + instances.json -> a per-split json
               for `data/coco.py:load_refcoco_json`
  ytbvos2json  YouTube-VOS meta.json + Annotations -> a ytvis-style json
               with per-frame boxes from the masks' extents
  inflate4c    a .pth's backbone conv1 3 -> 4 input channels for the SOT/VOS
               template branch (`engine/checkpoint.py:inflate_conv_3c_to_4c`)
  coco2video   a COCO instances json -> 1-frame pseudo-videos (ytvis-style);
               --sot collapses every category to one "object" class

    python -m uninext_tpu_torch.tools.convert_datasets inflate4c --input a.pth --output b.pth
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def refer2json(args):
    with open(args.refs, "rb") as f:
        refs = pickle.load(f)
    with open(args.instances) as f:
        inst = json.load(f)
    anns = {a["id"]: a for a in inst["annotations"]}
    imgs = {i["id"]: i for i in inst["images"]}
    out = []
    for ref in refs:
        if args.split and ref.get("split") != args.split:
            continue
        ann = anns.get(ref["ann_id"])
        img = imgs.get(ref["image_id"])
        if ann is None or img is None:
            continue
        out.append({
            "file_name": img["file_name"],
            "image_id": img["id"],
            "height": img["height"], "width": img["width"],
            "annotations": [{"bbox": ann["bbox"], "category_id": 0,
                             "segmentation": ann.get("segmentation")}],
            "expressions": [s["sent" if "sent" in s else "raw"] for s in ref["sentences"]],
        })
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out)} expression records -> {args.output}")


def ytbvos2json(args):
    from PIL import Image
    with open(os.path.join(args.root, "meta.json")) as f:
        meta = json.load(f)["videos"]
    videos, annotations = [], []
    vid_id = ann_id = 0
    for vname, v in meta.items():
        vid_id += 1
        frames = sorted({f for o in v["objects"].values() for f in o["frames"]})
        first = os.path.join(args.root, "JPEGImages", vname, frames[0] + ".jpg")
        w, h = Image.open(first).size if os.path.exists(first) else (0, 0)
        videos.append({"id": vid_id, "height": h, "width": w, "length": len(frames),
                       "file_names": [f"{vname}/{fr}.jpg" for fr in frames]})
        for oid, obj in v["objects"].items():
            ann_id += 1
            bboxes = [None] * len(frames)
            for fr in obj["frames"]:
                mask_path = os.path.join(args.root, "Annotations", vname, fr + ".png")
                if not os.path.exists(mask_path):
                    continue
                m = np.asarray(Image.open(mask_path)) == int(oid)
                ys, xs = np.where(m)
                if len(ys):
                    x0, x1 = xs.min(), xs.max()
                    y0, y1 = ys.min(), ys.max()
                    bboxes[frames.index(fr)] = [float(x0), float(y0),
                                                float(x1 - x0), float(y1 - y0)]
            annotations.append({"id": ann_id, "video_id": vid_id,
                                "category_id": 1, "bboxes": bboxes})
    out = {"videos": videos, "annotations": annotations,
           "categories": [{"id": 1, "name": "object"}]}
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(videos)} videos, {len(annotations)} tracks")


def inflate4c(args):
    import torch

    from ..engine.checkpoint import inflate_conv_3c_to_4c
    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    model = sd.get("model", sd)
    key = args.key
    w = model[key]
    if w.shape[1] != 3:
        raise SystemExit(f"{key}: {tuple(w.shape)} has {w.shape[1]} input channels, not 3")
    model[key] = inflate_conv_3c_to_4c(w)
    torch.save(sd, args.output)
    print(f"inflated {key} {tuple(w.shape)} -> {tuple(model[key].shape)}")


def coco2video(args):
    with open(args.input) as f:
        src = json.load(f)
    videos, annos = [], []
    for img in src["images"]:
        v = {"id": img["id"], "length": 1, "height": img["height"],
             "width": img["width"], "file_names": [img["file_name"]]}
        if "expressions" in img:              # refcoco-mixed pseudo-video
            v["expressions"] = img["expressions"]
        videos.append(v)
    for a in src["annotations"]:
        annos.append({"id": a["id"], "video_id": a["image_id"],
                      "iscrowd": a.get("iscrowd", 0),
                      "category_id": 1 if args.sot else a["category_id"],
                      "bboxes": [a["bbox"]],
                      "areas": [a.get("area")],
                      **({"segmentations": [a["segmentation"]]}
                         if "segmentation" in a else {})})
    cats = ([{"supercategory": "object", "id": 1, "name": "object"}]
            if args.sot else src["categories"])
    with open(args.output, "w") as f:
        json.dump({"videos": videos, "annotations": annos, "categories": cats}, f)
    print(f"wrote {len(videos)} pseudo-videos, {len(annos)} tracks")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("refer2json")
    r.add_argument("--refs", required=True)
    r.add_argument("--instances", required=True)
    r.add_argument("--split", default="train")
    r.add_argument("--output", required=True)
    y = sub.add_parser("ytbvos2json")
    y.add_argument("--root", required=True)
    y.add_argument("--output", required=True)
    i = sub.add_parser("inflate4c")
    i.add_argument("--input", required=True)
    i.add_argument("--output", required=True)
    i.add_argument("--key", default="detr.detr.backbone.0.backbone.stem.conv1.weight")
    c = sub.add_parser("coco2video")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--sot", action="store_true")
    args = p.parse_args(argv)
    {"refer2json": refer2json, "ytbvos2json": ytbvos2json,
     "inflate4c": inflate4c, "coco2video": coco2video}[args.cmd](args)


if __name__ == "__main__":
    main()
