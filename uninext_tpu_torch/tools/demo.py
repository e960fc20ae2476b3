"""Demo, the port of `tools/demo.py` (the reference's demo.py and
predictor.py): detection with the COCO class prompt or grounding with
`--prompt` on one image, the same on every frame of a directory, or SOT
tracking through the frames from `--init-box`; boxes drawn with PIL.

    python -m uninext_tpu_torch.tools.demo --image img.jpg [--prompt "the dog"]
    python -m uninext_tpu_torch.tools.demo --frames dir/ [--init-box x0 y0 x1 y1]

`--checkpoint` takes a `CheckpointManager` directory (the JAX tool's orbax
directory): its latest weights load by name and shape, so an image stage's
checkpoint leaves the template branch as initialised.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .cli_common import add_device_arg, config_by_name, device_of, restore_from_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None, help="single-image demo")
    p.add_argument("--frames", default=None, help="directory of video frames (video demo)")
    p.add_argument("--init-box", type=float, nargs=4, default=None,
                   help="x0 y0 x1 y1 on the first frame -> SOT tracking")
    p.add_argument("--prompt", default=None,
                   help="referring expression (grounding); default = COCO "
                        "class-name detection prompt")
    p.add_argument("--config", default="image_joint_r50")
    p.add_argument("--checkpoint", default=None, help="CheckpointManager checkpoint dir")
    p.add_argument("--output", default="demo_out.png",
                   help="output png (--image) or directory (--frames)")
    p.add_argument("--score-thr", type=float, default=0.3)
    add_device_arg(p)
    return p.parse_args(argv)


def load_frame(path, cfg):
    """The image, and its network input: resized by the shortest edge,
    normalised, padded to multiples of 32, with the pad mask, sizes and the
    content size."""
    from PIL import Image

    from ..data.coco import resize_shortest_edge, round_up
    img = Image.open(path).convert("RGB")
    w0, h0 = img.size
    h, w = resize_shortest_edge(h0, w0, cfg.data.min_size_test, cfg.data.max_size_test)
    arr = np.asarray(img.resize((w, h), Image.BILINEAR), np.float32)
    arr = (arr - np.array(cfg.data.pixel_mean)) / np.array(cfg.data.pixel_std)
    Hb, Wb = round_up(h, 32), round_up(w, 32)
    padded = np.zeros((1, Hb, Wb, 3), np.float32)
    padded[0, :h, :w] = arr
    img_mask = np.ones((1, Hb, Wb), bool)
    img_mask[0, :h, :w] = False
    return img, padded, img_mask, np.array([[h, w]], np.int32), (h, w)


def draw_boxes(img, hw, boxes, scores, classes, names, thr):
    from PIL import Image, ImageDraw
    h, w = hw
    vis = img.resize((w, h), Image.BILINEAR)
    draw = ImageDraw.Draw(vis)
    kept = 0
    for b, s, c in zip(boxes, scores, classes):
        if s < thr:
            continue
        draw.rectangle([float(x) for x in b], outline=(255, 40, 40), width=2)
        draw.text((b[0] + 2, b[1] + 2), f"{names[int(c)][:18]} {s:.2f}", fill=(255, 255, 0))
        kept += 1
    return vis, kept


def main(argv=None):
    args = parse_args(argv)
    if not args.image and not args.frames:
        raise SystemExit("give --image or --frames")
    device = device_of(args.device)

    import torch

    from ..data.prompts import create_label_token_map
    from ..data.tokenizer import BertTokenizer
    from ..models.detr import build_model
    from ..models.postprocess import postprocess_detection

    cfg = config_by_name(args.config)
    tok = BertTokenizer()
    if args.prompt:
        task = "grounding"
        t = tok(args.prompt, max_length=cfg.data.max_text_len)
        ids, mask = t["input_ids"], t["attention_mask"]
        cls_map = np.ones((1, cfg.data.max_text_len), bool)
        names = [args.prompt]
    else:
        task = "detection"
        from ..data.coco_categories import COCO_CATEGORIES
        names = COCO_CATEGORIES
        ids, mask, cls_map = create_label_token_map(names, tok, cfg.data.max_text_len)

    sot = bool(args.frames and args.init_box is not None)
    model = build_model(cfg, device, seed=0, template=sot)
    if args.checkpoint:
        restore_from_dir(model, args.checkpoint)

    # ---- SOT video demo: track --init-box through the frames ----
    if sot:
        from ..engine.sot_inference import SOTDriver
        paths = sorted(glob.glob(os.path.join(args.frames, "*")))
        imgs, hws, frames = [], [], []
        for p in paths:
            img, padded, img_mask, sizes, hw = load_frame(p, cfg)
            imgs.append(img)
            hws.append(hw)
            frames.append(padded)
        if len(set(hws)) != 1:
            raise SystemExit(f"--frames requires uniform frame sizes; got "
                             f"{sorted(set(hws))} (the SOT driver tracks "
                             "one static-resolution stream)")
        hw = hws[0]
        # --init-box is in original first-frame pixels; the network runs at
        # the resized resolution
        w0, h0 = imgs[0].size
        sx, sy = hw[1] / w0, hw[0] / h0
        init = np.asarray(args.init_box, np.float32) * [sx, sy, sx, sy]
        boxes, _ = SOTDriver(model, cfg, device).run_video(frames, img_mask, sizes, init)
        os.makedirs(args.output, exist_ok=True)
        for i, (img, b) in enumerate(zip(imgs, boxes)):
            vis, _ = draw_boxes(img, hw, [b], [1.0], [0], ["target"], 0.0)
            vis.save(os.path.join(args.output, f"{i:05d}.png"))
        print(f"tracked {len(boxes)} frames -> {args.output}/")
        return

    # ---- per-frame detection / grounding (single image or video) ----
    as_t = lambda x: torch.as_tensor(np.asarray(x)).to(device)
    text_ids, text_mask, cmap = as_t(ids[None]).long(), as_t(mask[None]), as_t(cls_map)

    @torch.inference_mode()
    def detect(path):
        img, padded, img_mask, sizes, hw = load_frame(path, cfg)
        out = model(as_t(padded), as_t(img_mask), as_t(sizes), text_ids, text_mask,
                    task=task)
        post = postprocess_detection(
            {k: out[k] for k in ("pred_logits", "pred_boxes", "pred_boxious") if k in out},
            cmap, max_inst=1 if task == "grounding" else 100,
            use_nms=(task == "detection"))
        h, w = hw
        boxes = post["boxes"][0].float().cpu().numpy() * [w, h, w, h]
        return draw_boxes(img, hw, boxes, post["scores"][0].float().cpu().numpy(),
                          post["classes"][0].cpu().numpy(), names, args.score_thr)

    if args.image:
        vis, kept = detect(args.image)
        vis.save(args.output)
        print(f"saved {args.output} with {kept} detections >= {args.score_thr}")
    else:
        paths = sorted(glob.glob(os.path.join(args.frames, "*")))
        os.makedirs(args.output, exist_ok=True)
        for i, p in enumerate(paths):
            vis, kept = detect(p)
            vis.save(os.path.join(args.output, f"{i:05d}.png"))
        print(f"annotated {len(paths)} frames -> {args.output}/")


if __name__ == "__main__":
    main()
