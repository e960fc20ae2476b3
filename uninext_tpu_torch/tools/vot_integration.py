"""VOT challenge toolkit adapter, the port of `tools/vot_integration.py`
(the reference's uninext_vots.py and vot_tool.py): the SOT frame step as a
VOT tracker. The toolkit feeds frames one at a time and the tracker answers
with a box and its confidence. `main` needs the `vot` package; the class
works with any harness that calls `initialize(image, region_xywh)` and
`track(image)`.

    python -m uninext_tpu_torch.tools.vot_integration     # under the vot toolkit
"""
from __future__ import annotations

import numpy as np
import torch

from .cli_common import config_by_name, device_of, restore_from_dir


class UninextVOTTracker:
    """`config_name`'s model with the template branch on `device` (the card
    unless the caller asks for the CPU); `checkpoint`, a `CheckpointManager`
    directory, gives its weights."""

    def __init__(self, config_name: str = "video_joint_r50",
                 checkpoint: str | None = None, device: str = "cuda"):
        self.cfg = config_by_name(config_name)
        self.device = device_of(device)
        self.model = None
        self.checkpoint = checkpoint

    def _prep(self, image: np.ndarray):
        from PIL import Image

        from ..data.coco import resize_shortest_edge, round_up
        h0, w0 = image.shape[:2]
        h, w = resize_shortest_edge(h0, w0, self.cfg.data.min_size_test,
                                    self.cfg.data.max_size_test)
        arr = np.asarray(Image.fromarray(image).resize((w, h)), np.float32)
        arr = (arr - np.array(self.cfg.data.pixel_mean)) / np.array(self.cfg.data.pixel_std)
        Hb, Wb = round_up(h, 32), round_up(w, 32)
        padded = np.zeros((1, Hb, Wb, 3), np.float32)
        padded[0, :h, :w] = arr
        mask = np.ones((1, Hb, Wb), bool)
        mask[0, :h, :w] = False
        self.scale = (w / w0, h / h0)
        t = lambda x: torch.as_tensor(x).to(self.device)
        return t(padded), t(mask), t(np.array([[h, w]], np.int32))

    def initialize(self, image: np.ndarray, region_xywh):
        from ..engine.sot_inference import make_sot_frame_step, make_template_encoder
        from ..models.detr import build_model
        frame, mask, sizes = self._prep(image)
        if self.model is None:
            self.model = build_model(self.cfg, self.device, seed=0, template=True)
            if self.checkpoint:
                restore_from_dir(self.model, self.checkpoint)
        self.encode = make_template_encoder(self.model, self.cfg)
        self.step = make_sot_frame_step(self.model, with_mask=True)
        x, y, w, h = region_xywh
        sx, sy = self.scale
        box = np.array([[x * sx, y * sy, (x + w) * sx, (y + h) * sy]], np.float32)
        self.lang = self.encode(frame, torch.as_tensor(box).to(self.device))

    def track(self, image: np.ndarray):
        """The box (x, y, w, h) in the image's pixels and its score."""
        frame, mask, sizes = self._prep(image)
        r = self.step(frame, mask, sizes, self.lang["hidden"], self.lang["masks"])
        h, w = int(sizes[0, 0]), int(sizes[0, 1])
        box = r["box_cxcywh"][0].float().cpu().numpy() * [w, h, w, h]
        sx, sy = self.scale
        x0 = (box[0] - box[2] / 2) / sx
        y0 = (box[1] - box[3] / 2) / sy
        return ([float(x0), float(y0), float(box[2] / sx), float(box[3] / sy)],
                float(r["score"][0]))


def main():
    try:
        import vot
    except ImportError:
        raise SystemExit("the `vot` toolkit package is not installed in this "
                         "environment; UninextVOTTracker is importable for "
                         "use with any initialize/track harness")
    handle = vot.VOT("rectangle")
    region = handle.region()
    tracker = UninextVOTTracker()
    imagefile = handle.frame()
    import PIL.Image
    tracker.initialize(np.asarray(PIL.Image.open(imagefile)),
                       [region.x, region.y, region.width, region.height])
    while True:
        imagefile = handle.frame()
        if not imagefile:
            break
        box, conf = tracker.track(np.asarray(PIL.Image.open(imagefile)))
        handle.report(vot.Rectangle(*box), conf)


if __name__ == "__main__":
    main()
