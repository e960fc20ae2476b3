"""The SOT/VOS template machinery, mirroring `uninext_tpu/models/sot.py`:
annotation prompts as pseudo-language tokens.

    frame, target box [, gt mask] -> `crop_template`: a square crop of side
    ceil(sqrt(w*h) * factor) around the box, resized to template_size^2,
    with its pad mask and, for the 4-channel template backbone, a 4th
    channel (the gt mask, or the box region filled) ->
    `UninextDETR.encode_template` (`models/detr.py`): the template backbone,
    the input projections, `FeatureFuser` (P3-P6 summed at stride 8) or
    `resize_level` (each level to ref_feat_size^2, nearest), then
    `adjust_layer` to the language width.

Plain torch on the tensors' device; `crop_template` is one batched gather
over a fixed (template_size x template_size) grid, with no host round
trip.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import Conv2d
from .mask_head import aligned_bilinear


def _interp_taps(coords: torch.Tensor, size: torch.Tensor):
    """F.interpolate(bilinear, align_corners=False)'s taps along an axis of
    length `size` (per row of `coords`, (B, t)): the source coordinate
    clamps at 0 from below (its fraction becomes 0 there) and the tap
    indices at [0, size - 1]. Returns (lo, hi, frac)."""
    coords = coords.clamp(min=0.0)
    lo = coords.floor()
    frac = coords - lo
    last = size.long()[:, None] - 1
    lo_i = torch.minimum(lo.long().clamp(min=0), last)
    hi_i = torch.minimum(lo_i + 1, last)
    return lo_i, hi_i, frac


def crop_template(images: torch.Tensor, boxes_xyxy: torch.Tensor,
                  template_size: int = 256, search_area_factor: float = 2.0,
                  gt_masks: Optional[torch.Tensor] = None, mask_channel: bool = False,
                  pad_masks: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's template crop (ddetrs_vid_dn.py get_template :66-93,
    get_template_4c :95-139), as `uninext_tpu/models/sot.py:crop_template`:

      * the integer crop window: crop_sz = max(ceil(sqrt(w*h) * factor), 1),
        x1 = round(cx - crop_sz / 2) (half to even, as `jnp.round`), the
        window [x1, x1 + crop_sz) zero-padded, with the reference's quirk
        that content stops at min(x2, W - 1);
      * the padded crop resized to template_size^2 by bilinear taps that
        clamp at the crop's border;
      * the pad mask cropped the same way with pad value 1, resized, > 0;
      * with `mask_channel`, a 4th channel: the gt mask cropped with zero
        pad, or without one the box region of the crop set to 1 before the
        resize.

    images (B, H, W, 3) fp32; boxes_xyxy (B, 4) in pixels; gt_masks
    optional (B, H, W) in {0, 1}; pad_masks optional (B, H, W), True =
    pad. Returns (crop (B, t, t, 3 + mask_channel), pad (B, t, t) bool)."""
    B, H, W, _ = images.shape
    t = template_size
    dev = images.device
    boxes = boxes_xyxy.float()
    x0, y0, x1b, y1b = boxes.unbind(-1)
    w = x1b - x0
    h = y1b - y0
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * search_area_factor), min=1.0)
    xa = torch.round(x0 + 0.5 * w - crop_sz * 0.5)
    ya = torch.round(y0 + 0.5 * h - crop_sz * 0.5)
    xb = xa + crop_sz
    yb = ya + crop_sz
    u = ((torch.arange(t, dtype=torch.float32, device=dev) + 0.5)[None]
         * (crop_sz / t)[:, None] - 0.5)                        # (B, t)
    cy0, cy1, fy = _interp_taps(u, crop_sz)
    cx0, cx1, fx = _interp_taps(u, crop_sz)
    ya_i, xa_i = ya.long()[:, None], xa.long()[:, None]
    y_end = torch.clamp(yb.long(), max=H - 1)[:, None]
    x_end = torch.clamp(xb.long(), max=W - 1)[:, None]
    bidx = torch.arange(B, device=dev)[:, None, None]
    fyc, fxc = fy[:, :, None, None], fx[:, None, :, None]

    def sample(chan: torch.Tensor, fill: float) -> torch.Tensor:
        """chan (B, H, W, C) -> (B, t, t, C); `fill` inside the window where
        the image has no content."""
        def at(cy, cx):
            sy, sx = ya_i + cy, xa_i + cx
            vy = (sy >= 0) & (sy < y_end)
            vx = (sx >= 0) & (sx < x_end)
            v = chan[bidx, sy.clamp(0, H - 1)[:, :, None], sx.clamp(0, W - 1)[:, None, :]]
            ok = (vy[:, :, None] & vx[:, None, :])[..., None]
            return torch.where(ok, v, fill)

        return ((1 - fyc) * (1 - fxc) * at(cy0, cx0) + (1 - fyc) * fxc * at(cy0, cx1)
                + fyc * (1 - fxc) * at(cy1, cx0) + fyc * fxc * at(cy1, cx1))

    crop = sample(images.float(), 0.0)
    pm = (pad_masks if pad_masks is not None
          else torch.zeros((B, H, W), dtype=torch.bool, device=dev))
    pad = sample(pm.float()[..., None], 1.0)[..., 0] > 0
    if mask_channel:
        if gt_masks is not None:
            mc = sample(gt_masks.float()[..., None], 0.0)
        else:
            # the box region in crop coordinates set to 1 before the resize
            x1_t = torch.round(x0 - xa)[:, None]
            x2_t = x1_t + torch.round(w)[:, None]
            y1_t = torch.round(y0 - ya)[:, None]
            y2_t = y1_t + torch.round(h)[:, None]

            def boxat(cy, cx):
                inside = (((cy >= y1_t) & (cy < y2_t))[:, :, None]
                          & ((cx >= x1_t) & (cx < x2_t))[:, None, :])
                return inside.float()[..., None]

            mc = ((1 - fyc) * (1 - fxc) * boxat(cy0, cx0) + (1 - fyc) * fxc * boxat(cy0, cx1)
                  + fyc * (1 - fxc) * boxat(cy1, cx0) + fyc * fxc * boxat(cy1, cx1))
        crop = torch.cat([crop, mc.to(crop.dtype)], -1)
    return crop, pad


class FeatureFuser(nn.Module):
    """SOT multi-level template fusion (reference ddetrs_vid.py:757-783,
    SOT.FEAT_FUSE): a 3x3 convolution per level (`refine.{i}`, in the
    compute dtype), `aligned_bilinear` up to the first level's size, sum."""

    def __init__(self, channels: int, num_levels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.refine = nn.ModuleList(Conv2d(channels, channels, 3, padding=1, dtype=dtype)
                                    for _ in range(num_levels))

    def forward(self, levels: Sequence[torch.Tensor]) -> torch.Tensor:
        """levels: (B, h_i, w_i, C) NHWC, finest first -> (B, h_0, w_0, C)."""
        out = None
        H0 = levels[0].shape[1]
        for conv, f in zip(self.refine, levels):
            x = conv(f)
            if x.shape[1] != H0:
                x = aligned_bilinear(x.permute(0, 3, 1, 2), H0 // x.shape[1]).permute(0, 2, 3, 1)
            out = x if out is None else out + x
        return out


def resize_level(x: torch.Tensor, out: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out, out, C), nearest: F.interpolate's default
    mode, which the reference uses for the per-level template resize
    (ddetrs_vid_dn.py:536); source index floor(i * in / out)."""
    H, W = x.shape[1:3]
    iy = torch.arange(out, device=x.device) * H // out
    ix = torch.arange(out, device=x.device) * W // out
    return x[:, iy][:, :, ix]

