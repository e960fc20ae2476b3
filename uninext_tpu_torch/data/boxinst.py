"""A copy of `uninext_tpu/data/boxinst.py` (the port imports nothing of the
JAX package): BoxInst's host-side targets, LAB colour similarity and box
bitmasks, in numpy, bit-equal to the JAX package's.

BoxInst host-side preprocessing: LAB color similarity + box bitmasks.

Parity (reference uninext_img.py):
  * prepare_image_targets_boxinst :529  — bottom BOTTOM_PIXELS_REMOVED rows
    of the image-validity mask cleared, scaled by resized/original height
    (the bitmasks are NOT clipped — bottom removal acts only through the
    color-similarity weights)
  * add_bitmasks_from_boxes :563 — images avg-pooled 4x4 (with padding),
    truncated to uint8, converted to CIELAB, then
    get_images_color_similarity :642 = exp(-||LAB diff||2 * 0.5) over the 8
    dilated neighbors x the unfolded validity mask; bitmasks rasterized at
    FULL resolution over [int(y0), int(y1+1)) x [int(x0), int(x1+1)) and
    sampled at [stride//2::stride].
"""
from __future__ import annotations

import numpy as np


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """rgb uint8/float (..., 3) in [0,255] -> CIELAB float (..., 3).

    Same D65 sRGB pipeline as skimage.color.rgb2lab (the reference's
    converter); validated against standard constants in tests/test_boxinst.py.
    """
    rgb = np.asarray(rgb, np.float64) / 255.0
    mask = rgb > 0.04045
    rgb = np.where(mask, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = rgb @ M.T
    xyz /= np.array([0.95047, 1.0, 1.08883])
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], -1).astype(np.float32)


def _unfold_wo_center_np(x: np.ndarray, k: int = 3, d: int = 2) -> np.ndarray:
    """x: (C, H, W) -> (C, 8, H, W) zero-padded dilated neighbors
    (reference unfold_wo_center, uninext_img.py:616)."""
    pad = (k + (d - 1) * (k - 1)) // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    H, W = x.shape[-2:]
    outs = []
    for dy in range(k):
        for dx in range(k):
            if dy == k // 2 and dx == k // 2:
                continue
            outs.append(xp[:, dy * d:dy * d + H, dx * d:dx * d + W])
    return np.stack(outs, axis=1)


def downsample_to_lab(image_rgb: np.ndarray, stride: int = 4) -> np.ndarray:
    """Padded image (H, W, 3) [0,255] -> LAB (H//stride, W//stride, 3).

    Reference add_bitmasks_from_boxes :571-578: stride x stride average
    pooling, truncation to uint8 (torch .byte()), then rgb2lab."""
    H, W, _ = image_rgb.shape
    h, w = H // stride, W // stride
    pooled = image_rgb[:h * stride, :w * stride].reshape(
        h, stride, w, stride, 3).mean(axis=(1, 3))
    pooled = pooled.astype(np.uint8)          # .byte() truncates
    return rgb_to_lab(pooled)


def color_similarity_from_lab(lab: np.ndarray, valid_s: np.ndarray,
                              kernel_size: int = 3, dilation: int = 2
                              ) -> np.ndarray:
    """lab (h, w, 3); valid_s (h, w) 1=usable pixel (inside image, above the
    bottom-removed band), already at mask stride. -> (8, h, w).

    Reference get_images_color_similarity (uninext_img.py:642)."""
    lab_chw = lab.transpose(2, 0, 1)
    un = _unfold_wo_center_np(lab_chw, kernel_size, dilation)   # (3, 8, h, w)
    diff = lab_chw[:, None] - un
    sim = np.exp(-np.linalg.norm(diff, axis=0) * 0.5)           # (8, h, w)
    un_m = _unfold_wo_center_np(valid_s[None].astype(np.float32),
                                kernel_size, dilation)[0]
    return (sim * un_m).astype(np.float32)


def color_similarity(image_rgb: np.ndarray, valid_mask: np.ndarray,
                     stride: int = 4, kernel_size: int = 3,
                     dilation: int = 2) -> np.ndarray:
    """image_rgb (H, W, 3) [0,255] PADDED to the bucket; valid_mask (H, W)
    1=usable (image area minus the bottom-removed band), 0=padding.
    Returns (8, H//stride, W//stride) neighbor similarities."""
    lab = downsample_to_lab(image_rgb, stride)
    s = stride
    valid_s = valid_mask[s // 2::s, s // 2::s][:lab.shape[0], :lab.shape[1]]
    return color_similarity_from_lab(lab, valid_s, kernel_size, dilation)


def boxes_to_bitmasks(boxes_xyxy: np.ndarray, valid: np.ndarray,
                      Hb: int, Wb: int, stride: int = 4) -> np.ndarray:
    """(G, 4) xyxy in padded-image pixels -> (G, Hb//stride, Wb//stride).

    Reference-exact: full-resolution raster over rows [int(y0), int(y1+1))
    and cols [int(x0), int(x1+1)) (uninext_img.py:589-593), sampled at
    [stride//2::stride] (get_target_masks mask-stride sampling). Bottom
    removal does NOT clip the bitmasks in the reference."""
    G = len(boxes_xyxy)
    h, w = Hb // stride, Wb // stride
    ys = (np.arange(h) * stride + stride // 2)
    xs = (np.arange(w) * stride + stride // 2)
    out = np.zeros((G, h, w), np.float32)
    for g in range(G):
        if not valid[g]:
            continue
        x0, y0, x1, y1 = boxes_xyxy[g]
        ylo, yhi = int(y0), int(y1 + 1)
        xlo, xhi = int(x0), int(x1 + 1)
        out[g] = ((ys[:, None] >= ylo) & (ys[:, None] < yhi)
                  & (xs[None, :] >= xlo) & (xs[None, :] < xhi))
    return out
