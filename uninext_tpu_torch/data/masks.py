"""A copy of `uninext_tpu/data/masks.py` (the port imports nothing of the JAX
package).

Mask utilities: polygon rasterization + COCO-compatible RLE (host-side).

Replaces pycocotools (not a dependency) for the data pipeline and
evaluators. RLE layout matches the COCO convention: column-major (Fortran)
scan order, counts alternating background/foreground starting with background,
and the same LEB128-style string compression as pycocotools' `encode`, so our
result files remain consumable by the official scorers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from PIL import Image, ImageDraw


def polygons_to_mask(polygons: Sequence[Sequence[float]], height: int,
                     width: int) -> np.ndarray:
    """COCO polygon list -> (H, W) uint8 mask."""
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        if len(poly) >= 6:
            draw.polygon([(poly[i], poly[i + 1])
                          for i in range(0, len(poly), 2)], outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """(H, W) binary mask -> COCO RLE counts (column-major)."""
    flat = np.asfortranarray(mask).ravel(order="F").astype(bool)
    # run-length encode, starting with a background run (possibly length 0)
    counts = []
    pos = 0
    cur = False
    idx = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], idx, [flat.size]])
    runs = np.diff(boundaries)
    if flat.size and flat[0]:
        counts.append(0)
    counts.extend(runs.tolist())
    return counts


def rle_counts_to_mask(counts: Sequence[int], height: int,
                       width: int) -> np.ndarray:
    flat = np.zeros(height * width, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((height, width), order="F")


def encode_counts(counts: Sequence[int]) -> str:
    """pycocotools-compatible compressed RLE string."""
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
        if c & 0x10:
            x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> COCO-format RLE dict (compressed string)."""
    h, w = mask.shape
    return {"size": [h, w], "counts": encode_counts(mask_to_rle_counts(mask))}


def decode_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts(counts)
    return rle_counts_to_mask(counts, h, w)


def mask_iou(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """(N, H, W) x (M, H, W) -> (N, M) IoU."""
    a = masks1.reshape(len(masks1), -1).astype(np.float32)
    b = masks2.reshape(len(masks2), -1).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)
