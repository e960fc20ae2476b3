"""The COCO matching core in C++ (`cocoeval_cpp/cocoeval.cc`, a copy of the
JAX package's source), bound with ctypes, and its plain numpy version.

The library is built with `g++` at first use, from the source in the
checkout, into `build/uninext_tpu_torch/` at the repository root, under a
name that carries a hash of the source and flags (as `ops/_build.py` names
the CUDA libraries). A failed build or load raises: the numpy matcher is
the plain version the tests hold the C++ one against, never a silent
substitute.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cocoeval_cpp" / "cocoeval.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uninext_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libcocoeval-{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded matching library, built first if needed."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for cocoeval:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.coco_match.argtypes = [f32, ctypes.c_int, ctypes.c_int, u8, f32, ctypes.c_int,
                               u8, ctypes.POINTER(ctypes.c_int64), u8]
    lib.coco_match.restype = None
    return lib


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, thrs: np.ndarray,
               det_ignore_mask: np.ndarray):
    """Greedy COCO matching in C++. ious: (n_det, n_gt) with dets sorted by
    descending score and gts ignored-last. Returns (det_match (T, n_det)
    int64, the gt index or -1; det_ignore (T, n_det) uint8)."""
    n_det, n_gt = ious.shape
    T = len(thrs)
    det_match = np.empty((T, n_det), np.int64)
    det_ignore = np.empty((T, n_det), np.uint8)
    if n_det == 0:
        return det_match, det_ignore
    ious_c = np.ascontiguousarray(ious, np.float32)
    gt_ig = np.ascontiguousarray(gt_ignore, np.uint8)
    thrs_c = np.ascontiguousarray(thrs, np.float32)
    dim = np.ascontiguousarray(det_ignore_mask, np.uint8)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    library().coco_match(ptr(ious_c, ctypes.c_float), n_det, n_gt,
                         ptr(gt_ig, ctypes.c_uint8), ptr(thrs_c, ctypes.c_float), T,
                         ptr(dim, ctypes.c_uint8), ptr(det_match, ctypes.c_int64),
                         ptr(det_ignore, ctypes.c_uint8))
    return det_match, det_ignore


def coco_match_numpy(ious: np.ndarray, gt_ignore: np.ndarray, thrs: np.ndarray,
                     det_ignore_mask: np.ndarray):
    """The plain version of `coco_match`: the same algorithm in Python."""
    n_det, n_gt = ious.shape
    T = len(thrs)
    det_match = np.empty((T, n_det), np.int64)
    det_ignore = np.empty((T, n_det), np.uint8)
    for t, thr in enumerate(thrs):
        taken = np.zeros(n_gt, bool)
        for d in range(n_det):
            best, best_iou = -1, max(thr, 1e-10)
            for g in range(n_gt):
                if taken[g]:
                    continue
                if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best, best_iou = g, ious[d, g]
            if best >= 0:
                taken[best] = True
                det_match[t, d] = best
                det_ignore[t, d] = gt_ignore[best]
            else:
                det_match[t, d] = -1
                det_ignore[t, d] = det_ignore_mask[d]
    return det_match, det_ignore
