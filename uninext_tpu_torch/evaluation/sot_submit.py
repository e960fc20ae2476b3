"""A copy of `uninext_tpu/evaluation/sot_submit.py` (the port imports nothing of the JAX package).

SOT eval-server submission packaging (GOT-10k / TrackingNet).

Parity: reference tools_bin/transform_got10k.py / transform_trackingnet.py —
both consume the per-video result files the SOT driver writes
(`<vid>.txt` x,y,w,h rows + `<vid>_time.txt` seconds,
uninext_vid.py:545-546; here `evaluation/sot_eval.py:save_sot_results`)
and repackage them into what each eval server ingests:

  * GOT-10k: one directory per sequence holding `<seq>_001.txt`
    (integer x,y,w,h, comma-separated — the server scores run 001) and the
    sequence's `<seq>_time.txt`, zipped.
  * TrackingNet: a flat directory of `<seq>.txt` integer comma-separated
    rows, zipped.

Files whose stem contains "all" (aggregate dumps) are skipped, like the
reference transforms do.
"""
from __future__ import annotations

import os
import shutil
import zipfile
from typing import List

import numpy as np


def _result_stems(src_dir: str) -> List[str]:
    stems = []
    for item in sorted(os.listdir(src_dir)):
        if not item.endswith(".txt") or item.endswith("_time.txt"):
            continue
        stem = item[:-4]
        if "all" in stem:
            continue
        stems.append(stem)
    if not stems:
        raise FileNotFoundError(f"no <vid>.txt result files in {src_dir}")
    return stems


def _load_int_boxes(path: str) -> np.ndarray:
    boxes = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    return np.rint(boxes).astype(np.int64)


def _zip_dir(dir_path: str) -> str:
    """Zip a directory's contents (paths relative to the dir root)."""
    zip_path = dir_path.rstrip("/") + ".zip"
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _, files in os.walk(dir_path):
            for f in sorted(files):
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, dir_path))
    return zip_path


def package_got10k_submission(src_dir: str, dest_dir: str | None = None,
                              keep_dir: bool = False) -> str:
    """GOT-10k layout: <seq>/<seq>_001.txt (int, comma) + <seq>_time.txt.

    Returns the zip path. The staging directory is removed unless
    `keep_dir` (the reference keeps it; we default to just the zip)."""
    dest_dir = dest_dir or os.path.join(
        os.path.dirname(src_dir.rstrip("/")) or ".", "GOT10K_submit")
    os.makedirs(dest_dir, exist_ok=True)
    for stem in _result_stems(src_dir):
        seq_dir = os.path.join(dest_dir, stem)
        os.makedirs(seq_dir, exist_ok=True)
        boxes = _load_int_boxes(os.path.join(src_dir, f"{stem}.txt"))
        np.savetxt(os.path.join(seq_dir, f"{stem}_001.txt"), boxes,
                   fmt="%d", delimiter=",")
        time_src = os.path.join(src_dir, f"{stem}_time.txt")
        if os.path.exists(time_src):
            shutil.copyfile(time_src,
                            os.path.join(seq_dir, f"{stem}_time.txt"))
    zip_path = _zip_dir(dest_dir)
    if not keep_dir:
        shutil.rmtree(dest_dir)
    return zip_path


def package_trackingnet_submission(src_dir: str, dest_dir: str | None = None,
                                   keep_dir: bool = False) -> str:
    """TrackingNet layout: flat <seq>.txt integer comma-separated rows."""
    dest_dir = dest_dir or os.path.join(
        os.path.dirname(src_dir.rstrip("/")) or ".", "TrackingNet_submit")
    os.makedirs(dest_dir, exist_ok=True)
    for stem in _result_stems(src_dir):
        boxes = _load_int_boxes(os.path.join(src_dir, f"{stem}.txt"))
        np.savetxt(os.path.join(dest_dir, f"{stem}.txt"), boxes,
                   fmt="%d", delimiter=",")
    zip_path = _zip_dir(dest_dir)
    if not keep_dir:
        shutil.rmtree(dest_dir)
    return zip_path
