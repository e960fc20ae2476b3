"""A copy of `uninext_tpu/evaluation/mot_eval.py` (the port imports nothing
of the JAX package).

CLEAR-MOT metrics: MOTA, ID switches, FP/FN + IDF1.

Parity: reference data/datasets/mot.py:218 CLEAR-MOT eval helpers (the
official BDD100K scorer consumes the scalabel files we emit; this module
gives in-repo numbers). Standard protocol: per-frame Hungarian matching at
IoU>=0.5 with match carry-over preference; IDF1 via global id-pair
association counts.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / np.maximum(ar(a)[:, None] + ar(b)[None] - inter, 1e-9)


def evaluate_mot(gt_frames: List[Dict], pred_frames: List[Dict],
                 iou_thr: float = 0.5) -> Dict[str, float]:
    """Each frame dict: {"ids": (N,), "boxes": (N, 4) xyxy}.

    Returns MOTA, IDF1, IDS, FP, FN over one sequence."""
    n_gt = fp = fn = ids_sw = 0
    matches_prev: Dict[int, int] = {}       # gt id -> pred id
    # IDF1 accumulators
    pair_counts: Dict[tuple, int] = defaultdict(int)
    gt_counts: Dict[int, int] = defaultdict(int)
    pr_counts: Dict[int, int] = defaultdict(int)

    for gt, pr in zip(gt_frames, pred_frames):
        g_ids, g_boxes = np.asarray(gt["ids"]), np.asarray(gt["boxes"])
        p_ids, p_boxes = np.asarray(pr["ids"]), np.asarray(pr["boxes"])
        n_gt += len(g_ids)
        for gid in g_ids:
            gt_counts[int(gid)] += 1
        for pid in p_ids:
            pr_counts[int(pid)] += 1
        iou = _iou(g_boxes.astype(np.float64), p_boxes.astype(np.float64))
        # prefer carrying over previous matches (CLEAR-MOT)
        cost = 1.0 - iou
        for gi, gid in enumerate(g_ids):
            pid_prev = matches_prev.get(int(gid))
            if pid_prev is not None:
                pj = np.flatnonzero(p_ids == pid_prev)
                if len(pj) and iou[gi, pj[0]] >= iou_thr:
                    cost[gi, pj[0]] -= 1e-3
        cost = np.where(iou >= iou_thr, cost, 1e6)
        matched_g = set()
        matched_p = set()
        new_matches: Dict[int, int] = {}
        if len(g_ids) and len(p_ids):
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if iou[r, c] < iou_thr:
                    continue
                gid, pid = int(g_ids[r]), int(p_ids[c])
                matched_g.add(r)
                matched_p.add(c)
                new_matches[gid] = pid
                pair_counts[(gid, pid)] += 1
                if gid in matches_prev and matches_prev[gid] != pid:
                    ids_sw += 1
        fn += len(g_ids) - len(matched_g)
        fp += len(p_ids) - len(matched_p)
        matches_prev.update(new_matches)

    mota = 1.0 - (fp + fn + ids_sw) / max(n_gt, 1)
    # IDF1: optimal global gt-id <-> pred-id bijection maximizing overlap
    gids = sorted(gt_counts)
    pids = sorted(pr_counts)
    if gids and pids:
        overlap = np.zeros((len(gids), len(pids)))
        for (g, p), c in pair_counts.items():
            overlap[gids.index(g), pids.index(p)] = c
        rows, cols = linear_sum_assignment(-overlap)
        idtp = overlap[rows, cols].sum()
    else:
        idtp = 0
    total_gt = sum(gt_counts.values())
    total_pr = sum(pr_counts.values())
    idf1 = 2 * idtp / max(total_gt + total_pr, 1)
    # n_gt / IDTP / ID_total let callers POOL metrics across sequences
    # (the official scorers pool counts, not per-sequence means); per-sequence
    # id spaces are disjoint, so summing IDTP composes into the pooled
    # optimal bijection exactly.
    return {"MOTA": float(mota), "IDF1": float(idf1), "IDS": int(ids_sw),
            "FP": int(fp), "FN": int(fn), "n_gt": int(n_gt),
            "IDTP": float(idtp), "ID_total": int(total_gt + total_pr)}


def pool_mot_metrics(per_seq: List[Dict]) -> Dict[str, float]:
    """Pooled CLEAR-MOT over sequences from evaluate_mot outputs: sums the
    error counts and recomputes MOTA/IDF1 on the totals (matches how
    eval_bdd / the official scorers aggregate — short sequences no longer
    get equal weight to long ones)."""
    tot = {k: sum(m[k] for m in per_seq)
           for k in ("IDS", "FP", "FN", "n_gt", "IDTP", "ID_total")}
    mota = 1.0 - (tot["FP"] + tot["FN"] + tot["IDS"]) / max(tot["n_gt"], 1)
    idf1 = 2 * tot["IDTP"] / max(tot["ID_total"], 1)
    return {"MOTA": float(mota), "IDF1": float(idf1), "IDS": int(tot["IDS"]),
            "FP": int(tot["FP"]), "FN": int(tot["FN"]),
            "n_gt": int(tot["n_gt"])}
