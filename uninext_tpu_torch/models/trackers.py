"""A copy of `uninext_tpu/models/trackers.py` (the port imports nothing of
the JAX package).

Host-side association trackers (numpy) — tiny per-frame state machines.

Parity anchors (reference models/tracker.py):
  * IDOL_Tracker            — :50-301 (VIS: pre mask-NMS, bisoftmax matching
    vs tracklet memory, frame/temporal weighting, long-term weighted embeds,
    momentum updates, backdrops, post mask-NMS for new-track gating)
  * QuasiDenseEmbedTracker  — :304-503 (BDD MOT/MOTS: score-sorted box NMS
    with backdrop/class thresholds, bisoftmax + category gating, backdrops)

These run on the host between per-frame model passes; their state is a
handful of KB, exactly as in the reference (SURVEY §5 long-context note).
All tensor math is numpy; the device never blocks on them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ar_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(ar_a[:, None] + ar_b[None] - inter, 1e-9)


def mask_iou_binary(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """(N,H,W) x (M,H,W) binary -> (N,M)."""
    a = m1.reshape(len(m1), -1).astype(np.float32)
    b = m2.reshape(len(m2), -1).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None] - inter
    return (inter + 1e-6) / (union + 1e-6)


def mask_nms_keep(masks_bin: np.ndarray, thr: float) -> np.ndarray:
    """Greedy sequential mask NMS in given order. masks_bin: (N,H,W)."""
    n = len(masks_bin)
    keep = np.ones(n, bool)
    iou = mask_iou_binary(masks_bin, masks_bin)
    for i in range(n - 1):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if keep[j] and iou[i, j] > thr:
                keep[j] = False
    return keep


class IDOLTracker:
    """Online VIS tracker: embedding bisoftmax matching with tracklet memory."""

    def __init__(self, init_score_thr=0.2, addnew_score_thr=0.5,
                 obj_score_thr=0.1, match_score_thr=0.5,
                 memo_tracklet_frames=10, memo_momentum=0.5,
                 nms_thr_pre=0.5, nms_thr_post=0.05,
                 long_match=True, frame_weight=True, temporal_weight=True,
                 memory_len=3, match_metric="bisoftmax"):
        self.init_score_thr = init_score_thr
        self.addnew_score_thr = addnew_score_thr
        self.obj_score_thr = obj_score_thr
        self.match_score_thr = match_score_thr
        self.memo_tracklet_frames = memo_tracklet_frames
        self.memo_momentum = memo_momentum
        self.nms_thr_pre = nms_thr_pre
        self.nms_thr_post = nms_thr_post
        self.long_match = long_match
        self.frame_weight = frame_weight
        self.temporal_weight = temporal_weight
        self.memory_len = memory_len
        self.match_metric = match_metric
        self.num_tracklets = 0
        self.tracklets: Dict[int, Dict] = {}

    @property
    def empty(self) -> bool:
        return not self.tracklets

    def _memo(self):
        ids, embeds, exist = [], [], []
        for k, v in self.tracklets.items():
            ids.append(k)
            exist.append(v["exist_frame"])
            if self.long_match:
                w = np.asarray(v["long_score"], np.float32)
                if self.temporal_weight:
                    L = len(w)
                    w = w + np.arange(1, L + 1, dtype=np.float32) / L
                le = np.stack(v["long_embed"])
                embeds.append((le * w[:, None]).sum(0) / w.sum())
            else:
                embeds.append(v["embed"])
        return (np.asarray(ids), np.stack(embeds),
                np.asarray(exist, np.float32))

    def match(self, boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
              mask_logits: np.ndarray, embeds: np.ndarray, frame_id: int):
        """boxes (N,4) xyxy; scores (N,); labels (N,); mask_logits (N,h,w);
        embeds (N,C). Returns (keep_idx, track_ids) — track id -1 = dropped."""
        masks_bin = mask_logits > 0  # sigmoid > 0.5
        keep = mask_nms_keep(masks_bin, self.nms_thr_pre)
        keep_idx = np.flatnonzero(keep)
        boxes, scores = boxes[keep], scores[keep]
        labels, embeds = labels[keep], embeds[keep]
        masks_bin = masks_bin[keep]
        n = len(boxes)
        ids = np.full(n, -2, np.int64)

        if n > 0 and not self.empty:
            memo_ids, memo_embeds, memo_exist = self._memo()
            sim = embeds @ memo_embeds.T
            if self.match_metric == "bisoftmax":
                match_scores = (_softmax(sim, 1) + _softmax(sim, 0)) / 2
            elif self.match_metric == "softmax":
                match_scores = _softmax(sim, 1)
            else:
                a = embeds / np.maximum(
                    np.linalg.norm(embeds, axis=1, keepdims=True), 1e-9)
                b = memo_embeds / np.maximum(
                    np.linalg.norm(memo_embeds, axis=1, keepdims=True), 1e-9)
                match_scores = a @ b.T
            for i in range(n):
                row = match_scores[i].copy()
                if self.frame_weight:
                    strong = row > 0.5
                    if strong.sum() > 1:
                        w = memo_exist[strong]
                        row[strong] *= w
                        row[~strong] *= w.mean()
                memo_ind = int(row.argmax())
                conf = match_scores[i, memo_ind]
                if conf > self.match_score_thr:
                    ids[i] = memo_ids[memo_ind]
                    match_scores[:i, memo_ind] = 0
                    match_scores[i + 1:, memo_ind] = 0
            thr = self.addnew_score_thr
        else:
            thr = self.init_score_thr

        new = (ids == -2) & (scores > thr)
        ids[new] = np.arange(self.num_tracklets,
                             self.num_tracklets + new.sum())
        self.num_tracklets += int(new.sum())

        # unmatched low-score: keep as backdrop if not overlapping earlier dets
        unsel = np.flatnonzero(ids == -2)
        if len(unsel):
            ious = mask_iou_binary(masks_bin[unsel], masks_bin)
            for i, ind in enumerate(unsel):
                if (ious[i, :ind] < self.nms_thr_post).all():
                    ids[ind] = -1

        self._update(ids, boxes, scores, embeds, labels, frame_id)
        return keep_idx, ids

    def _update(self, ids, boxes, scores, embeds, labels, frame_id):
        for i in np.flatnonzero(ids > -1):
            tid = int(ids[i])
            if tid in self.tracklets:
                t = self.tracklets[tid]
                t["embed"] = ((1 - self.memo_momentum) * t["embed"]
                              + self.memo_momentum * embeds[i])
                t["long_embed"].append(embeds[i])
                t["long_score"].append(scores[i])
                t["last_frame"] = frame_id
                t["exist_frame"] += 1
                if len(t["long_embed"]) > self.memory_len:
                    t["long_embed"].pop(0)
                    t["long_score"].pop(0)
            else:
                self.tracklets[tid] = dict(
                    embed=embeds[i], long_embed=[embeds[i]],
                    long_score=[scores[i]], last_frame=frame_id,
                    exist_frame=1)
        dead = [k for k, v in self.tracklets.items()
                if frame_id - v["last_frame"] >= self.memo_tracklet_frames]
        for k in dead:
            self.tracklets.pop(k)


class QuasiDenseTracker:
    """QDTrack-style MOT/MOTS tracker with backdrops + category gating."""

    def __init__(self, init_score_thr=0.5, obj_score_thr=0.3,
                 match_score_thr=0.5, memo_tracklet_frames=10,
                 memo_backdrop_frames=1, memo_momentum=0.8,
                 nms_conf_thr=0.5, nms_backdrop_iou_thr=0.3,
                 nms_class_iou_thr=0.7, with_cats=True,
                 match_metric="bisoftmax"):
        self.init_score_thr = init_score_thr
        self.obj_score_thr = obj_score_thr
        self.match_score_thr = match_score_thr
        self.memo_tracklet_frames = memo_tracklet_frames
        self.memo_backdrop_frames = memo_backdrop_frames
        self.memo_momentum = memo_momentum
        self.nms_conf_thr = nms_conf_thr
        self.nms_backdrop_iou_thr = nms_backdrop_iou_thr
        self.nms_class_iou_thr = nms_class_iou_thr
        self.with_cats = with_cats
        self.match_metric = match_metric
        self.num_tracklets = 0
        self.tracklets: Dict[int, Dict] = {}
        self.backdrops: List[Dict] = []

    @property
    def empty(self) -> bool:
        return not self.tracklets

    def _memo(self):
        ids = [k for k in self.tracklets]
        embeds = [v["embed"] for v in self.tracklets.values()]
        labels = [v["label"] for v in self.tracklets.values()]
        for bd in self.backdrops:
            for e, l in zip(bd["embeds"], bd["labels"]):
                ids.append(-1)
                embeds.append(e)
                labels.append(l)
        return (np.asarray(ids), np.stack(embeds) if embeds else
                np.zeros((0, 1)), np.asarray(labels))

    def match(self, boxes, scores, labels, embeds, frame_id):
        """Returns (keep_idx into input order, ids) after score-sorted NMS."""
        order = np.argsort(-scores)
        boxes, scores = boxes[order], scores[order]
        labels, embeds = labels[order], embeds[order]
        ious = box_iou_xyxy(boxes, boxes)
        valid = np.ones(len(boxes), bool)
        for i in range(1, len(boxes)):
            thr = (self.nms_backdrop_iou_thr if scores[i] < self.obj_score_thr
                   else self.nms_class_iou_thr)
            if (ious[i, :i][valid[:i]] > thr).any():
                valid[i] = False
        keep_idx = order[valid]
        boxes, scores = boxes[valid], scores[valid]
        labels, embeds = labels[valid], embeds[valid]
        n = len(boxes)
        ids = np.full(n, -1, np.int64)

        if n > 0 and not self.empty:
            memo_ids, memo_embeds, memo_labels = self._memo()
            sim = embeds @ memo_embeds.T
            if self.match_metric == "bisoftmax":
                sc = (_softmax(sim, 1) + _softmax(sim, 0)) / 2
            elif self.match_metric == "softmax":
                sc = _softmax(sim, 1)
            else:
                a = embeds / np.maximum(
                    np.linalg.norm(embeds, axis=1, keepdims=True), 1e-9)
                b = memo_embeds / np.maximum(
                    np.linalg.norm(memo_embeds, axis=1, keepdims=True), 1e-9)
                sc = a @ b.T
            if self.with_cats:
                sc = sc * (labels[:, None] == memo_labels[None, :])
            for i in range(n):
                memo_ind = int(sc[i].argmax())
                conf = sc[i, memo_ind]
                if conf > self.match_score_thr and memo_ids[memo_ind] > -1:
                    if scores[i] > self.obj_score_thr:
                        ids[i] = memo_ids[memo_ind]
                        sc[:i, memo_ind] = 0
                        sc[i + 1:, memo_ind] = 0
                    elif conf > self.nms_conf_thr:
                        ids[i] = -2

        new = (ids == -1) & (scores > self.init_score_thr)
        ids[new] = np.arange(self.num_tracklets,
                             self.num_tracklets + new.sum())
        self.num_tracklets += int(new.sum())
        self._update(ids, boxes, scores, embeds, labels, frame_id)
        return keep_idx, ids

    def _update(self, ids, boxes, scores, embeds, labels, frame_id):
        for i in np.flatnonzero(ids > -1):
            tid = int(ids[i])
            if tid in self.tracklets:
                t = self.tracklets[tid]
                t["embed"] = ((1 - self.memo_momentum) * t["embed"]
                              + self.memo_momentum * embeds[i])
                t["last_frame"] = frame_id
                t["label"] = labels[i]
            else:
                self.tracklets[tid] = dict(embed=embeds[i], label=labels[i],
                                           last_frame=frame_id)
        bd = np.flatnonzero(ids == -1)
        if len(bd):
            ious = box_iou_xyxy(boxes[bd], boxes)
            keep_bd = [b for j, b in enumerate(bd)
                       if not (ious[j, :b] > self.nms_backdrop_iou_thr).any()]
            self.backdrops.insert(0, dict(
                embeds=[embeds[b] for b in keep_bd],
                labels=[labels[b] for b in keep_bd]))
        dead = [k for k, v in self.tracklets.items()
                if frame_id - v["last_frame"] >= self.memo_tracklet_frames]
        for k in dead:
            self.tracklets.pop(k)
        if len(self.backdrops) > self.memo_backdrop_frames:
            self.backdrops.pop()
