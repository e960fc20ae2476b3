"""Tracker-threshold grid search over cached detections, the port of
`tools/grid_search_track.py` (the reference's tools_bin/grid_search_bdd.py
re-runs the whole model per grid point; here QDTrack association is apart
from detection, so the sweep re-runs only the host's association over each
sequence's cache and scores every point with CLEAR-MOT).

    python -m uninext_tpu_torch.tools.grid_search_track out/dets/*.npz \\
        --init 0.2:0.7:0.1 --obj 0.2:0.7:0.1 [--metric MOTA]

The caches are the npz files that `eval_video --task mot --dump-dets DIR`
writes (`tools/eval_video.py:save_detections`, one per sequence, with the
gt of a BDD labels json beside the frames), in the JAX tool's format, so a
cache of either tool loads in the other:

    n_frames, image_size (h, w), ori_size (h, w)
    select_thr ()                                # the floor the dets were cached at
    boxes_{i} (N, 4 xyxy), scores_{i} (N,), labels_{i} (N,), embeds_{i} (N, E)
    gt_ids_{i} (G,), gt_boxes_{i} (G, 4)         # gt, original pixels

Points with init <= obj are skipped, as in the reference's sweep; an obj
threshold below the caches' `select_thr` is refused (those detections are
not in the cache, so the point would score the same set again). The
metrics pool the CLEAR-MOT counts over the sequences. It runs on the host
only: the model's kernels (MSDA, NMS) ran in the pass that wrote the
caches.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..engine.mot_inference import associate
from ..evaluation.mot_eval import evaluate_mot, pool_mot_metrics
from .eval_video import save_detections  # noqa: F401  (the writer of the caches)


def load_detections(path):
    """A sequence's cache: (raw frames, image_size, ori_size, gt frames or
    None, select_thr)."""
    z = np.load(path)
    n = int(z["n_frames"])
    raw = [{k: z[f"{k}_{i}"] for k in ("boxes", "scores", "labels", "embeds")}
           for i in range(n)]
    gt = None
    if "gt_ids_0" in z:
        gt = [{"ids": z[f"gt_ids_{i}"], "boxes": z[f"gt_boxes_{i}"]} for i in range(n)]
    select_thr = float(z["select_thr"]) if "select_thr" in z else 0.0
    return raw, tuple(z["image_size"]), tuple(z["ori_size"]), gt, select_thr


def _parse_range(spec):
    """'0.2:0.7:0.1' -> [0.2, 0.3, ...]; a single float -> [v]."""
    parts = [float(p) for p in spec.split(":")]
    if len(parts) == 1:
        return parts
    lo, hi, step = parts
    return list(np.round(np.arange(lo, hi, step), 6))


def run_grid(seqs, init_thrs, obj_thrs, metric="MOTA", cache_select_thr=0.0):
    """seqs: [(raw frames, image_size, ori_size, gt frames)]. Returns (the
    entries sorted best first by `metric`, the best entry or None)."""
    bad = [o for o in obj_thrs if o < cache_select_thr - 1e-9]
    if bad:
        raise ValueError(
            f"obj thresholds {bad} are below the caches' select_thr "
            f"{cache_select_thr}: re-dump with a lower floor "
            f"(cfg.track.inference_select_thr) to sweep them")
    results = []
    for init_thr in init_thrs:
        for obj_thr in obj_thrs:
            if init_thr <= obj_thr:
                continue
            per_seq = []
            for raw, image_size, ori_size, gt in seqs:
                pred = associate(raw, image_size, ori_size, init_score_thr=init_thr,
                                 obj_score_thr=obj_thr)
                pred_frames = [{"ids": [d["id"] for d in dets],
                                "boxes": np.array([d["box_xyxy"] for d in dets]).reshape(-1, 4)}
                               for dets in pred]
                per_seq.append(evaluate_mot(gt, pred_frames))
            pooled = pool_mot_metrics(per_seq)
            results.append({"init_score_thr": init_thr, "obj_score_thr": obj_thr,
                            **{k: pooled[k] for k in ("MOTA", "IDF1", "IDS", "FP", "FN")}})
    results.sort(key=lambda e: -e[metric])
    return results, (results[0] if results else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("caches", nargs="+", help="per-sequence .npz caches")
    ap.add_argument("--init", default="0.2:0.7:0.1", help="init_score_thr range lo:hi:step")
    ap.add_argument("--obj", default="0.2:0.7:0.1", help="obj_score_thr range lo:hi:step")
    ap.add_argument("--metric", default="MOTA", choices=("MOTA", "IDF1"))
    args = ap.parse_args(argv)

    seqs = []
    cache_thr = 0.0
    for path in args.caches:
        raw, image_size, ori_size, gt, sel = load_detections(path)
        if gt is None:
            raise SystemExit(f"{path} has no ground truth; dump with gt")
        cache_thr = max(cache_thr, sel)
        seqs.append((raw, image_size, ori_size, gt))

    results, best = run_grid(seqs, _parse_range(args.init), _parse_range(args.obj),
                             args.metric, cache_select_thr=cache_thr)
    print(f"{'init':>6} {'obj':>6} {'MOTA':>8} {'IDF1':>8} {'IDS':>5} {'FP':>5} {'FN':>5}")
    for e in results:
        print(f"{e['init_score_thr']:6.2f} {e['obj_score_thr']:6.2f} {e['MOTA']:8.4f} "
              f"{e['IDF1']:8.4f} {e['IDS']:5d} {e['FP']:5d} {e['FN']:5d}")
    if best:
        print(f"best ({args.metric}): init={best['init_score_thr']:.2f} "
              f"obj={best['obj_score_thr']:.2f} {args.metric}={best[args.metric]:.4f}")
    return results, best


if __name__ == "__main__":
    main()
