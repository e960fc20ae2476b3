"""Offline SOT result analysis, the port of `tools/analyze_sot_results.py`
(the reference's tools_bin/analysis_results.py): reads a directory of
`<vid>.txt` files (x,y,w,h per line, as `eval_video --task sot` writes them)
for each tracker, pairs them with the ground truth (a LaSOT layout, or a
cocovid json with `--json`) and prints AUC / P / Pnorm per tracker with the
mean per-frame time of the `<vid>_time.txt` files.

    python -m uninext_tpu_torch.tools.analyze_sot_results --results out/a out/b \\
        --data-root datasets/LaSOT [--json TNL-2K/test.json]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..evaluation.sot_eval import evaluate_sot_dataset


def load_gt(args):
    """{video_name: (gt_xywh (T, 4), visible (T,) or None)}."""
    gts = {}
    if args.json:
        from ..data.video import load_ytvis_json
        recs, _ = load_ytvis_json(args.json, args.data_root)
        for r in recs:
            t = r["tracks"][0]
            boxes = np.array([b if b is not None else [0, 0, 0, 0]
                              for b in t["bboxes"]], np.float32)
            vis = np.array([b is not None for b in t["bboxes"]])
            name = os.path.basename(os.path.dirname(r["file_names"][0])) or \
                f"vid{r['video_id']}"
            gts[name] = (boxes, vis)
        return gts
    from ..data.sot_datasets import load_lasot
    for seq in load_lasot(args.data_root):
        gts[seq["name"]] = (np.asarray(seq["gt_xywh"], np.float32), seq.get("visible"))
    return gts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", nargs="+", required=True,
                    help="one directory of <vid>.txt files per tracker")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--json", default=None,
                    help="cocovid gt json (TNL-2K/GOT10k-style) instead of a LaSOT layout")
    args = ap.parse_args(argv)
    gts = load_gt(args)
    if not gts:
        raise SystemExit(f"no ground truth found under {args.data_root}")

    print(f"{'tracker':30s} {'#seq':>5s} {'AUC':>7s} {'P':>7s} "
          f"{'Pnorm':>7s} {'ms/frame':>9s}")
    for rd in args.results:
        per_seq, times = {}, []
        for f in glob.glob(os.path.join(rd, "*.txt")):
            name = os.path.splitext(os.path.basename(f))[0]
            if name.endswith("_time") or name not in gts:
                continue
            pred = np.loadtxt(f, delimiter=",", ndmin=2)
            gt, vis = gts[name]
            n = min(len(pred), len(gt))
            per_seq[name] = {"pred": pred[:n], "gt": gt[:n],
                             "visible": None if vis is None else vis[:n]}
            tf = os.path.join(rd, f"{name}_time.txt")
            if os.path.exists(tf):
                times.extend(np.loadtxt(tf, ndmin=1).tolist())
        if not per_seq:
            print(f"{os.path.basename(rd.rstrip('/')):30s} {0:5d}     (no "
                  "matching sequences)")
            continue
        m = evaluate_sot_dataset(per_seq)
        t_ms = 1000 * float(np.mean(times)) if times else float("nan")
        print(f"{os.path.basename(rd.rstrip('/')):30s} {len(per_seq):5d} "
              f"{m['AUC']:7.3f} {m['P']:7.3f} {m['Pnorm']:7.3f} {t_ms:9.1f}")


if __name__ == "__main__":
    main()
