"""Merge the two halves of a frontier (an FPS half and an AP half, e.g. from
two runs of `tools/frontier_sweep.py --mode fps` and `--mode ap`), compute
the paired AP deltas and the promoted protocol, and print the markdown
table: the port of `tools/frontier_merge.py`, writing one file of
`frontier_sweep`'s schema.

    python -m uninext_tpu_torch.tools.frontier_merge
        [--fps build/frontier/FRONTIER.json] [--ap build/frontier/FRONTIER_ap.json]
        [--out build/frontier/FRONTIER.json]
"""
from __future__ import annotations

import argparse
import json
import os

from .frontier_sweep import promote

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = os.path.join(REPO, "build", "frontier")


def merge(fps: dict, apd: dict = None, ap_file: str = None) -> dict:
    """The FPS half with the AP half's measurements merged in, the deltas
    against the base protocol and the promoted point (`frontier_sweep.
    promote`)."""
    merged = dict(fps)
    protos = merged.get("protocols", {})
    if apd is not None:
        for name, v in apd.get("protocols", {}).items():
            dst = protos.setdefault(name, {})
            # protocol identity: filled only where absent (the FPS half is
            # its source of truth); measurements: the AP half always wins
            for k in ("num_queries", "enc_points", "dec_points", "res_scale"):
                if v.get(k) is not None:
                    dst.setdefault(k, v[k])
            for k in ("ap_bbox", "ap50_bbox", "ap_segm", "fixture_eval_res"):
                if v.get(k) is not None:
                    dst[k] = v[k]
        merged["ap_source"] = {"file": ap_file, "device": apd.get("device"),
                               "train_steps": apd.get("train_steps")}
    promoted = promote(protos)
    if promoted:
        merged["promoted"] = promoted
    merged["partial"] = False
    return merged


def table(merged: dict) -> str:
    """The markdown table of the merged frontier."""
    lines = ["| protocol | Q | enc/dec pts | res | FPS | x base | AP (fixture) | dAP |",
             "|---|---|---|---|---|---|---|---|"]
    for name, v in merged.get("protocols", {}).items():
        lines.append(f"| {name} | {v.get('num_queries')} "
                     f"| {v.get('enc_points')}/{v.get('dec_points')} "
                     f"| {v.get('res_scale')} | {v.get('fps_det', '—')} "
                     f"| {v.get('speedup_vs_base_protocol', '—')} "
                     f"| {v.get('ap_bbox', '—')} "
                     f"| {v.get('ap_delta_vs_base', '—')} |")
    if merged.get("promoted"):
        lines.append(f"\npromoted: {merged['promoted']['name']}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fps", default=os.path.join(BUILD, "FRONTIER.json"))
    ap.add_argument("--ap", default=os.path.join(BUILD, "FRONTIER_ap.json"))
    ap.add_argument("--out", default=os.path.join(BUILD, "FRONTIER.json"))
    args = ap.parse_args(argv)
    with open(args.fps) as f:
        fps = json.load(f)
    apd = None
    if os.path.exists(args.ap):
        with open(args.ap) as f:
            apd = json.load(f)
    merged = merge(fps, apd, os.path.basename(args.ap))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print(table(merged))
    print(f"[done] wrote {args.out}")
    return merged


if __name__ == "__main__":
    main()
