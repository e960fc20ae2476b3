"""Eval-protocol accuracy <-> speed frontier of the image config, the port of
`tools/frontier_sweep.py`.

The same trained weights serve under cheaper eval protocols through
`engine/protocol.py`'s cut:

  * query count: two-stage top-k is an eval knob (the reference's
    single-task configs ship 300, the joint models 900;
    uninext/config.py:160);
  * sampling points: DEC_N_POINTS / ENC_N_POINTS (uninext/config.py
    :163-164);
  * eval resolution: MIN_SIZE_TEST (800 for images).

Two paired measurements per protocol:

  AP:  train `image_joint_r50` once on the mini-COCO fixture through the
       port's `Trainer` (`tools/ap_check.py:build_cfg` and `fixture`), then
       evaluate the same weights under every protocol with
       `DetectionEvaluator` (paired deltas: the evaluation is deterministic
       given the weights), and segm AP for the base and the promoted point.
       Resolution knobs scale the fixture's 224 px evaluation by the same
       fractions as the serving points.
  FPS: `image_joint_r50` at full width with random weights from `--seed`
       (and `serve_throughput.SAMPLING_NOISE` on the MSDA sampling
       projections, `perturb_sampling`) serves each protocol at its serving
       shape (800/736/672/608 shortest side): the COCO prompt encoded once,
       one request = forward + `postprocess_detection` at bs=1 on the host
       clock up to `torch.cuda.synchronize()`. After each protocol's first
       request and `serve_throughput.WARMUP` more, the `--requests` timed
       rounds go round-robin over the protocols, so that a drift in the
       host's pace lands on all of them alike; median and range per
       protocol, with the MSDA and NMS launches per request.

    python -m uninext_tpu_torch.tools.frontier_sweep [--mode ap|fps|both]
        [--steps 2000] [--n-train 32] [--n-val 48] [--requests 20]
        [--seed 0] [--device cuda|cpu] [--out build/frontier/FRONTIER.json]
    python -m uninext_tpu_torch.tools.frontier_sweep --smoke --steps 2 \\
        --n-train 2 --n-val 1 --requests 1 --hw 64 96 --device cpu

`--smoke` checks the flow on `tiny_test_config` (60 queries) with three
protocols (60/40 queries): its numbers are no evidence. `--hw` sets the
800x1216 bucket the FPS half scales. The JAX tool's `FRONTIER.json` in the
repository root is its TPU record and stays as it is.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from .cli_common import add_device_arg, device_of

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, num_queries, enc_points, dec_points, res_scale)
# res_scale multiplies the serving shortest side (800 -> 736/672/608) and
# the fixture eval size (224 -> 208/192/176, rounded to /16).
PROTOCOLS = [
    ("base_900q_p44_800px",   900, 4, 4, 1.00),
    ("res736",                900, 4, 4, 0.92),
    ("res672",                900, 4, 4, 0.84),
    ("res608",                900, 4, 4, 0.76),
    ("q600",                  600, 4, 4, 1.00),
    ("q300",                  300, 4, 4, 1.00),
    ("dec2",                  900, 4, 2, 1.00),
    ("enc2",                  900, 2, 4, 1.00),
    ("enc2_dec2",             900, 2, 2, 1.00),
    ("q300_res672",           300, 4, 4, 0.84),
    ("q300_res608",           300, 4, 4, 0.76),
    ("q300_p22",              300, 2, 2, 1.00),
    ("q300_p22_res672",       300, 2, 2, 0.84),
    ("q300_p22_res608",       300, 2, 2, 0.76),
]
SMOKE_PROTOCOLS = [
    ("base_900q_p44_800px", 60, 4, 4, 1.00),
    ("q300", 40, 4, 4, 1.00),
    ("q300_p22_res608", 40, 2, 2, 0.76),
]
BASE = "base_900q_p44_800px"


def serving_shape(scale: float, hw=(800, 1216)):
    """800x1216 worst-case bucket scaled, rounded up to /32."""
    def r32(x):
        return int(-(-x // 32) * 32)
    return r32(hw[0] * scale), r32(hw[1] * scale)


def fixture_res(scale: float):
    def r16(x):
        return int(-(-x // 16) * 16)
    return r16(224 * scale), r16(352 * scale)


def _finite(x):
    return None if not np.isfinite(x) else round(float(x), 4)


def _entry(results, name, q, ep, dp, scale):
    return results.setdefault(name, {"num_queries": q, "enc_points": ep,
                                     "dec_points": dp, "res_scale": scale})


def run_ap(args, results, device, protocols):
    """Train once on the fixture, then bbox AP under every protocol and segm
    AP for the base and the promoted point."""
    from ..data.coco import UniDatasetMapper
    from ..engine.evaluator import DetectionEvaluator
    from ..engine.protocol import adapted_model
    from ..engine.trainer import Trainer
    from .ap_check import build_cfg, fixture

    cfg = build_cfg(args.steps, flagship=not args.smoke)
    with tempfile.TemporaryDirectory(prefix="mini_coco_frontier_") as tmp:
        loader, val_recs, mapper, cmap = fixture(args.data_root or tmp, cfg, args.n_train,
                                                 args.n_val)
        batches = iter(loader)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, batches, output_dir=os.path.join(tmp, "run"),
                          task="detection", has_masks=True, device=device, seed=args.seed,
                          log_period=100)
        trainer.train()
        batches.close()             # stops the loader's mapping threads
        print(f"[train] {args.steps} steps in {time.perf_counter() - t0:.1f} s", flush=True)
        state = trainer.model.state_dict()
        del trainer
        by_name = {p[0]: p for p in protocols}

        def evaluate(name, with_masks):
            _, q, ep, dp, scale = by_name[name]
            h, w = fixture_res(scale)
            cfg_p = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, min_size_test=h, max_size_test=w))
            model, cfg_p = adapted_model(state, cfg_p, num_queries=q, enc_n_points=ep,
                                         dec_n_points=dp, device=device)
            eval_mapper = UniDatasetMapper(cfg_p.data, mapper.categories, mapper.tok,
                                           is_train=False, with_masks=True)
            ev = DetectionEvaluator(model, cfg_p, cmap, with_masks=with_masks)
            return ev.evaluate(val_recs, eval_mapper, score_thr=0.05), (h, w)

        for (name, q, ep, dp, scale) in protocols:
            t0 = time.perf_counter()
            res, (h, w) = evaluate(name, with_masks=False)
            entry = _entry(results, name, q, ep, dp, scale)
            entry["ap_bbox"] = _finite(res["AP"])
            entry["ap50_bbox"] = _finite(res["AP50"])
            entry["fixture_eval_res"] = [h, w]
            print(f"[ap] {name}: AP={entry['ap_bbox']} AP50={entry['ap50_bbox']} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            save(args, results, partial=True)

        # segm AP for the base and the would-be promoted point only
        prom = save(args, results, partial=True).get("promoted")
        for name in [BASE] + ([prom["name"]] if prom and prom["name"] != BASE else []):
            res, _ = evaluate(name, with_masks=True)
            results[name]["ap_segm"] = _finite(res["AP"])
            print(f"[ap-segm] {name}: {results[name]['ap_segm']}", flush=True)
            save(args, results, partial=True)


def run_fps(args, results, device, protocols):
    """Serve every protocol at its serving shape, bs=1, the timed requests
    round-robin over the protocols."""
    from ..config import image_joint_r50
    from ..engine.protocol import adapted_model
    from ..models.detr import build_model
    from .ap_check import build_cfg
    from .serve_throughput import (SAMPLING_NOISE, WARMUP, coco_prompt, perturb_sampling,
                                   random_images, request, summarize)

    cfg = build_cfg(args.steps, flagship=False) if args.smoke else image_joint_r50()
    base = build_model(cfg, device, seed=args.seed)
    perturb_sampling(base, SAMPLING_NOISE, args.seed)
    lang, cmap = coco_prompt(base, device)
    served = []
    for (name, q, ep, dp, scale) in protocols:
        H, W = serving_shape(scale, args.hw)
        model, _ = adapted_model(base, cfg, num_queries=q, enc_n_points=ep,
                                 dec_n_points=dp, device=device)
        inputs = random_images(1, H, W, args.seed, device)
        first = request(model, inputs, lang, cmap)
        for _ in range(WARMUP):
            request(model, inputs, lang, cmap)
        served.append((model, inputs, first, []))
    for _ in range(args.requests):
        for model, inputs, _, timed in served:
            timed.append(request(model, inputs, lang, cmap))
    base_fps = None
    for (name, q, ep, dp, scale), (_, inputs, first, timed) in zip(protocols, served):
        r = summarize(first, timed)
        H, W = inputs[0].shape[1:3]
        med = float(np.median(r["ms"]))
        fps = 1e3 / med
        if name == BASE:
            base_fps = fps
        entry = _entry(results, name, q, ep, dp, scale)
        entry["fps_det"] = round(fps, 3)
        entry["serving_shape"] = [H, W]
        if base_fps:
            entry["speedup_vs_base_protocol"] = round(fps / base_fps, 3)
        entry["request_ms"] = {"median": med, "min": min(r["ms"]), "max": max(r["ms"]),
                               "requests": len(r["ms"]), "first_s": r["first_s"]}
        entry["msda_launches_per_request"] = r["msda_per_request"]
        entry["nms_launches_per_request"] = r["nms_per_request"]
        print(f"[fps] {name} @{H}x{W}: {fps:.2f} FPS, median {med:.2f} ms "
              f"({min(r['ms']):.2f}-{max(r['ms']):.2f}) over {len(r['ms'])} requests; "
              f"MSDA {r['msda_per_request']:g} and NMS {r['nms_per_request']:g} "
              f"launches a request", flush=True)
    save(args, results, partial=True)


def promote(results: dict):
    """The paired AP deltas against the base protocol, written into
    `results`, and the promoted point: the fastest protocol whose delta is
    >= -0.015 (the val set is 48 images, so one borderline detection moves
    AP ~0.01). Returns {"name": ..., **entry} or None."""
    base = results.get(BASE, {})
    if base.get("ap_bbox") is not None:
        for v in results.values():
            if v.get("ap_bbox") is not None:
                v["ap_delta_vs_base"] = round(v["ap_bbox"] - base["ap_bbox"], 4)
    cands = [(k, v) for k, v in results.items()
             if v.get("fps_det") and v.get("ap_delta_vs_base") is not None
             and v["ap_delta_vs_base"] >= -0.015]
    if not cands:
        return None
    k, v = max(cands, key=lambda kv: kv[1]["fps_det"])
    return {"name": k, **v}


def save(args, results, partial=False):
    """Write the frontier with the paired AP deltas and the promoted point
    (`promote`). Returns what it wrote."""
    from .serve_throughput import SAMPLING_NOISE
    payload = {
        "description": "eval-protocol accuracy<->throughput frontier of the PyTorch "
                       "port: paired AP deltas on one trained flagship mini-coco "
                       "checkpoint x serving FPS at real 800px-class shapes",
        "reference_anchor": "NUM_OBJECT_QUERIES uninext/config.py:160 "
                            "(single-task=300), DEC/ENC_N_POINTS :163-164, "
                            "MIN_SIZE_TEST detectron2 defaults",
        "train_steps": args.steps, "n_train": args.n_train,
        "n_val": args.n_val, "device": args.card, "seed": args.seed,
        "requests": args.requests, "noise": SAMPLING_NOISE, "smoke": args.smoke,
        "partial": partial,
        "protocols": results,
    }
    promoted = promote(results)
    if promoted:
        payload["promoted"] = promoted
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="both", choices=["ap", "fps", "both"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=48)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hw", nargs=2, type=int, default=[800, 1216],
                    help="the serving bucket the FPS half scales")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "frontier", "FRONTIER.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="flow check: tiny preset (60 queries), reduced protocol list; "
                         "numbers are NOT evidence")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from .ap_check import card
    args.card = card(device)
    protocols = SMOKE_PROTOCOLS if args.smoke else PROTOCOLS

    results = {}
    if args.mode in ("fps", "both"):
        run_fps(args, results, device, protocols)
    if args.mode in ("ap", "both"):
        run_ap(args, results, device, protocols)
    payload = save(args, results)
    print(f"[done] wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
