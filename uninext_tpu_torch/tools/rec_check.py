"""REC and RES scores of the small config trained from scratch on the in-repo
mini-RefCOCO fixture: the protocol of `tools/real_rec_check.py` on the port.

    python -m uninext_tpu_torch.tools.rec_check [--seeds 3] [--steps 1000]
        [--out build/rec_check/tiny.json] [--device cuda]

mini-RefCOCO JPEGs and json (`data/mini_coco.py:make_mini_refcoco`: one
expression grounds one shape by category and side) -> `load_refcoco_json`
-> `UniDatasetMapper` (LSJ into a 224 canvas, scale 0.6-1.4, masks) ->
`MultiDatasetLoader` (bs=2, 2 threads, the batches routed to "grounding",
seeded with the run's seed) -> `Trainer(task="grounding")` -> on the val
expressions `evaluate_refcoco` (the top-1 box: P@0.5 and oIoU) and
`evaluate_res` (its mask: P@0.5, mIoU, oIoU).

The config is `tools/evidence.py:build_tiny_cfg(steps, 224, 352)`, the JAX
tool's `build_cfg`. As in the other fixture tools, seed s seeds the loader
(the order of the expressions and their augmentation) and the weights are
the same for every seed (seed 0).

The JSON written to `--out` holds, per seed, the REC and RES metrics, the
step times (host clock to the end of each step's device work), the seconds
of training and evaluation and the peak device memory, with the device's
name and power limit. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from ..data.coco import UniDatasetMapper, load_refcoco_json
from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_refcoco
from ..data.tokenizer import BertTokenizer
from ..engine.evaluator import evaluate_refcoco, evaluate_res
from ..engine.trainer import Trainer
from .ap_check import LSJ, REPO, StepLog, card
from .evidence import build_tiny_cfg, finite, peak_gib, step_summary


def build_cfg(steps: int):
    """`tools/real_rec_check.py:build_cfg`: `build_tiny_cfg` at 224-352."""
    return build_tiny_cfg(steps, 224, 352)


def score(model, val_recs, mapper):
    """(REC metrics, RES metrics) of every val expression."""
    with torch.inference_mode():
        return (finite(evaluate_refcoco(model.eval(), val_recs, mapper)),
                finite(evaluate_res(model, val_recs, mapper)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="default: build/rec_check/tiny.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rec_check: no CUDA device (pass --device cpu for the CPU)")
    out = Path(args.out or REPO / "build" / "rec_check" / "tiny.json")
    cfg = build_cfg(args.steps)
    tok = BertTokenizer()
    per_seed = []
    with tempfile.TemporaryDirectory(prefix="mini_refcoco_") as root:
        paths = make_mini_refcoco(os.path.join(root, "data"), n_train=args.n_train,
                                  n_val=args.n_val)
        train_recs = load_refcoco_json(paths["train_json"], paths["train_root"])
        val_recs = load_refcoco_json(paths["val_json"], paths["val_root"])
        mapper = UniDatasetMapper(cfg.data, ["object"], tok, is_train=True, with_masks=True,
                                  **LSJ)
        eval_mapper = UniDatasetMapper(cfg.data, ["object"], tok, is_train=False,
                                       with_masks=False)
        for seed in range(args.first_seed, args.first_seed + args.seeds):
            batches = iter(MultiDatasetLoader([(train_recs, mapper, 2, "grounding")], [1.0],
                                              seed=seed, num_workers=2))
            timer = StepLog()
            trainer = Trainer(cfg, batches, output_dir=os.path.join(root, f"run{seed}"),
                              task="grounding", has_masks=True, device=device, seed=0,
                              log_period=50, extra_hooks=[timer])
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            trainer.train()
            train_s = time.perf_counter() - t0
            batches.close()             # stops the loader's mapping threads
            peak = peak_gib(device)
            t0 = time.perf_counter()
            rec, res = score(trainer.model, val_recs, eval_mapper)
            eval_s = time.perf_counter() - t0
            per_seed.append({
                "seed": seed, "rec_p_at_50": rec.get("P@0.5"), "rec_oiou": rec.get("oIoU"),
                "res_mask_p_at_50": res.get("P@0.5"), "res_mask_miou": res.get("mIoU"),
                "res_mask_oiou": res.get("oIoU"), "rec": rec, "res": res,
                "train_seconds": train_s, "eval_seconds": eval_s,
                "step_ms": step_summary(timer.seconds),
                "final_total_loss": timer.total_loss[-1], "train_peak_gib": peak})
            print(f"[rec_check] seed {seed}: {args.steps} grounding steps in {train_s:.1f} s, "
                  f"REC {rec}, RES {res}", flush=True)
            del trainer
    payload = {
        "config": "tiny_test_config (build_tiny_cfg at 224-352), trained from scratch",
        "device": card(device), "steps": args.steps,
        "n_train_expr": len(train_recs), "n_val_expr": len(val_recs),
        "pipeline": "jpeg->expression mapper->Trainer(grounding)->"
                    "evaluate_refcoco(P@0.5/oIoU)+evaluate_res(mask P@0.5/mIoU/oIoU)",
        "per_seed": per_seed}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
