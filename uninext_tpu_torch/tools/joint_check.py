"""One jointly trained video model scored on five task families: the protocol
of `tools/real_joint_check.py` on the port.

    python -m uninext_tpu_torch.tools.joint_check [--seeds 3] [--steps 2500]
        [--weights 0.45 0.15 0.2 0.2] [--out build/joint_check/tiny.json]
        [--device cuda]

Four mini-YTVIS datasets routed through one weighted loader (the stage-3
mixture of the reference's video_joint_r50 at fixture scale):

  * VIS pairs        (category prompt, the reid loss)    task "detection"
  * BDD-track pairs  (category prompt, 3-object crowds)  task "detection"
  * R-VOS pairs      (a referring expression)            task "grounding"
  * SOT pairs        (the first frame's template)        task "sot"

train one `Trainer(video=True)` (a routed loader: the state has every
branch), whose one checkpoint is then scored on VIS (`VISDriver`, track
mAP), MOT (`MOTDriver`, MOTA and IDF1), SOT (`SOTDriver`, AUC), VOS
(`VOSDriver`, J&F) and R-VOS (`RVOSDriver`, J&F).

The config is `tools/evidence.py:build_tiny_cfg(steps, frame_range=7,
use_reid=True)`, the JAX tool's. Seed s seeds the loader; the weights start
from seed 0.

The JSON written to `--out` holds, per seed, the seven scores, the batches
read of each task, the step times, the seconds of training and evaluation
and the peak device memory, with the device's name and power limit. Runs
on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_ytvis
from ..data.tokenizer import BertTokenizer
from ..data.video import VideoPairMapper, load_ytvis_json
from .ap_check import REPO, card
from .evidence import build_tiny_cfg, eval_mot, eval_rvos, finite
from .pipeline_check import Stage
from .sot_check import eval_sot_vos
from .vis_check import eval_vis


def build_cfg(steps: int):
    """`tools/real_joint_check.py`'s config: `build_tiny_cfg(steps,
    frame_range=7, use_reid=True)`."""
    return build_tiny_cfg(steps, frame_range=7, use_reid=True)


def fixtures(root, n_train=None, n_val=None):
    """The four datasets, as the JAX tool writes them: {name: (train, val,
    categories, val json)}."""
    n = {k: v for k, v in (("n_train", n_train), ("n_val", n_val)) if v is not None}
    specs = {"vis": dict(length=6, max_objects=2),
             "bdd": dict(length=8, max_objects=3, seed=23),
             "rvos": dict(length=6, max_objects=3, seed=37, referring=True),
             "sot": dict(length=8, max_objects=1, seed=11)}
    out = {}
    for name, kw in specs.items():
        paths = make_mini_ytvis(os.path.join(root, name), **kw, **n)
        expr = dict(has_expression=True) if name == "rvos" else {}
        train, cats = load_ytvis_json(paths["train_json"], paths["train_root"], **expr)
        val, _ = load_ytvis_json(paths["val_json"], paths["val_root"], **expr)
        out[name] = (train, val, cats, paths["val_json"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--weights", type=float, nargs=4, default=[0.45, 0.15, 0.2, 0.2],
                    metavar=("VIS", "BDD", "RVOS", "SOT"), help="mixture ratios")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=None,
                    help="train videos of every dataset (default: the fixture's own)")
    ap.add_argument("--n-val", type=int, default=None,
                    help="val videos of every dataset (default: the fixture's own)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="default: build/joint_check/tiny.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("joint_check: no CUDA device (pass --device cpu for the CPU)")
    out = Path(args.out or REPO / "build" / "joint_check" / "tiny.json")
    cfg = build_cfg(args.steps)
    tok = BertTokenizer()
    per_seed = []
    with tempfile.TemporaryDirectory(prefix="joint_check_") as root:
        fx = fixtures(os.path.join(root, "data"), args.n_train, args.n_val)
        cats = fx["vis"][2]
        frame_range = {"vis": 5, "bdd": 3, "rvos": 5, "sot": 7}
        task = {"vis": "detection", "bdd": "detection", "rvos": "grounding", "sot": "sot"}
        for seed in range(args.first_seed, args.first_seed + args.seeds):
            loader = MultiDatasetLoader(
                [(fx[n][0], VideoPairMapper(cfg.data, cats, tok,
                                            sampling_frame_range=frame_range[n]), 2, task[n])
                 for n in ("vis", "bdd", "rvos", "sot")],
                args.weights, seed=seed, num_workers=2)
            st = Stage(cfg, loader, os.path.join(root, f"run{seed}"), device,
                       task="detection", video=True)
            rec = st.train()
            if set(st.counts) != {"detection", "grounding", "sot"}:
                raise RuntimeError(f"the joint stage did not route every task: "
                                   f"{dict(st.counts)}")
            model = st.trainer.model
            t0 = time.perf_counter()
            vis, _ = eval_vis(model, cfg, fx["vis"][1], fx["vis"][3], cats, device)
            mot = finite(eval_mot(model, cfg, fx["bdd"][1], cats, device))
            sot, jf, _ = eval_sot_vos(model.eval(), cfg, fx["sot"][1], device)
            rvos_jf = eval_rvos(model, cfg, fx["rvos"][1], device)
            vis = finite(vis)
            rec.update(eval_seconds=time.perf_counter() - t0, joint_vis_map=vis["AP"],
                       joint_vis_ap50=vis["AP50"], joint_mot_mota=mot["MOTA"],
                       joint_mot_idf1=mot["IDF1"], joint_sot_auc=float(sot["AUC"]),
                       joint_vos_jf=jf, joint_rvos_jf=rvos_jf, ytvis=vis, mot=mot,
                       sot=finite(sot))
            per_seed.append({"seed": seed, **rec})
            print(f"[joint_check] seed {seed}: {args.steps} routed steps "
                  f"{rec['batches_read_per_task']} in {rec['train_seconds']:.1f} s; VIS mAP "
                  f"{vis['AP']}, AP50 {vis['AP50']}, MOTA {mot['MOTA']}, IDF1 {mot['IDF1']}, "
                  f"SOT AUC {float(sot['AUC']):.4f}, VOS J&F {jf:.4f}, R-VOS J&F "
                  f"{rvos_jf:.4f}", flush=True)
            del st, model
    payload = {
        "config": "tiny_test_config with the reid head (build_tiny_cfg, frame range 7), "
                  "trained from scratch",
        "device": card(device), "steps": args.steps, "mixture_weights": args.weights,
        "dataset": "4 mini video datasets (VIS + BDD-track + R-VOS referring + SOT), one "
                   "jointly trained model",
        "pipeline": "weighted loader (detection/grounding/sot pairs) -> routed "
                    "Trainer(video=True) -> one checkpoint -> VIS mAP + CLEAR-MOT + SOT AUC "
                    "+ VOS J&F + R-VOS J&F",
        "per_seed": per_seed}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
