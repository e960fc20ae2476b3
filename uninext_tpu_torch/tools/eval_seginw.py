"""Segmentation-in-the-Wild (SegInW) zero-shot sweep, the port of
`tools/eval_seginw.py`: the image-joint model is evaluated with no
fine-tuning on the 25 in-the-wild instance-segmentation datasets, each
dataset's own category names as the prompt, and the headline number is the
mean mask AP over them (registry: `data/registry.py` `seginw_<Subset>_val`).

It sweeps whatever subsets exist under `$UNINEXT_DATA` (`--make-mini`
generates a 2-subset fixture, `data/mini_coco.py:make_mini_seginw`), scores
each with `DetectionEvaluator` (bbox and segm, the C++ COCO matcher) and
writes per-dataset AP and the means to `--out`.

    UNINEXT_DATA=/data python -m uninext_tpu_torch.tools.eval_seginw \\
        --resume-dir out/ [--subsets Chicken Cows] [--device cpu] [--out result.json]
    python -m uninext_tpu_torch.tools.eval_seginw --make-mini --steps 0

With `--make-mini` and `--steps` > 0 the model first trains that many steps
on a separate mini-COCO (`--config tiny`: `tools/evidence.py:
build_tiny_cfg`), then sweeps the unseen subsets. `--out` defaults to
`build/eval_seginw/SEGINW_RESULT.json`, beside the JAX tool's record in the
repository root, which it leaves as it is.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from .cli_common import add_device_arg, device_of, load_weights

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_seginw(model, cfg, subsets, verbose=True):
    """Zero-shot sweep: per-subset bbox/segm AP with the subset's own
    category names as the prompt, and the mean over subsets (the SegInW
    headline metric). Subsets whose data is missing are skipped and
    reported."""
    import numpy as np

    from ..data.coco import UniDatasetMapper
    from ..data.prompts import create_label_token_map
    from ..data.registry import get_dataset
    from ..data.tokenizer import BertTokenizer
    from ..engine.evaluator import DetectionEvaluator

    tok = BertTokenizer()
    per, skipped = {}, []
    for sub in subsets:
        try:
            records, cats, _ = get_dataset(f"seginw_{sub}_val")
        except (FileNotFoundError, KeyError) as e:
            skipped.append(f"{sub}: {e}")
            continue
        mapper = UniDatasetMapper(cfg.data, cats, tok, is_train=False, with_masks=True)
        _, _, cmap = create_label_token_map(cats, tok, cfg.data.max_text_len)
        res = {}
        for iou_type, with_masks in (("bbox", False), ("segm", True)):
            ev = DetectionEvaluator(model, cfg, cmap, with_masks=with_masks)
            r = ev.evaluate(records, mapper, score_thr=0.05)
            res[iou_type] = {k: (None if not np.isfinite(v) else round(float(v), 4))
                             for k, v in r.items()}
        per[sub] = {"n_images": len(records), "n_categories": len(cats), **res}
        if verbose:
            print(f"[seginw/{sub}] bbox AP {res['bbox']['AP']}  "
                  f"segm AP {res['segm']['AP']}", flush=True)
    aps = [v["segm"]["AP"] for v in per.values() if v["segm"]["AP"] is not None]
    baps = [v["bbox"]["AP"] for v in per.values() if v["bbox"]["AP"] is not None]
    return {
        "mean_segm_ap": round(float(np.mean(aps)), 4) if aps else None,
        "mean_bbox_ap": round(float(np.mean(baps)), 4) if baps else None,
        "n_datasets": len(per), "per_dataset": per, "skipped": skipped,
    }


def _write(result, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None):
    import dataclasses

    from ..data.registry import _SEGINW_SUBSETS

    ap = argparse.ArgumentParser()
    ap.add_argument("--subsets", nargs="*", default=list(_SEGINW_SUBSETS))
    add_device_arg(ap)
    ap.add_argument("--resume-dir", default=None,
                    help="output dir holding checkpoints/ (CheckpointManager)")
    ap.add_argument("--init-weights", default=None, help="reference .pth to evaluate")
    ap.add_argument("--config", default="image_joint_r50", choices=["image_joint_r50", "tiny"])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "eval_seginw",
                                                  "SEGINW_RESULT.json"))
    ap.add_argument("--make-mini", action="store_true",
                    help="generate a 2-subset mini fixture and sweep it")
    ap.add_argument("--steps", type=int, default=200,
                    help="with --make-mini: train on a separate mini-coco "
                         "set first, then sweep SegInW zero-shot (0 = "
                         "random weights, schema check only)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the order of the training batches (--steps > 0)")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    from ..models.detr import build_model

    if args.make_mini:
        from ..data.mini_coco import make_mini_seginw
        root = make_mini_seginw(tempfile.mkdtemp(prefix="mini_seginw_"),
                                subsets=("Chicken", "Cows"))
        os.environ["UNINEXT_DATA"] = root
        args.subsets = ["Chicken", "Cows"]
        print(f"[data] mini seginw at {root}")

    if args.config == "tiny":
        from .evidence import build_tiny_cfg
        cfg = build_tiny_cfg(max(args.steps, 1), min_size=224, max_size=352)
    else:
        from ..config import image_joint_r50
        cfg = image_joint_r50()
        if args.make_mini:
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, min_size_test=224, max_size_test=352))

    if args.make_mini and args.steps > 0:
        # zero-shot transfer: train on a separate mini-coco set (the shared
        # shape vocabulary), then sweep the unseen SegInW subsets with no
        # fine-tuning, the reference's SegInW protocol in miniature
        from ..data.coco import UniDatasetMapper, load_coco_json
        from ..data.loader import MultiDatasetLoader
        from ..data.mini_coco import make_mini_coco
        from ..data.tokenizer import BertTokenizer
        from ..engine.trainer import Trainer
        troot = tempfile.mkdtemp(prefix="seginw_train_")
        tpaths = make_mini_coco(troot, seed=500)
        recs, cats = load_coco_json(tpaths["train_json"], tpaths["train_root"])
        mapper = UniDatasetMapper(cfg.data, cats, BertTokenizer(), is_train=True,
                                  with_masks=True, lsj=True, lsj_size=224,
                                  lsj_min_scale=0.6, lsj_max_scale=1.4)
        loader = MultiDatasetLoader([(recs, mapper, 2)], [1.0], seed=args.seed,
                                    num_workers=2)
        trainer = Trainer(cfg, iter(loader),
                          output_dir=tempfile.mkdtemp(prefix="seginw_out_"),
                          task="detection", has_masks=True, device=device, log_period=100)
        trainer.train()
        result = run_seginw(trainer.model, cfg, args.subsets)
        result["config"] = args.config
        result["zero_shot"] = True
        result["trained_on"] = f"mini-coco ({args.steps} steps), SegInW subsets unseen"
        _write(result, args.out)
        print(f"[done] zero-shot mean segm AP {result['mean_segm_ap']} "
              f"over {result['n_datasets']} datasets -> {args.out}")
        return

    model = build_model(cfg, device, seed=0)
    load_weights(model, args.init_weights,
                 os.path.join(args.resume_dir, "checkpoints") if args.resume_dir else None)
    result = run_seginw(model, cfg, args.subsets)
    result["config"] = args.config
    result["zero_shot"] = args.resume_dir is None and args.init_weights is None
    _write(result, args.out)
    print(f"[done] mean segm AP {result['mean_segm_ap']} over "
          f"{result['n_datasets']} datasets -> {args.out}")


if __name__ == "__main__":
    main()
