"""Training CLI, the port of `tools/train_net.py` (the reference's launch.py
and projects/UNINEXT/train_net.py):

    python -m uninext_tpu_torch.tools.train_net --config image_joint_r50 \\
        --coco-json ann.json --image-root images/ [--init-weights model.pth] \\
        [solver.max_iter=100 ...] [--device cpu]
    python -m uninext_tpu_torch.tools.train_net --recipe image_joint   # $UNINEXT_DATA
    python -m uninext_tpu_torch.tools.train_net --eval-only --coco-json ... \\
        --image-root ... --init-weights model.pth

`--recipe` resolves a `data/registry.py:TRAIN_RECIPES` entry's splits under
`$UNINEXT_DATA` (default ./datasets) and takes its schedule; `--eval-only`
runs `DetectionEvaluator` (or with `--task grounding` `evaluate_refcoco`)
and prints the metrics as JSON; otherwise the `Trainer` trains, from the
latest checkpoint under `<output-dir>/checkpoints` with `--resume`, else
from `--init-weights`. Dotted overrides (`solver.base_lr=1e-4`) follow the
flags. With `--coordinator host:port --num-processes n --process-id i` every
process joins one `torch.distributed` group (NCCL, a card each; gloo with
`--device cpu`) and trains on its shard of the batches over a mesh of
`cfg.parallel.model_parallel_size`-rank model groups.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from .cli_common import add_device_arg, config_by_name, device_of


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="image_joint_r50",
                   help="config preset name in uninext_tpu_torch.config")
    p.add_argument("--recipe", default=None,
                   help="named training recipe (registry.TRAIN_RECIPES: "
                        "obj365_pretrain, image_joint, video_joint, "
                        "single_task_{det,rec,vis,sot,rvos}); resolves "
                        "datasets under $UNINEXT_DATA")
    p.add_argument("--task", default="detection", choices=["detection", "grounding"])
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--coco-json", default=None)
    p.add_argument("--image-root", default=None)
    p.add_argument("--refcoco-json", default=None)
    p.add_argument("--init-weights", default=None,
                   help=".pth reference checkpoint to load")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-process torch.distributed")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    add_device_arg(p)
    p.add_argument("opts", nargs="*",
                   help="dotted config overrides, e.g. solver.base_lr=1e-4")
    return p.parse_args(argv)


def apply_overrides(cfg, opts):
    """`key.sub=value` overrides of a frozen config (`tools/train_net.py:44`),
    each value cast to the field's type (bools from 1/true)."""
    for opt in opts:
        key, val = opt.split("=", 1)
        parts = key.split(".")
        node_path = []
        node = cfg
        for part in parts[:-1]:
            node = getattr(node, part)
            node_path.append(part)
        field = parts[-1]
        old = getattr(node, field)
        typ = type(old)
        new_val = typ(val) if typ is not bool else val.lower() in ("1", "true")
        new_node = dataclasses.replace(node, **{field: new_val})
        for part in reversed(node_path):
            parent = cfg
            for pp in node_path[:-1]:
                parent = getattr(parent, pp)
            new_node = dataclasses.replace(parent, **{part: new_node})
        cfg = new_node if node_path else dataclasses.replace(cfg, **{field: new_val})
    return cfg


def init_processes(args, device):
    """Join the process group of `--coordinator` (the counterpart of
    `jax.distributed.initialize`) and return this rank's device."""
    from ..parallel.mesh import init_distributed
    host, port = args.coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(args.process_id), WORLD_SIZE=str(args.num_processes),
                      MASTER_ADDR=host, MASTER_PORT=port)
    if device.type == "cuda":
        return init_distributed("nccl")
    return init_distributed("gloo", device="cpu")


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if args.coordinator:
        device = init_processes(args, device)
    from ..data.coco import UniDatasetMapper, load_coco_json, load_refcoco_json
    from ..data.loader import MultiDatasetLoader, prefetch
    from ..engine.trainer import Trainer

    cfg = config_by_name(args.config)
    datasets = []
    ratios = None
    video = False
    categories = ["object"]
    if args.recipe:
        from ..data import registry
        base_name = registry.TRAIN_RECIPES[args.recipe][0]
        if args.config == "image_joint_r50" and base_name != args.config:
            cfg = config_by_name(base_name)
        cfg = apply_overrides(cfg, args.opts)
        cfg, datasets, ratios, video = registry.build_recipe(args.recipe, cfg)
    else:
        cfg = apply_overrides(cfg, args.opts)
    coco_records = refcoco_records = None
    if args.coco_json:
        coco_records, categories = load_coco_json(args.coco_json, args.image_root)
        mapper = UniDatasetMapper(cfg.data, categories, is_train=True)
        datasets.append((coco_records, mapper, 2))
    if args.refcoco_json:
        refcoco_records = load_refcoco_json(args.refcoco_json, args.image_root)
        mapper = UniDatasetMapper(cfg.data, categories, is_train=True)
        datasets.append((refcoco_records, mapper, 2))
    if not datasets:
        raise SystemExit("no datasets given (--coco-json/--refcoco-json)")

    if args.eval_only:
        # reference train_net.py --eval-only: build the model, load weights,
        # run the task evaluator over the given json, print metrics
        from ..data.prompts import create_label_token_map
        from ..data.tokenizer import BertTokenizer
        from ..engine.evaluator import DetectionEvaluator, evaluate_refcoco
        from ..models.detr import build_model
        from .cli_common import load_weights

        model = build_model(cfg, device, seed=0)
        load_weights(model, args.init_weights,
                     f"{args.output_dir}/checkpoints" if args.resume else None)
        tok = BertTokenizer()
        eval_mapper = UniDatasetMapper(cfg.data, categories, tok, is_train=False,
                                       with_masks=False)
        if args.task == "grounding":
            res = evaluate_refcoco(model, refcoco_records, eval_mapper)
        else:
            _, _, cmap = create_label_token_map(categories, tok, cfg.data.max_text_len)
            ev = DetectionEvaluator(model, cfg, cmap, with_masks=False)
            res = ev.evaluate(coco_records, eval_mapper)
        print(json.dumps({k: float(v) for k, v in res.items()
                          if isinstance(v, (int, float))}, indent=1))
        return

    mesh = None
    if args.coordinator:
        from ..parallel.mesh import create_mesh
        mesh = create_mesh(cfg.parallel.model_parallel_size)
    rec_weights = None
    if args.recipe:
        from ..data.registry import recipe_record_weights
        rec_weights = recipe_record_weights(args.recipe, datasets)
    loader = prefetch(iter(MultiDatasetLoader(
        datasets, ratios=ratios or [1.0] * len(datasets),
        record_weights=rec_weights,
        process_index=mesh.data_rank if mesh else 0,
        process_count=mesh.data_size if mesh else 1)))
    trainer = Trainer(cfg, loader, output_dir=args.output_dir, task=args.task,
                      video=video, device=device, mesh=mesh)
    trainer.resume_or_load(args.init_weights if not args.resume else None)
    trainer.train()


if __name__ == "__main__":
    main()
