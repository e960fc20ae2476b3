"""The training loop, mirroring `uninext_tpu/engine/trainer.py:Trainer`
(detectron2's DefaultTrainer with its hooks): batches from a loader,
`engine/train.py:train_step` on the card, hooks around every step
(`engine/hooks.py`: timer, writers, checkpoints, learning rate, memory,
profiler, evaluation) and `resume_or_load`.

With `video=True` the batches are (key, ref) pairs
(`data/video.py:collate_video`), which `engine/train.py:train_step` takes
through the two-frame forward, or with `task="sot"` through the SOT step
(whose state has the template branch). A routed pair loader (its first
batch carries "__task__") gets a state with every branch, the template
branch included, whatever `task` is, as JAX's `init_all`: a SOT batch may
come at any step, and the checkpoint holds what `init_all_paths` makes.

The JAX trainer's persistent compilation cache, device mesh, chunked
steps (a scan of jitted steps) and TensorBoard writer do not carry over:
each micro-step here is one eager `train_step`, and metrics go to the
terminal and `metrics.json`. `cfg.solver.max_iter`, the schedule and every hook
period count optimizer updates; with `grad_accum_steps` k the loop runs
`max_iter * k` micro-steps and `state.step` counts micro-steps, as in the
JAX package.

Over a mesh (`parallel/mesh.py`; `cfg.parallel.model_parallel_size` is its
model group's size, as in the JAX trainer) every rank runs this loop on
batches of its own loader (built with `process_index` = the rank's data
rank and `process_count` = the data group's size), the state is cut over
the model group when that is larger than 1, and the losses it logs are
averaged over the data group (`train_step`). Event writers and the
profiler run on the mesh's first rank only, which also writes the
checkpoints; the checkpoint and eval hooks run on every rank, since joining
a cut model's shards and its forward are collectives.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import UninextConfig
from .checkpoint import CheckpointManager
from .events import EventStorage, JSONWriter, TerminalWriter
from .hooks import default_hooks
from .optimizer import lr_schedule
from .train import build_train_state, train_step

TARGET_KEYS = ("targets", "targets_key", "targets_ref")


def to_device(batch: Dict, device: torch.device, has_masks: bool) -> Dict:
    """A collated numpy batch (`data/loader.py:collate`, or a pair batch of
    `data/video.py:collate_video` with `targets_key` and `targets_ref`) as
    tensors on `device`, text ids as int64, with `has_masks` set in each
    targets dict (true with masks, or BoxInst's box bitmasks, and
    `has_masks`). Host-side routing keys ("__task__") stay behind."""
    mv = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    out = {k: mv(v) for k, v in batch.items() if k not in TARGET_KEYS + ("__task__",)}
    out["text_ids"] = out["text_ids"].long()
    for key in TARGET_KEYS:
        if key in batch:
            out[key] = {k: mv(v) for k, v in batch[key].items()}
            out[key]["has_masks"] = has_masks and ("masks" in batch[key]
                                                   or "box_bitmasks" in batch[key])
    return out


class Trainer:
    def __init__(self, cfg: UninextConfig, loader: Iterator,
                 output_dir: str = "./output", task: str = "detection",
                 has_masks: bool = True, device="cuda", seed: int = 0,
                 video: bool = False,
                 eval_fn: Optional[Callable] = None,
                 eval_period: int = 5000,
                 log_period: int = 20,
                 profile_iters: Optional[tuple] = None,
                 extra_hooks: Optional[List] = None,
                 mesh=None):
        """`loader` yields collated batches (a "__task__" key routes a batch
        to its task, else `task`). The model gets random weights from
        `seed` on `device` (the card unless the caller asks for another).
        `eval_fn(model) -> dict` runs every `eval_period` updates. With
        `video` the batches must be (key, ref) pairs, without it image
        batches; a batch of the other kind raises. With a `mesh` the loader
        must be this rank's (its `process_index` and `process_count`, where
        it has them, the rank's data rank and the data group's size)."""
        if mesh is not None:
            if mesh.model_size != cfg.parallel.model_parallel_size:
                raise ValueError(f"mesh model groups of {mesh.model_size} != "
                                 f"model_parallel_size {cfg.parallel.model_parallel_size}")
            shard = (getattr(loader, "process_index", mesh.data_rank),
                     getattr(loader, "process_count", mesh.data_size))
            if shard != (mesh.data_rank, mesh.data_size):
                raise ValueError(f"loader reads shard {shard}, this rank is data rank "
                                 f"{mesh.data_rank} of {mesh.data_size}")
        first = mesh is None or mesh.rank == mesh.ranks[0]
        self.mesh = mesh
        self.cfg = cfg
        self.loader = loader
        self.task = task
        self.has_masks = has_masks
        self.video = video
        self.device = torch.device(device)
        self.accum = max(1, cfg.solver.grad_accum_steps)
        self.storage = EventStorage()
        self.writers = [TerminalWriter(cfg.solver.max_iter * self.accum),
                        JSONWriter(f"{output_dir}/metrics.json")] if first else []
        self.ckpt = CheckpointManager(f"{output_dir}/checkpoints")
        self._pending_first = next(loader)
        # a routed pair loader may send any task later, SOT's included: build
        # every branch then, as JAX's trainer does (`init_all`)
        template = task == "sot" or (video and "__task__" in self._pending_first)
        self.state = build_train_state(cfg, self.device, seed, template=template,
                                       mesh=mesh, tp=mesh is not None and mesh.model_size > 1)
        self.model = self.state.model
        self.hooks = default_hooks(
            cfg.solver, log_period=log_period, eval_fn=eval_fn,
            eval_period=eval_period, profile_iters=profile_iters if first else None,
            profile_dir=f"{output_dir}/profile",
            schedule_fn=lr_schedule(cfg.solver), accum_steps=self.accum)
        if extra_hooks:
            self.hooks.extend(extra_hooks)

    def resume_or_load(self, init_weights: Optional[str] = None) -> bool:
        self.state, resumed = self.ckpt.resume_or_load(self.state, init_weights)
        return resumed

    def train(self):
        """Micro-steps from `state.step` to `max_iter * k`. Each step's
        `time` is host time from its start to the end of its device work,
        without the wait for the next batch."""
        total = self.cfg.solver.max_iter * self.accum
        batch = self._pending_first
        data_iter = iter(self.loader)

        def next_batch():
            nonlocal data_iter
            try:
                return next(data_iter)
            except StopIteration:
                data_iter = iter(self.loader)
                return next(data_iter)

        for h in self.hooks:
            h.before_train(self)
        for it in range(self.state.step, total):
            self.storage.iter = it
            for h in self.hooks:
                h.before_step(self)
            if ("images_key" in batch) != self.video:
                raise ValueError(f"Trainer(video={self.video}) was given "
                                 f"{'an image' if self.video else 'a pair'} batch")
            t0 = time.perf_counter()
            metrics = train_step(self.state, to_device(batch, self.device, self.has_masks),
                                 batch.get("__task__", self.task))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            metrics["time"] = time.perf_counter() - t0
            batch = next_batch()        # mapped ahead by the loader's threads
            for h in self.hooks:
                h.after_step(self, metrics)
        for h in self.hooks:
            h.after_train(self)
