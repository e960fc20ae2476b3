"""The trainer's hooks, mirroring `uninext_tpu/engine/hooks.py` (detectron2's
IterationTimer, PeriodicWriter, PeriodicCheckpointer, BestCheckpointer,
LRScheduler, TorchProfiler, EvalHook, TorchMemoryStats).

The Trainer (`engine/trainer.py`) drives the loop:

    for h in hooks: h.before_train(trainer)
    for it in ...:                       # micro-steps
        for h in hooks: h.before_step(trainer)
        <train_step>
        for h in hooks: h.after_step(trainer, metrics)
    for h in hooks: h.after_train(trainer)

plus `after_eval(trainer, results)` whenever an EvalHook fires. With
gradient accumulation (k micro-steps per update) `default_hooks` scales
every period by k, so periods keep counting updates.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch


class HookBase:
    """No-op base; subclasses override what they need."""

    def before_train(self, trainer):
        pass

    def before_step(self, trainer):
        pass

    def after_step(self, trainer, metrics: Dict):
        pass

    def after_eval(self, trainer, results: Dict):
        pass

    def after_train(self, trainer):
        pass


class IterationTimer(HookBase):
    """Host time split between waiting for data and the step; after_train
    writes the split into the trainer's EventStorage."""

    def __init__(self):
        self.t_data = 0.0
        self.t_step = 0.0
        self._mark = time.perf_counter()

    def before_train(self, trainer):
        self._mark = time.perf_counter()

    def before_step(self, trainer=None):
        now = time.perf_counter()
        self.t_data += now - self._mark
        self._mark = now

    def after_step(self, trainer=None, metrics=None):
        now = time.perf_counter()
        self.t_step += now - self._mark
        self._mark = now

    def summary(self) -> dict:
        tot = max(self.t_data + self.t_step, 1e-9)
        return {"data_frac": self.t_data / tot, "step_frac": self.t_step / tot}

    def after_train(self, trainer):
        if trainer is not None:
            trainer.storage.put_scalars(**{
                f"timer/{k}": v for k, v in self.summary().items()})


class PeriodicWriter(HookBase):
    """Flush the trainer's writers every `period` micro-steps and at the end.
    Metrics reach the host only when written."""

    def __init__(self, period: int = 20):
        self.period = period

    def after_step(self, trainer, metrics: Dict):
        if (trainer.storage.iter + 1) % self.period == 0:
            trainer.storage.put_scalars(**{k: float(v) for k, v in metrics.items()})
            for w in trainer.writers:
                w.write(trainer.storage)

    def after_train(self, trainer):
        for w in trainer.writers:
            w.write(trainer.storage)
            close = getattr(w, "close", None)
            if close is not None:
                close()


class PeriodicCheckpointer(HookBase):
    """Save the train state every `period` micro-steps and once at the end."""

    def __init__(self, period: int):
        self.period = period

    def after_step(self, trainer, metrics: Dict):
        it = trainer.storage.iter
        if (it + 1) % self.period == 0:
            trainer.ckpt.save(it + 1, trainer.state)

    def after_train(self, trainer):
        trainer.ckpt.save(trainer.state.step, trainer.state)


class BestCheckpointer(HookBase):
    """Keep the checkpoint with the highest eval metric (e.g. 'eval/AP')."""

    def __init__(self, metric: str = "eval/AP"):
        self.metric = metric
        self.best: Optional[float] = None

    def after_eval(self, trainer, results: dict):
        val = results.get(self.metric.replace("eval/", ""))
        if val is None:
            return
        if self.best is None or val > self.best:
            self.best = float(val)
            trainer.ckpt.save(trainer.state.step, trainer.state)


class EvalHook(HookBase):
    """Run `eval_fn(model) -> dict` every `period` micro-steps, record the
    results under eval/ and pass them to every hook's after_eval. Over a
    mesh it runs on every rank (a cut model's forward needs them all), and
    the first rank's results count."""

    def __init__(self, period: int, eval_fn: Callable):
        self.period = period
        self.eval_fn = eval_fn

    def after_step(self, trainer, metrics: Dict):
        if self.period <= 0 or (trainer.storage.iter + 1) % self.period:
            return
        results = self.eval_fn(trainer.model)
        mesh = getattr(trainer, "mesh", None)
        if mesh is not None and mesh.group is not None:
            # every rank keeps the first rank's results, so that the hooks
            # after it (a best checkpoint, a collective) decide alike
            box = [results]
            torch.distributed.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
            results = box[0]
        trainer.storage.put_scalars(
            **{f"eval/{k}": v for k, v in results.items()
               if isinstance(v, (int, float))})
        for h in trainer.hooks:
            h.after_eval(trainer, results)


class LRSchedulerHook(HookBase):
    """Record the base group's learning rate each logging period, from the
    schedule (counted in updates) at the current micro-step // k."""

    def __init__(self, schedule_fn: Callable[[int], float], period: int = 20,
                 base_lr: float = 1.0, accum_steps: int = 1):
        self.schedule_fn = schedule_fn
        self.base_lr = base_lr
        self.period = period
        self.accum_steps = max(1, accum_steps)

    def after_step(self, trainer, metrics: Dict):
        it = trainer.storage.iter
        if (it + 1) % self.period == 0:
            trainer.storage.put_scalars(
                lr=self.base_lr * float(self.schedule_fn(it // self.accum_steps)))


class MemoryStatsHook(HookBase):
    """Device memory every `period` micro-steps: the allocator's bytes in
    use and its peak (`torch.cuda.max_memory_allocated`) on the model's
    card; nothing on the CPU."""

    def __init__(self, period: int = 100):
        self.period = period
        self.last: Dict[str, float] = {}

    def after_step(self, trainer, metrics: Dict):
        if (trainer.storage.iter + 1) % self.period:
            return
        dev = next(trainer.model.parameters()).device
        if dev.type != "cuda":
            return
        self.last = {"mem/bytes_in_use": float(torch.cuda.memory_allocated(dev)),
                     "mem/peak_bytes_in_use": float(torch.cuda.max_memory_allocated(dev))}
        trainer.storage.put_scalars(**self.last)


class ProfilerHook(HookBase):
    """A `torch.profiler` window over micro-steps [start, stop); its Chrome
    trace goes to `out_dir`."""

    def __init__(self, start: int, stop: int, out_dir: str):
        self.start = start
        self.stop = stop
        self.out_dir = out_dir
        self._prof = None

    def before_step(self, trainer):
        it = trainer.storage.iter
        if it == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        if it == self.stop:
            self._close()

    def _close(self):
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
            self._prof = None

    def after_train(self, trainer):
        self._close()


def default_hooks(cfg_solver, log_period: int = 20,
                  eval_fn: Optional[Callable] = None,
                  eval_period: int = 5000,
                  profile_iters: Optional[tuple] = None,
                  profile_dir: str = "./profile",
                  schedule_fn: Optional[Callable] = None,
                  accum_steps: int = 1):
    """The Trainer's standard hooks. Log, checkpoint and eval periods are
    in updates; with accum_steps k the loop counts micro-steps, so each
    period is scaled by k here."""
    k = max(1, accum_steps)
    hooks = [IterationTimer(), PeriodicWriter(log_period * k),
             PeriodicCheckpointer(cfg_solver.checkpoint_period * k)]
    if schedule_fn is not None:
        hooks.append(LRSchedulerHook(schedule_fn, log_period * k,
                                     base_lr=cfg_solver.base_lr, accum_steps=k))
    hooks.append(MemoryStatsHook(max(log_period * k * 5, 100)))
    if profile_iters:
        hooks.append(ProfilerHook(profile_iters[0], profile_iters[1], profile_dir))
    if eval_fn is not None:
        hooks.append(EvalHook(eval_period * k, eval_fn))
        hooks.append(BestCheckpointer())
    return hooks
