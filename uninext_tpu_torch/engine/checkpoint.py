"""Checkpoints of the train state with `torch.save`, mirroring
`uninext_tpu/engine/checkpoint.py:CheckpointManager` (orbax there): save and
resume the model, AdamW's moments and counts, the micro-step and the state
of the generator of the step's random numbers, with detectron2's
`resume_or_load` semantics.

One file per saved step, `<directory>/ckpt_<step>.pt`, written whole and
then renamed into place; the oldest beyond `max_to_keep` are deleted.
`restore_params` loads the model's weights alone, as stage 2 of the
training recipe starts from stage 1's checkpoint.

The stage hand-off (`load_stage_weights`, with `inflate_conv_3c_to_4c`)
carries one stage's weights into the next stage's model, as the JAX
package's does (the reference's obj365 -> image joint -> video joint
chain, assets/TRAIN.md): every tensor whose name the source has with the
same shape is copied, the 4-channel template backbone is taken from the
image backbone, its first convolution inflated with a zero 4th channel.

Over a mesh (`state.mesh`) every rank calls `save`: the tensor-parallel
shards of the parameters and of both Adam moments are joined over the
model group (`parallel/sharding.py`), so the file holds the whole model
under the one-process state's names and does not depend on k, and the
mesh's first rank writes it. `restore` loads the whole file on every rank
and cuts it to the rank's shards.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel import sharding
from .train import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.search, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Save `state` as step `step`, once per step: hooks may fire a
        periodic, a final and a best save at one step. Saves fall on update
        boundaries (the hooks' periods are whole updates), where no summed
        gradient is pending."""
        if step in self.all_steps():
            return
        opt = state.optimizer
        if opt.accumulating:
            raise ValueError(f"checkpoint at micro-step {step}: {opt.mini_step} of "
                             f"{opt.accum} micro-steps of an update are pending")
        mesh = state.mesh
        moments = {name: {g: [sharding.whole(t, p, mesh) for t, p in zip(m[g], opt.params[g])]
                          for g in m} for name, m in (("mu", opt.mu), ("nu", opt.nu))}
        payload = {
            "model": sharding.whole_state_dict(state.model, mesh),
            "optimizer": {**moments, "count": opt.count},
            "step": state.step,
            "generator": state.generator.get_state(),
        }
        if mesh is None or mesh.rank == mesh.ranks[0]:
            tmp = self.path(step) + f".{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self.path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        if mesh is not None and mesh.group is not None:
            torch.distributed.barrier(group=mesh.group)

    def _load(self, step: Optional[int]):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    @torch.no_grad()
    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, bool]:
        """Load a saved step (the latest by default) into `state` in place."""
        ckpt = self._load(step)
        if ckpt is None:
            return state, False
        mesh = state.mesh
        state.model.load_state_dict(sharding.cut_state_dict(state.model, ckpt["model"], mesh))
        opt, saved = state.optimizer, ckpt["optimizer"]
        for g, ps in opt.params.items():
            for name in ("mu", "nu"):
                torch._foreach_copy_(getattr(opt, name)[g], [
                    sharding.cut_like(t, p, mesh) for t, p in zip(saved[name][g], ps)])
        opt.count, opt.mini_step = saved["count"], 0
        state.model.zero_grad(set_to_none=True)
        state.step = ckpt["step"]
        state.generator.set_state(ckpt["generator"])
        return state, True

    @torch.no_grad()
    def restore_params(self, model: torch.nn.Module, step: Optional[int] = None
                       ) -> Tuple[torch.nn.Module, bool]:
        """Load only the model's weights of a saved step (the latest by
        default) into `model` in place, no optimizer state or step
        (`uninext_tpu/engine/checkpoint.py:38`). Returns (model, whether a
        checkpoint was found)."""
        ckpt = self._load(step)
        if ckpt is None:
            return model, False
        model.load_state_dict(ckpt["model"])
        return model, True

    def resume_or_load(self, state: TrainState, init_weights_path: Optional[str] = None
                       ) -> Tuple[TrainState, bool]:
        """Resume the whole state from the latest checkpoint if there is
        one; else load the model's weights from `init_weights_path` (a
        state dict, or a checkpoint of this manager), leaving the optimizer
        and the step as they are."""
        state, resumed = self.restore(state)
        if resumed:
            return state, True
        if init_weights_path and os.path.exists(init_weights_path):
            sd = torch.load(init_weights_path, map_location="cpu", weights_only=True)
            state.model.load_state_dict(sharding.cut_state_dict(
                state.model, sd.get("model", sd), state.mesh))
        return state, False


def state_differences(a: TrainState, b: TrainState) -> List[str]:
    """What differs between two train states, by name: parameters and
    buffers, both Adam moments, the optimizer's counts, the step and the
    generator's state; [] when they are bit-equal."""
    sb = b.model.state_dict()
    diff = [k for k, v in a.model.state_dict().items() if not torch.equal(v, sb[k])]
    oa, ob = a.optimizer, b.optimizer
    for g in oa.params:
        for i, n in enumerate(oa.names[g]):
            diff += [f"{m} {n}" for m, x, y in (("mu", oa.mu, ob.mu), ("nu", oa.nu, ob.nu))
                     if not torch.equal(x[g][i], y[g][i])]
    for what, x, y in (("count", oa.count, ob.count),
                       ("mini_step", oa.mini_step, ob.mini_step), ("step", a.step, b.step)):
        if x != y:
            diff.append(f"{what} {x} != {y}")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        diff.append("generator")
    return diff


BACKBONE = "detr.detr.backbone.0.backbone."
TEMPLATE_BACKBONE = "detr.detr.ref_backbone.0.backbone."


def inflate_conv_3c_to_4c(weight: torch.Tensor) -> torch.Tensor:
    """A convolution's weight (out, 3, kh, kw) -> (out, 4, kh, kw), the new
    4th input channel zero (`uninext_tpu/engine/checkpoint.py:76`, whose
    flax layout has the input channels on axis 2; the reference's
    conversion/convert_3c_to_4c_pth.py: the template backbone takes RGB and
    a mask)."""
    out, _, kh, kw = weight.shape
    return torch.cat([weight, weight.new_zeros(out, 1, kh, kw)], dim=1)


def load_stage_weights(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor],
                       inflate_4c: bool = True, verbose: bool = True):
    """The stage hand-off of `uninext_tpu/engine/checkpoint.py:106` on the
    port's `state_dict` names, with detectron2's shape-skipping load: each
    tensor of `target` (the next stage's state dict) whose name `source`
    (the last stage's) holds with the same shape is copied; missing or
    mismatched ones keep the target's value and are reported. Two rules of
    the recipe's last hand-off:

      * the template backbone (`detr.detr.ref_backbone.0.backbone.*`,
        absent from an image stage's weights) is taken from the image
        backbone (`detr.detr.backbone.0.backbone.*`) at the same sub-name;
      * a 4-input-channel convolution whose source has 3 is inflated by
        `inflate_conv_3c_to_4c`.

    No classifier needs surgery across category sets: classes are prompt
    tokens. Returns (the new state dict, report) with report {loaded,
    inflated, remapped_template, missing, mismatched}.

    The counts are of the port's tensors, not of JAX's leaves, and differ
    wherever the weight bridge (`engine/convert.py`) maps one to several or
    several to one: JAX's scan-stacked encoder leaf is one tensor per layer
    here, the decoder self-attention's q, k and v kernels (and biases) are
    one `in_proj_weight` (`in_proj_bias`), and ViT's `up_res3` Dense is one
    ConvTranspose2d. FrozenBN's scale, bias, mean and var are four tensors
    in both (ROADMAP §3.8)."""
    report = {"loaded": 0, "inflated": 0, "remapped_template": 0,
              "missing": [], "mismatched": []}
    out = {}
    for name, t in target.items():
        cand, remapped = name, False
        if cand not in source and name.startswith(TEMPLATE_BACKBONE):
            cand, remapped = BACKBONE + name[len(TEMPLATE_BACKBONE):], True
        if cand not in source:
            out[name] = t
            report["missing"].append(name)
            continue
        s = source[cand]
        if s.shape == t.shape:
            out[name] = s.to(dtype=t.dtype, device=t.device)
        elif (inflate_4c and s.dim() == 4 and t.dim() == 4 and s.shape[1] == 3
              and t.shape[1] == 4 and s.shape[0] == t.shape[0]
              and s.shape[2:] == t.shape[2:]):
            out[name] = inflate_conv_3c_to_4c(s).to(dtype=t.dtype, device=t.device)
            report["inflated"] += 1
        else:
            out[name] = t
            report["mismatched"].append(
                f"{name}: src {tuple(s.shape)} vs tgt {tuple(t.shape)}")
            continue
        report["loaded"] += 1
        report["remapped_template"] += int(remapped)
    if verbose:
        print(f"[load_stage_weights] loaded {report['loaded']} (inflated "
              f"{report['inflated']}, template-remapped {report['remapped_template']}), "
              f"{len(report['missing'])} left at init, {len(report['mismatched'])} "
              f"shape-skipped")
    return out, report
