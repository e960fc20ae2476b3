"""The train step, mirroring `uninext_tpu/engine/train.py`: batch -> loss
dict (detection or grounding, with the mask losses when the targets carry
masks) -> weighted sum -> backward -> global-norm clip -> per-group AdamW,
once every `grad_accum_steps` micro-steps. A (key, ref) pair batch of the
video configs (`images_key` in place of `images`) takes the same step
through `UninextDETR.forward_video_train`, or with `task="sot"` through
`UninextDETR.forward_sot_train` (the ref frame's template as the prompt,
the total scaled by `loss.sot_loss_scale`). Compute runs in the config's
dtype (bf16) with fp32 parameters and optimizer state, as in the JAX
package; no loss scaling. The loop around it is `engine/trainer.py`.

Over a mesh (`parallel/mesh.py`; the counterpart of `make_train_step(mesh,
tp)` and `make_video_train_step(mesh)`) every rank takes the step on its
rows of the whole batch: the random draws are the whole batch's cut to its
rows, the loss normalisers are the whole batch's, the optimizer averages
the gradients over the mesh, and the returned losses are averaged over the
data group, so that a k-rank step equals the one-process step on the whole
batch. With `tp` the towers are cut over the model group
(`parallel/sharding.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import UninextConfig
from ..models.detr import UninextDETR, build_model
from ..parallel import comm, sharding
from ..parallel.mesh import Mesh, replicated
from .optimizer import AdamW, build_optimizer


def loss_weights(cfg: UninextConfig) -> Dict[str, float]:
    """Weight table; keys it does not name (e.g. loss_boxiou) weigh 1.0."""
    l = cfg.loss
    return {"loss_ce": l.class_weight, "loss_bbox": l.l1_weight,
            "loss_giou": l.giou_weight, "loss_mask": l.mask_weight,
            "loss_dice": l.dice_weight, "loss_reid": l.reid_weight,
            "loss_reid_aux": l.reid_weight}


def weighted_total(losses: Dict[str, torch.Tensor], weights: Dict[str, float],
                   task_weight: float = 1.0) -> torch.Tensor:
    """Sum of the losses, each at the weight of the longest key it equals or
    extends by "_..." ("loss_reid_aux" takes its own entry, "loss_ce_3" and
    "loss_ce_enc" take "loss_ce"), times `task_weight`."""
    total = None
    for k, v in losses.items():
        base, best = k, -1
        for key in weights:
            if (k == key or k.startswith(key + "_")) and len(key) > best:
                base, best = key, len(key)
        term = v * weights.get(base, 1.0) * task_weight
        total = term if total is None else total + term
    return total


@dataclasses.dataclass
class TrainState:
    model: UninextDETR
    optimizer: AdamW
    generator: torch.Generator      # DN box noise and drop-path masks
    step: int = 0                   # micro-steps taken
    mesh: Optional[Mesh] = None     # the ranks of the step; None: one process


def build_train_state(cfg: UninextConfig, device="cuda", seed: int = 0,
                      template: bool = False, mesh: Optional[Mesh] = None,
                      tp: bool = False) -> TrainState:
    """A model with random weights from `seed` on `device` (the card unless
    the caller asks for another), with `template` the SOT/VOS template
    branch too (every branch, as the JAX package's `init_all_paths` makes a
    SOT state), its optimizer, and the generator of the step's random
    numbers (seeded from `seed` + 1). Over a `mesh` (the counterpart of
    `create_train_state(..., mesh, tp)`) every rank makes the same whole
    weights, broadcast over the data group to be sure, and with `tp` cuts
    the towers over the model group; the optimizer's moments follow the
    shards."""
    model = build_model(cfg, device, seed, template).train()
    if mesh is not None:
        replicated(list(model.parameters()) + list(model.buffers()), mesh)
        if tp:
            sharding.shard_module(model, mesh)
    generator = torch.Generator(device=torch.device(device))
    generator.manual_seed(seed + 1)
    return TrainState(model, build_optimizer(model, cfg.solver, mesh), generator,
                      mesh=mesh)


def loss_and_grads(model: UninextDETR, batch: Dict, weights: Dict[str, float],
                   generator: Optional[torch.Generator] = None,
                   dn_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   task: str = "detection", accumulate: bool = False,
                   mesh: Optional[Mesh] = None):
    """Forward in train mode, the weighted total and its backward: the
    gradients land in the parameters' `.grad`, replacing what is there
    unless `accumulate`. A pair batch (`data/video.py:collate_video` on the
    device: images_key, images_ref, targets_key, targets_ref and the key
    frame's img_mask, image_sizes and text) goes through
    `forward_video_train` (`uninext_tpu/engine/train.py:
    make_video_train_step`): the key frame's losses and the reid losses;
    with `task="sot"` through `forward_sot_train` (the ref frame's template
    as the prompt of a grounding pass on the key frame, no reid loss), the
    total scaled by `loss.sot_loss_scale`. Under a `mesh` the batch is this
    rank's rows (`forward_train`'s `mesh`). Returns (total, losses)."""
    video = "images_key" in batch
    if task == "sot" and not video:
        raise ValueError("the SOT step takes a (key, ref) pair batch")
    if not accumulate:
        model.zero_grad(set_to_none=True)
    if task == "sot":
        losses = model.forward_sot_train(
            batch["images_key"], batch["img_mask"], batch["image_sizes"],
            batch["targets_key"], batch["targets_ref"], batch["images_ref"],
            generator=generator, dn_noise=dn_noise, mesh=mesh)
    elif video:
        losses = model.forward_video_train(
            batch["images_key"], batch["img_mask"], batch["image_sizes"],
            batch["text_ids"], batch["text_mask"], batch["targets_key"],
            batch["targets_ref"], batch["images_ref"], task=task, generator=generator,
            mesh=mesh)
    else:
        losses = model.forward_train(batch["images"], batch["img_mask"],
                                     batch["image_sizes"], batch["text_ids"],
                                     batch["text_mask"], batch["targets"],
                                     generator=generator, dn_noise=dn_noise, task=task,
                                     mesh=mesh)
    total = weighted_total(losses, weights,
                           model.cfg.loss.sot_loss_scale if task == "sot" else 1.0)
    total.backward()
    return total, losses


def train_step(state: TrainState, batch: Dict, task: str = "detection"
               ) -> Dict[str, torch.Tensor]:
    """One micro-step on `batch` (images (B, H, W, 3), img_mask,
    image_sizes, text_ids, text_mask, targets as `forward_train` takes
    them, or a pair batch as `loss_and_grads` says); the optimizer updates
    on every `grad_accum_steps`-th. With `loss.boxinst` an image batch's
    targets get `step` = `state.step`, the micro-steps taken, which warms
    up BoxInst's pairwise term (JAX's `TrainState.step`). Returns the total
    and every loss, and on an update the grad norm before the clip, as
    tensors on the device. The step reads to the host only the encoder
    matching costs (Hungarian), simOTA's fix-up checks and the clip
    decision. With a frozen language
    model its parameters get no gradient; the optimizer takes a zero
    gradient for them and still decays them, as optax's chain does. Over
    `state.mesh` the batch is this rank's rows (`parallel/mesh.py:
    shard_batch`), and the returned losses are the whole batch's."""
    weights = loss_weights(state.model.cfg)
    if state.model.cfg.loss.boxinst and "targets" in batch:
        # the pairwise term's warm-up reads the micro-step (the reference
        # criterion counts its own forward calls, deformable_detr.py:521)
        batch = {**batch, "targets": {**batch["targets"], "step": state.step}}
    total, losses = loss_and_grads(state.model, batch, weights, state.generator,
                                   task=task, accumulate=state.optimizer.accumulating,
                                   mesh=state.mesh)
    grad_norm = state.optimizer.step()
    state.step += 1
    out = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
    out = dict(zip(out, comm.mean_over_data(list(out.values()), state.mesh)))
    if grad_norm is not None:
        out["grad_norm"] = grad_norm
    return out

