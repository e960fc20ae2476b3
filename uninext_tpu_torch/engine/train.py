"""The detection train step, mirroring `uninext_tpu/engine/train.py`:
batch -> loss dict -> weighted sum -> backward -> global-norm clip ->
per-group AdamW. Compute runs in the config's dtype (bf16) with fp32
parameters and optimizer state, as in the JAX package; no loss scaling.

`Trainer`, hooks, checkpointing and the data loader are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import UninextConfig
from ..models.detr import UninextDETR, build_model
from .optimizer import AdamW, build_optimizer


def loss_weights(cfg: UninextConfig) -> Dict[str, float]:
    """Weight table; keys it does not name (e.g. loss_boxiou) weigh 1.0."""
    l = cfg.loss
    return {"loss_ce": l.class_weight, "loss_bbox": l.l1_weight,
            "loss_giou": l.giou_weight, "loss_mask": l.mask_weight,
            "loss_dice": l.dice_weight, "loss_reid": l.reid_weight,
            "loss_reid_aux": l.reid_weight}


def weighted_total(losses: Dict[str, torch.Tensor], weights: Dict[str, float]
                   ) -> torch.Tensor:
    """Sum of the losses, each at the weight of the longest key it equals or
    extends by "_..." ("loss_reid_aux" takes its own entry, "loss_ce_3" and
    "loss_ce_enc" take "loss_ce")."""
    total = None
    for k, v in losses.items():
        base, best = k, -1
        for key in weights:
            if (k == key or k.startswith(key + "_")) and len(key) > best:
                base, best = key, len(key)
        term = v * weights.get(base, 1.0)
        total = term if total is None else total + term
    return total


@dataclasses.dataclass
class TrainState:
    model: UninextDETR
    optimizer: AdamW
    generator: torch.Generator      # DN box noise and drop-path masks


def build_train_state(cfg: UninextConfig, device="cuda", seed: int = 0
                      ) -> TrainState:
    """A model with random weights from `seed` on `device` (the card unless
    the caller asks for another), its optimizer, and the generator of the
    step's random numbers (seeded from `seed` + 1)."""
    model = build_model(cfg, device, seed).train()
    generator = torch.Generator(device=torch.device(device))
    generator.manual_seed(seed + 1)
    return TrainState(model, build_optimizer(model, cfg.solver), generator)


def loss_and_grads(model: UninextDETR, batch: Dict, weights: Dict[str, float],
                   generator: Optional[torch.Generator] = None,
                   dn_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Forward in train mode, the weighted total and its backward: the
    gradients land in the parameters' `.grad`. Returns (total, losses)."""
    model.zero_grad(set_to_none=True)
    losses = model.forward_train(batch["images"], batch["img_mask"],
                                 batch["image_sizes"], batch["text_ids"],
                                 batch["text_mask"], batch["targets"],
                                 generator=generator, dn_noise=dn_noise)
    total = weighted_total(losses, weights)
    total.backward()
    return total, losses


def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
    """One optimizer update on `batch` (images (B, H, W, 3), img_mask,
    image_sizes, text_ids, text_mask, targets as `forward_train` takes
    them). Returns the total, every loss and the grad norm before the clip,
    as tensors on the device. The step reads to the host only the encoder
    matching costs (Hungarian), simOTA's fix-up checks and the clip
    decision."""
    weights = loss_weights(state.model.cfg)
    total, losses = loss_and_grads(state.model, batch, weights, state.generator)
    grad_norm = state.optimizer.step()
    return {"total_loss": total.detach(), "grad_norm": grad_norm,
            **{k: v.detach() for k, v in losses.items()}}
