"""What the command-line tools share (`train_net`, `eval_video`, `demo`,
`eval_seginw`, `vot_integration`): the device a tool runs on, the config by
its name, and the weights a tool loads.

Every tool runs on the card unless it is given `--device cpu`; without a
card it raises rather than falling back to the CPU. Weights come from a
reference `.pth` (`--weights`, `--init-weights`; `engine/convert.py:
load_reference_checkpoint`, which refuses a BERT table under the hash
vocab) or from a directory of `engine/checkpoint.py:CheckpointManager`
(where the JAX tools take an orbax directory), each loaded by name and
shape with its report.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from .. import config as config_mod
from ..config import UninextConfig
from ..engine.checkpoint import CheckpointManager
from ..engine.convert import (load_reference_checkpoint, load_reference_state_dict,
                              read_reference_checkpoint)


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                        help="cuda (the card, default) or cpu")


def device_of(name: str) -> torch.device:
    """The tool's device; "cuda" without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def config_by_name(name: str) -> UninextConfig:
    """A preset of `config.py` by its function's name."""
    return getattr(config_mod, name)()


def restore_from_dir(model: torch.nn.Module, directory: str) -> Dict:
    """Load the weights of the latest checkpoint in a `CheckpointManager`
    directory into `model` by name and shape (the branches that directory's
    model lacks keep their values, as the JAX demo merges a sub-tree);
    raises when the directory holds none."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint in {directory}")
    return load_reference_state_dict(model, read_reference_checkpoint(mgr.path(step)))


def load_weights(model: torch.nn.Module, pth: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None) -> Optional[Dict]:
    """A reference `.pth` if given, else the latest checkpoint of a
    directory if given; returns the load's report (None: neither)."""
    if pth:
        return load_reference_checkpoint(model, pth)
    if checkpoint_dir:
        return restore_from_dir(model, checkpoint_dir)
    return None
