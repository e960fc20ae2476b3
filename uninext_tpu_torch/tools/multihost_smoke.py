"""Two-process data-parallel smoke, the port of `tools/multihost_smoke.py`:
two processes (started with the `spawn` method) meet at a localhost
rendezvous (`parallel/mesh.py:init_distributed`), form one (2, 1) mesh,
each takes its own rows of one batch and the ranks take one real train
step of a small `tiny_test_config` together. It passes when the losses and
the grad norm each rank reports (the whole batch's) and the updated weights
are the same on both ranks, and the losses and grad norm equal the
one-process step's on the whole batch to 1e-5. The images are 128x128: at
48x64 the P6 level is 1x1, where GroupNorm over 8 values turns the
rounding of another batch split into 1e-2 of its input projection's
gradient.

    python -m uninext_tpu_torch.tools.multihost_smoke --backend gloo [--device cpu]

The ranks run on the card unless `--device cpu`; two ranks on one card need
`--backend gloo` (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict

import numpy as np
import torch

B, H, W, T = 2, 128, 128, 32


def small_config():
    from ..config import tiny_test_config
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, enc_layers=1, dec_layers=1, num_queries=24, dn_number=4))


def whole_batch(cfg, device) -> Dict:
    """B images of their own data, three boxes each, with masks."""
    r = np.random.RandomState(100)
    G = cfg.data.max_insts
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    pm = np.zeros((B, G, T), bool)
    boxes[:, :3] = [0.4, 0.5, 0.2, 0.3]
    boxes[1, 1] = [0.3, 0.6, 0.3, 0.2]
    valid[:, :3] = True
    valid[1, 2] = False
    pm[:, :3, 2] = True
    t = lambda x: torch.from_numpy(x).to(device)
    return {"images": t(r.randn(B, H, W, 3).astype(np.float32)),
            "img_mask": t(np.zeros((B, H, W), bool)),
            "image_sizes": t(np.array([[H, W]] * B, np.int32)),
            "text_ids": t(r.randint(0, 1000, (B, T))).long(),
            "text_mask": t(np.ones((B, T), np.int32)),
            "targets": {"boxes": t(boxes), "valid": t(valid), "positive_map": t(pm),
                        "masks": t((r.rand(B, G, H // 4, W // 4) > 0.7).astype(np.float32)),
                        "has_masks": True}}


def one_step(device, mesh=None):
    """One train step from seed 0; the rank's rows under a `mesh`. Returns
    the step's losses and grad norm, and the updated model."""
    from ..engine.train import build_train_state, train_step
    from ..parallel.mesh import shard_batch
    cfg = small_config()
    state = build_train_state(cfg, device, seed=0, mesh=mesh)
    metrics = train_step(state, shard_batch(whole_batch(cfg, device), mesh))
    return {k: float(v) for k, v in metrics.items()}, state.model


def rank(device, _unused=None):
    """A rank's step: its losses, and whether its updated weights are
    bit-equal to the mesh's first rank's."""
    import torch.distributed as dist
    from ..parallel.mesh import create_mesh
    mesh = create_mesh(1)
    metrics, model = one_step(device, mesh)
    same = True
    for p in model.parameters():
        first = p.detach().clone()
        dist.broadcast(first, src=mesh.ranks[0], group=mesh.group)
        same &= torch.equal(first, p)
    return metrics, same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu (default: the ranks' cards)")
    ap.add_argument("--nprocs", type=int, default=2)
    args = ap.parse_args(argv)
    from ..parallel.mesh import launch, rank_device
    if args.device != "cpu":
        from ..ops import _build
        _build.build_all()          # here, so that the ranks only load the libraries
    ranks = launch(rank, args.nprocs, args.backend, args.device, None)
    one, _ = one_step(rank_device(0, args.device))
    ok = True
    for r, (metrics, same) in enumerate(ranks):
        diff = max(abs(metrics[k] - one[k]) / max(1.0, abs(one[k])) for k in one)
        same &= metrics == ranks[0][0]
        print(f"RANK {r}: step_loss={metrics['total_loss']:.6f} grad_norm="
              f"{metrics['grad_norm']:.6f} (one process {one['total_loss']:.6f}, "
              f"{one['grad_norm']:.6f}); largest relative difference of a loss or the norm "
              f"{diff:.2e}; losses and weights equal to rank 0's: {same}")
        ok &= same and diff < 1e-5
    print("MULTIHOST SMOKE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
