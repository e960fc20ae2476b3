"""Process groups of a (data, model) mesh, mirroring
`uninext_tpu/parallel/mesh.py`.

The JAX package lays its devices out as one `Mesh` of shape (n/k, k) with
axes ("data", "model") and lets GSPMD insert the collectives. Here every
rank is one process with one device, and the mesh is a pair of
`torch.distributed` groups per rank: its *data group* (the ranks that hold
the same model shard and split the batch) and its *model group* (the ranks
that split the heavy towers' heads and hold the same rows of the batch).
Ranks are laid out as JAX's devices are: rank = data_rank * k + model_rank,
so the ranks of one model group are contiguous.

The backend is always the caller's: NCCL refuses two ranks on one device,
so ranks that share one card use gloo (which all-reduces, broadcasts and
all-gathers CUDA tensors through the host); ranks on cards of their own use
NCCL; the CPU tests use gloo.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def rank_device(local_rank: int, device: Optional[str] = None) -> torch.device:
    """The device of a rank: `cuda:{local_rank % device_count}` unless the
    caller asks for another (the tests ask for the CPU)."""
    if device is not None:
        return torch.device(device)
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def init_distributed(backend: str, device: Optional[str] = None) -> torch.device:
    """The counterpart of `jax.distributed.initialize`: join the process
    group of `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` (and
    `LOCAL_RANK`, default `RANK`) over `backend`, which is printed. Returns
    the rank's device (`rank_device`), made current when it is a card."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(local, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    print(f"[parallel] rank {rank} of {world}: backend {backend}, device {dev}",
          flush=True)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data, model) mesh. A group is None where its
    size is 1 (no collective runs over it)."""
    ranks: tuple                 # the global ranks of the mesh, in layout order
    rank: int                    # this rank's global rank
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    group: Any                   # every rank of the mesh
    data_group: Any
    model_group: Any
    data_ranks: tuple            # the global ranks of this rank's data group

    @property
    def size(self) -> int:
        return self.data_size * self.model_size


def create_mesh(model_parallel_size: int = 1,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of `ranks` (default: every rank of the process group) as
    (n/k, k) with k = `model_parallel_size`, as `create_mesh` there. Every
    rank of the process group must call it (each group is created on every
    rank); a rank outside `ranks` gets None."""
    world = dist.get_world_size()
    ranks = tuple(range(world) if ranks is None else ranks)
    n, k = len(ranks), model_parallel_size
    if n % k:
        raise ValueError(f"{n} ranks do not split into model groups of {k}")
    grid = [ranks[i * k:(i + 1) * k] for i in range(n // k)]
    me = dist.get_rank()

    def group(members):
        g = dist.new_group(list(members)) if len(members) > 1 else None
        return g if me in members else None

    whole = group(ranks)
    model_groups = [group(row) for row in grid]
    data_cols = [tuple(row[j] for row in grid) for j in range(k)]
    data_groups = [group(col) for col in data_cols]
    if me not in ranks:
        return None
    i = ranks.index(me)
    d, m = divmod(i, k)
    return Mesh(ranks=ranks, rank=me, data_size=n // k, model_size=k,
                data_rank=d, model_rank=m, group=whole,
                data_group=data_groups[m], model_group=model_groups[d],
                data_ranks=data_cols[m])


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of a global batch (a nested dict of tensors or
    arrays with the batch first): rows data_rank * b ... (data_rank + 1) * b
    of B = data_size * b; other leaves as they are."""
    if mesh is None or mesh.data_size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if not hasattr(batch, "shape") or batch.ndim == 0:
        return batch
    B = batch.shape[0]
    if B % mesh.data_size:
        raise ValueError(f"batch of {B} does not split over {mesh.data_size} data ranks")
    b = B // mesh.data_size
    return batch[mesh.data_rank * b:(mesh.data_rank + 1) * b]


@torch.no_grad()
def replicated(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Make `tensors` equal over the data group: a broadcast, in place,
    from the data group's first rank."""
    if mesh is None or mesh.data_group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=mesh.data_ranks[0], group=mesh.data_group)


def rows_of_draw(draw, n_local: int, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """`draw(n)` of the whole batch (n = data_size * n_local rows along
    `dim`), cut to this rank's rows: every rank of a model group draws the
    same numbers, and the k-rank step sees the one-process step's draws."""
    if mesh is None or mesh.data_size == 1:
        return draw(n_local)
    whole = draw(n_local * mesh.data_size)
    return whole.narrow(dim, mesh.data_rank * n_local, n_local)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nprocs: int, port: int, backend: str, device, fn, args,
               results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dev = init_distributed(backend, device)
    try:
        results.put((rank, fn(dev, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, backend: str, device: Optional[str], *args) -> List[Any]:
    """Run `fn(device, *args)` on `nprocs` new ranks, started with the
    `spawn` method, which meet at a free localhost port over `backend`
    (`init_distributed`; `device` as `rank_device` takes it). Waits for all;
    a rank's exception is raised here and stops the others. Returns each
    rank's result in rank order (picklable; tensors stay in the ranks). `fn` must be importable
    by the new processes (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    ranks = torch.multiprocessing.start_processes(
        _rank_main, args=(nprocs, _free_port(), backend, device, fn, args, results),
        nprocs=nprocs, join=False, start_method="spawn")
    out = {}
    done = False
    while not done:
        done = ranks.join(timeout=0.2)      # raises a rank's exception
        while not results.empty():          # drained before the ranks are joined
            r, res = results.get()
            out[r] = res
    return [out[r] for r in range(nprocs)]
