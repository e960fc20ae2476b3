"""Row gathers by address from a small table: the kernels of the DMA probe
lab (`uninext_tpu_torch/tools/dma_probe.py`), both in `csrc/dma_gather.cu`.

  dma_gather_rowsum(buf, idx, k, rows_out)  (C3)
      out[rows_out*t + r, :] = sum_{j<k} buf[idx[k*t + j], :]   for r < rows_out
  dma_block_gather(buf, idx)                (C4)
      out[8*i + r, :] = buf[8*idx[i] + r, :]                    for r < 8

Tables are fp32 or bf16 (R, D4), 16-byte aligned and contiguous, with rows
of a multiple of 16 bytes (C3's bulk copies need both; C4 takes the same);
indices int32, not checked (C3's in [0, R), C4's in [0, R // 8), as on the
TPU); outputs fp32.
"""
from __future__ import annotations

import torch

from . import _build
from .gather_fold import _check, _dispatch

_TABLE = (torch.float32, torch.bfloat16)
BLOCK_ROWS = 8
_SMEM_BYTES = 48 * 1024      # C3's K rows in one block's shared memory


def dma_gather_rowsum_plain(buf: torch.Tensor, idx: torch.Tensor, k: int = 32,
                            rows_out: int = 8) -> torch.Tensor:
    s = buf.float()[idx.long().view(-1, k)].sum(1)
    return s[:, None].expand(-1, rows_out, -1).reshape(-1, buf.shape[1])


def dma_block_gather_plain(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    R, D4 = buf.shape
    blocks = buf[:BLOCK_ROWS * (R // BLOCK_ROWS)].float().view(-1, BLOCK_ROWS, D4)
    return blocks[idx.long()].reshape(-1, D4)


def _check_table(name: str, buf: torch.Tensor, idx: torch.Tensor) -> None:
    _check(f"{name} buf", buf, None, _TABLE)
    _check(f"{name} idx", idx, None, (torch.int32,))
    if buf.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: buf must be (R, D4) and idx 1-D, got "
                         f"{tuple(buf.shape)} and {tuple(idx.shape)}")
    if buf.data_ptr() % 16 or (buf.shape[1] * buf.element_size()) % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned table with "
                         f"rows of a multiple of 16 bytes")


def _call(fn_name: str, argtypes, *args) -> None:
    fn = _build.function("dma_gather", fn_name, tuple(argtypes))
    _build.check(_build.library("dma_gather"), fn(*args), fn_name)


def dma_gather_rowsum(buf: torch.Tensor, idx: torch.Tensor, k: int = 32,
                      rows_out: int = 8, l2_resident: bool = False) -> torch.Tensor:
    """Kernel C3 on CUDA tensors, the plain version on CPU tensors.
    buf: (R, D4), idx: (tiles * k,) int32; returns (tiles * rows_out, D4)
    fp32. `l2_resident` gives the kernel's row copies an L2 evict_last
    policy (the lab's probe 2); the function is the same."""
    if not _dispatch("dma_gather_rowsum", buf, idx):
        return dma_gather_rowsum_plain(buf, idx, k, rows_out)
    _check_table("dma_gather_rowsum", buf, idx)
    if idx.numel() == 0 or idx.numel() % k:
        raise ValueError(f"dma_gather_rowsum: {idx.numel()} indices are not tiles of {k}")
    if k * buf.shape[1] * buf.element_size() > _SMEM_BYTES:
        raise ValueError(f"dma_gather_rowsum: {k} rows of {buf.shape[1]} exceed "
                         f"{_SMEM_BYTES} bytes of shared memory")
    tiles, D4 = idx.numel() // k, buf.shape[1]
    out = torch.empty((tiles * rows_out, D4), dtype=torch.float32, device=buf.device)
    _call("dma_gather_rowsum", [_build.P] * 3 + [_build.I] * 6 + [_build.P],
          buf.data_ptr(), idx.data_ptr(), out.data_ptr(), tiles, k, D4, rows_out,
          int(l2_resident), _build.dtype_code(buf), _build.stream_of(buf))
    dma_gather_rowsum.launches += 1
    return out


def dma_block_gather(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel C4 on CUDA tensors, the plain version on CPU tensors.
    buf: (R, D4), idx: (n,) int32 block indices; returns (8n, D4) fp32."""
    if not _dispatch("dma_block_gather", buf, idx):
        return dma_block_gather_plain(buf, idx)
    _check_table("dma_block_gather", buf, idx)
    if idx.numel() == 0:
        raise ValueError("dma_block_gather: no indices")
    D4 = buf.shape[1]
    out = torch.empty((idx.numel() * BLOCK_ROWS, D4), dtype=torch.float32,
                      device=buf.device)
    _call("dma_block_gather", [_build.P] * 3 + [_build.LL, _build.I, _build.I, _build.P],
          buf.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), D4,
          _build.dtype_code(buf), _build.stream_of(buf))
    dma_block_gather.launches += 1
    return out


dma_gather_rowsum.launches = 0
dma_block_gather.launches = 0
