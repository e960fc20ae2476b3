"""Weighted sums of gathered corner-packed rows: the kernels of the two MSDA
labs (`uninext_tpu_torch/tools/msda_v6_lab.py`, `.../tools/gather_probe.py`),
all four in `csrc/gather_fold.cu`.

A corner-packed row holds the four bilinear corners of a sample side by
side, (4 * D,) = [corner 0 | corner 1 | corner 2 | corner 3]. The functions:

  msda_fold(g, w)               (kernel B)  out[n, d] = sum_{s,c} g[s, n, c*D + d] * w[s, n, c]
  gather_rowsum_scalar(buf, idx) (C0) and
  gather_rowsum_vec(buf, idx)   (C1)        out[m, q, d] = sum_{s,c} buf[idx[m, q, s], c*D + d]
  gather_weighted(buf, idx, w)  (C2)        out[m, q, d] = sum_{s,c} buf[idx[m, q, s], c*D + d] * w[m, q, s, c]

Tables and g are fp32 or bf16, B's weights take g's dtype, C2's are fp32,
indices int32 in [0, rows of buf) (not checked, as on the TPU); outputs
are fp32. C0 and C1 compute the same function by a scalar and a vectorised
kernel, as the TPU probes they replace did.
"""
from __future__ import annotations

import torch

from . import _build


def _dispatch(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); raises for other or mixed devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _check(name: str, t: torch.Tensor, shape, dtypes) -> None:
    """Raise unless t has `shape` (None: any), a dtype of `dtypes` and is
    contiguous."""
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_TABLE = (torch.float32, torch.bfloat16)


def _call(fn_name: str, argtypes, *args) -> None:
    fn = _build.function("gather_fold", fn_name, tuple(argtypes))
    _build.check(_build.library("gather_fold"), fn(*args), fn_name)


# ---- B ---------------------------------------------------------------------

def msda_fold_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    S, N, D4 = g.shape
    return torch.einsum("sncd,snc->nd", g.float().reshape(S, N, 4, D4 // 4),
                        w.float())


def msda_fold(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel B on CUDA tensors, the plain version on CPU tensors.
    g: (S, N, 4D) gathered rows, w: (S, N, 4) in g's dtype; returns (N, D)
    fp32. The kernel reads 16-byte vectors: D must be a multiple of 8 up
    to 256 in bf16, or of 4 up to 128 in fp32, and g and w 16-byte aligned
    (ValueError before the launch otherwise)."""
    if not _dispatch("msda_fold", g, w):
        return msda_fold_plain(g, w)
    if g.dim() != 3 or g.shape[2] % 4:
        raise ValueError(f"msda_fold: g must be (S, N, 4 * D), got {tuple(g.shape)}")
    S, N, D4 = g.shape
    _check("msda_fold g", g, None, _TABLE)
    _check("msda_fold w", w, (S, N, 4), (g.dtype,))
    vec = 16 // g.element_size()
    if (D4 // 4) % vec or D4 // 4 > 32 * vec:
        raise ValueError(f"msda_fold: D must be a multiple of {vec} up to {32 * vec} "
                         f"in {g.dtype}, got {D4 // 4}")
    if g.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("msda_fold: g and w must be 16-byte aligned")
    out = torch.empty((N, D4 // 4), dtype=torch.float32, device=g.device)
    _call("msda_fold", [_build.P] * 3 + [_build.I, _build.LL, _build.I, _build.I, _build.P],
          g.data_ptr(), w.data_ptr(), out.data_ptr(), S, N, D4 // 4,
          _build.dtype_code(g), _build.stream_of(g))
    msda_fold.launches += 1
    return out


# ---- C0, C1, C2 ------------------------------------------------------------

def _gathered(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, TQ, SAMP, 4, D) fp32 rows of buf at idx."""
    D = buf.shape[1] // 4
    return buf.float()[idx.long()].reshape(*idx.shape, 4, D)


def gather_rowsum_plain(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _gathered(buf, idx).sum((2, 3))


def gather_weighted_plain(buf: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mqscd,mqsc->mqd", _gathered(buf, idx), w.float())


def _check_gather(name, buf, idx):
    if buf.dim() != 2 or buf.shape[1] % 4:
        raise ValueError(f"{name}: buf must be (R, 4 * D), got {tuple(buf.shape)}")
    _check(f"{name} buf", buf, None, _TABLE)
    _check(f"{name} idx", idx, None, (torch.int32,))
    if idx.dim() != 3:
        raise ValueError(f"{name}: idx must be (M, TQ, SAMP), got {tuple(idx.shape)}")
    M, TQ, SAMP = idx.shape
    return M, TQ, SAMP, buf.shape[1] // 4


def gather_rowsum_scalar(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel C0 on CUDA tensors, the plain version on CPU tensors.
    buf: (R, 4D), idx: (M, TQ, SAMP) int32; returns (M, TQ, D) fp32."""
    if not _dispatch("gather_rowsum_scalar", buf, idx):
        return gather_rowsum_plain(buf, idx)
    M, TQ, SAMP, D = _check_gather("gather_rowsum_scalar", buf, idx)
    out = torch.empty((M, TQ, D), dtype=torch.float32, device=buf.device)
    _call("gather_rowsum_scalar", [_build.P] * 3 + [_build.LL] + [_build.I] * 3 + [_build.P],
          buf.data_ptr(), idx.data_ptr(), out.data_ptr(), M * TQ, SAMP, D,
          _build.dtype_code(buf), _build.stream_of(buf))
    gather_rowsum_scalar.launches += 1
    return out


def gather_rowsum_vec(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel C1 (D = 32 only) on CUDA tensors, the plain version on CPU
    tensors; the function of `gather_rowsum_scalar`."""
    if not _dispatch("gather_rowsum_vec", buf, idx):
        return gather_rowsum_plain(buf, idx)
    M, TQ, SAMP, D = _check_gather("gather_rowsum_vec", buf, idx)
    if D != 32:
        raise ValueError(f"gather_rowsum_vec: the kernel takes D = 32, got {D}")
    out = torch.empty((M, TQ, D), dtype=torch.float32, device=buf.device)
    _call("gather_rowsum_vec", [_build.P] * 3 + [_build.LL] + [_build.I] * 2 + [_build.P],
          buf.data_ptr(), idx.data_ptr(), out.data_ptr(), M * TQ, SAMP,
          _build.dtype_code(buf), _build.stream_of(buf))
    gather_rowsum_vec.launches += 1
    return out


def gather_weighted(buf: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Kernel C2 on CUDA tensors, the plain version on CPU tensors.
    buf: (R, 4D), idx: (M, TQ, SAMP) int32, w: (M, TQ, SAMP, 4) fp32;
    returns (M, TQ, D) fp32."""
    if not _dispatch("gather_weighted", buf, idx, w):
        return gather_weighted_plain(buf, idx, w)
    M, TQ, SAMP, D = _check_gather("gather_weighted", buf, idx)
    _check("gather_weighted w", w, (M, TQ, SAMP, 4), (torch.float32,))
    out = torch.empty((M, TQ, D), dtype=torch.float32, device=buf.device)
    _call("gather_weighted", [_build.P] * 4 + [_build.LL] + [_build.I] * 3 + [_build.P],
          buf.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), M * TQ,
          SAMP, D, _build.dtype_code(buf), _build.stream_of(buf))
    gather_weighted.launches += 1
    return out


def launch_floor() -> None:
    """One launch of an empty kernel on the current stream: its time over
    CUDA graph replays is the floor under any kernel's."""
    _call("launch_floor", [_build.P], torch.cuda.current_stream().cuda_stream)


msda_fold.launches = 0
gather_rowsum_scalar.launches = 0
gather_rowsum_vec.launches = 0
gather_weighted.launches = 0
