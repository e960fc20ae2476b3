"""Build and bind the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`. Tensors travel as
`data_ptr()` integers and the stream as
`torch.cuda.current_stream().cuda_stream`, each declared `c_void_p` so no
pointer is cut to 32 bits. Every entry point launches on that stream,
allocates nothing and returns `cudaGetLastError()`; `check` raises on a
nonzero return.

The build happens at first use, from the repository's sources only, into
`build/uninext_tpu_torch/` at the repository root. The library's file name
carries a hash of its sources and flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is. A loaded library is kept for the life
of the process (`library` is memoised), so a launch costs no file reads.
What nvcc printed (ptxas's registers and spills, for the libraries built
with `-Xptxas -v`) is kept beside the library (`build_log`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uninext_tpu_torch"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC")

# per library: extra nvcc flags. NMS compares IoU near its threshold, so its
# arithmetic must round op by op as the CPU does: no fused multiply-adds.
# The tensor-core routes of kernels A and A-bwd, and MSDA with MSDA-bwd,
# report their registers and spills.
KERNELS: Dict[str, Tuple[str, ...]] = {
    "rel_pos_flash_attn_mma": ("-Xptxas", "-v"),
    "rel_pos_flash_attn": (),
    "rel_pos_flash_attn_bwd_mma": ("-Xptxas", "-v"),
    "rel_pos_flash_attn_bwd": (),
    "ms_deform_attn": ("-Xptxas", "-v"),
    "nms": ("-fmad=false",),
    "gather_fold": (),
    "dma_gather": (),
}

# dtype codes of the C entry points (UNINEXT_F32 / UNINEXT_BF16 in common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources(name: str):
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(_COMMON_FLAGS + KERNELS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start `nvcc` for `csrc/<name>.cu` unless its library exists. Returns
    (library path, running process or None, command, temporary output)."""
    out = library_path(name)
    if out.exists():
        return out, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_COMMON_FLAGS, *KERNELS[name], "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, proc, cmd, tmp


def _finish_build(name: str, out: Path, proc, cmd, tmp) -> Path:
    if proc is None:
        return out
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)        # atomic: concurrent builders never see half a file
    return out


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless the library for its current sources
    exists. Returns the library's path."""
    return _finish_build(name, *_start_build(name))


def build_all() -> None:
    """Build every library at once: one `nvcc` per source, all started
    together, then wait for each."""
    started = {name: _start_build(name) for name in KERNELS}
    try:
        for name, job in started.items():
            _finish_build(name, *job)
    finally:                    # on a failed build, stop the others' nvcc too
        for _, proc, _, _ in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def build_log(name: str) -> str:
    """What nvcc printed when it built the current library of `name`."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = ctypes.CDLL(str(build(name)))
    lib.uninext_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uninext_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, fn_name: str, argtypes: tuple):
    """Entry point `fn_name` of library `name`, with its argument types set
    (once per entry point) and an int return, the CUDA error code."""
    fn = getattr(library(name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = I
    return fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.uninext_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(t) -> int:
    """The C dtype code of tensor `t`; raises for other dtypes."""
    code = DTYPE_CODES.get(str(t.dtype).removeprefix("torch."))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
