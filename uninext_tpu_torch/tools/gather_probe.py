"""Gather probes on the card: the MSDA inner problem, SAMP corner-packed rows
of 4 x D gathered per query from a small table and summed.

Port of tools/pallas_gather_probe.py, whose three Pallas kernels probed
which gather forms Mosaic accepted on the TPU. Here each is a kernel of
`ops/gather_fold.py`:

  probe_scalar_loop    kernel C0, one thread per output, scalar loads
  probe_vector_gather  kernel C1, one warp per query, 16-byte loads
  probe_onehot         kernel C2, the weighted sum by direct indexing (the
                       TPU built it as a one-hot x table product)

at the tool's shapes: a bf16 table of R = 5632 rows (1408 for the weighted
probe) x 128, M_STEPS x TQ queries of SAMP samples, int32 indices.

    python -m uninext_tpu_torch.tools.gather_probe [1] [2] [3]   # on the card
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.gather_fold import gather_rowsum_scalar, gather_rowsum_vec, gather_weighted
from . import event_ms

R = 5632          # table rows (levels 1-3 of the encoder)
R_ONEHOT = 1408   # table rows of the weighted probe
TQ = 512          # queries per step
SAMP = 16         # L*P samples per query
M_STEPS = 16      # steps (heads x query tiles)
D = 32


def probe_inputs(r=R, tq=TQ, samp=SAMP, m_steps=M_STEPS, weighted=False,
                 device="cuda", seed=0):
    """buf (r, 4D) bf16, idx (m_steps, tq, samp) int32 and, if `weighted`,
    w (m_steps, tq, samp, 4) fp32 in [0, 1), drawn from `seed`."""
    rng = np.random.RandomState(seed)
    buf = torch.from_numpy(rng.randn(r, 4 * D).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, r, (m_steps, tq, samp)).astype(np.int32))
    out = [buf.to(device, torch.bfloat16), idx.to(device)]
    if weighted:
        w = rng.rand(m_steps, tq, samp, 4).astype(np.float32)
        out.append(torch.from_numpy(w).to(device))
    return out


def _run(label, fn, args):
    """(output, ms on the card or None on the CPU), printing one line."""
    out = fn(*args)
    rows = args[1].numel()
    if out.is_cuda:
        ms = event_ms(lambda: fn(*args))
        print(f"{label}: {ms:.4f} ms for {rows} rows -> "
              f"{rows / ms / 1e3:.0f} rows/us ({torch.cuda.get_device_name(0)})")
    else:
        ms = None
        print(f"{label}: {rows} rows on the CPU (plain version), not timed")
    return out, ms


def probe_scalar_loop(device="cuda", **shape):
    return _run("probe1 scalar gather (C0)", gather_rowsum_scalar,
                probe_inputs(device=device, **shape))


def probe_vector_gather(device="cuda", **shape):
    return _run("probe2 vector gather (C1)", gather_rowsum_vec,
                probe_inputs(device=device, **shape))


def probe_onehot(device="cuda", r=R_ONEHOT, **shape):
    return _run(f"probe3 weighted gather (C2, R={r})", gather_weighted,
                probe_inputs(r=r, weighted=True, device=device, **shape))


PROBES = {"1": probe_scalar_loop, "2": probe_vector_gather, "3": probe_onehot}


def main(argv=()):
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: no CUDA device")
    for w in argv or PROBES:
        PROBES[w]()


if __name__ == "__main__":
    main(sys.argv[1:])
