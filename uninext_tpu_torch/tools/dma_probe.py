"""DMA probes on the card: gathers of corner-packed rows (4 corners x 32
values) from the level-0 table of an 800x1216 image, by row and by 8-row
block.

Port of tools/pallas_dma_probe.py, whose three Pallas kernels probed which
dynamic-address copy forms Mosaic accepted on the TPU. Here each is a kernel
of `ops/dma_gather.py`:

  probe 1  kernel C3: per tile, K row copies into shared memory as bulk
           async copies on one mbarrier, then a column sum (the TPU's K
           async DMAs from HBM)
  probe 2  kernel C3 with an L2 evict_last policy on the copies (the TPU's
           table resident in VMEM; an SM cannot hold the 4.0 MB table)
  probe 3  kernel C4: one 8-row block per index read from memory (the
           TPU's BlockSpec index map over a scalar-prefetched index)

at the tool's shapes: a bf16 table of R = 15708 rows x D4 = 128, TILES
tiles of K rows (131072 row indices), and as many 8-row block indices in
[0, R // 8) for probe 3.

    python -m uninext_tpu_torch.tools.dma_probe [1] [2] [3]   # on the card
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..ops.dma_gather import BLOCK_ROWS, dma_block_gather, dma_gather_rowsum
from . import event_ms

R = 15708         # level-0 table rows at 800x1216 (one head)
D4 = 128          # row width: 4 corners x 32
K = 32            # rows per tile
TILES = 4096      # tiles: K * TILES = 131072 rows gathered


def probe_inputs(r=R, d4=D4, k=K, tiles=TILES, blocks=False, device="cuda", seed=0):
    """buf (r, d4) bf16 and idx (tiles * k,) int32, drawn from `seed`: row
    indices in [0, r), or with `blocks` 8-row block indices in [0, r // 8)."""
    rng = np.random.RandomState(seed)
    buf = torch.from_numpy(rng.randn(r, d4).astype(np.float32))
    hi = r // BLOCK_ROWS if blocks else r
    idx = torch.from_numpy(rng.randint(0, hi, (tiles * k,)).astype(np.int32))
    return buf.to(device, torch.bfloat16), idx.to(device)


def _run(label, fn, buf, idx, unit):
    """(output, ms on the card or None on the CPU), printing one line: one
    `unit` (a row, or an 8-row block) per index."""
    out = fn(buf, idx)
    n = idx.numel()
    if out.is_cuda:
        ms = event_ms(lambda: fn(buf, idx), 10)
        print(f"{label}: {ms:.4f} ms for {n} {unit}s -> {n / ms / 1e3:.0f} {unit}s/us "
              f"({torch.cuda.get_device_name(0)})")
    else:
        ms = None
        print(f"{label}: {n} {unit}s on the CPU (plain version), not timed")
    return out, ms


def probe_dma(device="cuda", l2_resident=False, r=R, d4=D4, k=K, tiles=TILES):
    buf, idx = probe_inputs(r, d4, k, tiles, device=device)
    name = "probe2 dma, L2 evict_last" if l2_resident else "probe1 dma"
    fn = functools.partial(dma_gather_rowsum, k=k, l2_resident=l2_resident)
    return _run(f"{name} (C3, R={r}, {tiles} tiles of {k})", fn, buf, idx, "row")


def probe_index_map(device="cuda", r=R, d4=D4, k=K, tiles=TILES):
    buf, idx = probe_inputs(r, d4, k, tiles, blocks=True, device=device)
    return _run(f"probe3 block gather (C4, R={r}, blocks of {BLOCK_ROWS} rows)",
                dma_block_gather, buf, idx, "block")


PROBES = {"1": probe_dma, "2": functools.partial(probe_dma, l2_resident=True),
          "3": probe_index_map}


def main(argv=()):
    if not torch.cuda.is_available():
        raise SystemExit("dma_probe: no CUDA device")
    for w in argv or PROBES:
        PROBES[w]()


if __name__ == "__main__":
    main(sys.argv[1:])
