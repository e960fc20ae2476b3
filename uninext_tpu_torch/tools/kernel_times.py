"""Times of the NMS kernel and of the fold B on the card, the two kernels
whose designs are compared between two checkouts of the port (the tree this
file sits in, or an older tree with this file copied into its `tools/`):

    python -m uninext_tpu_torch.tools.kernel_times [--repeat K] [--phases]

NMS at chip_smoke.py's set (900 boxes in 4 classes around 40 centres, IoU
threshold 0.7, every box valid): the wrapper eagerly (CUDA events around 20
calls, as chip_smoke.py times it), the wrapper over CUDA graph replays
(`tools.event_ms`), the kernels alone over graph replays (their inputs made
outside the graph), and the device time of each kernel one wrapper call
launches (torch.profiler). Fold B at the lab's shape (S = 16, N = 163840,
D = 32) in bf16 and fp32 over graph replays, and an empty kernel over graph
replays, the floor of any launch, where the library has one. Every time is
read K times (default 3). The first line is the card's name and power limit.

`--phases` also builds a copy of `csrc/nms.cu` whose thread 0 reads the SM
clock after each phase's barrier (keys loaded; sorted and scattered; class
runs found; suppression words written; sweep done) and prints the cycles
of each phase, with the copy's time over graph replays, for six inputs of
900 boxes: chip_smoke.py's set (4 classes), the same boxes in 1 class, in
80, each in its own, all invalid, and 4 classes of boxes that do not
overlap. The copy is built beside the libraries, in `build/`.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import _build, gather_fold as gf, nms
from . import event_ms, msda_v6_lab as lab


def nms_case(dev, seed=0, N=900, n_classes=4, n_centres=40):
    """(boxes (1, N, 4), scores (1, N), classes (1, N) int64): boxes of side
    0.1-0.2 around `n_centres` centres in [0.2, 0.8]^2, so many overlap."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.rand(1, n_centres, 2, device=dev, generator=g) * 0.6 + 0.2
    pick = torch.randint(0, n_centres, (1, N), device=dev, generator=g)
    cxcy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
    cxcy = cxcy + 0.01 * torch.randn(1, N, 2, device=dev, generator=g)
    wh = torch.rand(1, N, 2, device=dev, generator=g) * 0.1 + 0.1
    boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], -1)
    scores = torch.rand(1, N, device=dev, generator=g)
    classes = torch.randint(0, n_classes, (1, N), device=dev, generator=g)
    return boxes, scores, classes


def eager_ms(fn, iters=20, warmup=2) -> float:
    """Mean ms per call, CUDA events around `iters` eager calls: for a
    wrapper this small, mostly the host's time to launch it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_kernels_alone(boxes, scores, classes, thr):
    """A closure that launches the NMS library's kernels alone on buffers
    made here: the one kernel `nms_fused`, or, in an older tree, the
    bitmask and sweep kernels on inputs sorted outside the closure."""
    lib = _build.library("nms")
    B, N = scores.shape
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    P, I = _build.P, _build.I
    if hasattr(lib, "nms_fused"):
        fn = lib.nms_fused
        fn.argtypes = [P] * 5 + [I, I, _build.F, P]
        fn.restype = I

        def run():
            _build.check(lib, fn(boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(),
                                 None, keep.data_ptr(), B, N, thr,
                                 _build.stream_of(boxes)), "nms_fused")
        return run
    valid = torch.ones((B, N), dtype=torch.bool, device=boxes.device)
    order, b, c, v = (t.contiguous() for t in nms._sorted_inputs(boxes, scores, classes, valid))
    mask = torch.empty((B, N, -(-N // 64)), dtype=torch.int64, device=boxes.device)
    lib.nms_bitmask.argtypes = [P] * 4 + [I, I, _build.F, P]
    lib.nms_sweep.argtypes = [P] * 4 + [I, I, P]

    def run_two():
        stream = _build.stream_of(boxes)
        _build.check(lib, lib.nms_bitmask(b.data_ptr(), c.data_ptr(), v.data_ptr(),
                                          mask.data_ptr(), B, N, thr, stream), "nms_bitmask")
        _build.check(lib, lib.nms_sweep(mask.data_ptr(), v.data_ptr(), order.data_ptr(),
                                        keep.data_ptr(), B, N, stream), "nms_sweep")
    return run_two


def device_kernels(fn):
    """(name, device µs) of every kernel, copy and fill that one call of `fn`
    puts on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# (anchor in csrc/nms.cu, what goes before it, what goes after it): the clock
# is read after the barrier that ends each phase
_CLOCK = "  if (threadIdx.x == 0 && blockIdx.x == 0) clk[ph++] = clock64();\n"
_PHASE_PATCH = (
    ("bool* __restrict__ keep, int N, float thr) {",
     "", "\n  long long* clk = clock_out;\n  int ph = 0;\n" + _CLOCK),
    ("  const int V = __syncthreads_count(vi);\n", "", _CLOCK),
    ("    col[t] = 0ull;\n  }\n  __syncthreads();\n", "", _CLOCK),
    ("  if (t < V) run_end[t] = (int16_t)(run + 1 < runs ? run_start[run + 1] : V);\n"
     "  __syncthreads();\n", "", _CLOCK),
    ("  // 3. sweep", "  __syncthreads();\n" + _CLOCK, ""),
    ("  // 4. keep flags in the original order", _CLOCK, ""),
)
_PHASES = ("keys", "sort, scatter", "runs", "suppression words", "sweep")


def _phase_library():
    """The NMS library built from a copy of csrc/nms.cu with the phase
    clocks, read into the device array `clock_out` (a __device__ symbol)."""
    src = (_build.CSRC / "nms.cu").read_text()
    for anchor, before, after in _PHASE_PATCH:
        if anchor not in src:
            raise RuntimeError(f"kernel_times --phases: anchor not in nms.cu: {anchor!r}")
        src = src.replace(anchor, before + anchor + after, 1)
    src = src.replace("namespace {", "__device__ long long clock_out[8];\nnamespace {", 1)
    src += ('\nextern "C" int nms_phase_clocks(void* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, clock_out, sizeof(clock_out));\n}\n")
    out_dir = _build.BUILD_DIR / "nms_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "nms_phases.cu").write_text(src)
    lib = out_dir / "libnms_phases.so"
    subprocess.run([_build._nvcc(), *_build._COMMON_FLAGS, *_build.KERNELS["nms"],
                    "-I", str(_build.CSRC), "-o", str(lib), str(out_dir / "nms_phases.cu")],
                   check=True)
    return ctypes.CDLL(str(lib))


def nms_phases(dev):
    lib = _phase_library()
    P, I = _build.P, _build.I
    lib.nms_fused.argtypes = [P] * 5 + [I, I, _build.F, P]
    lib.nms_fused.restype = I
    lib.nms_phase_clocks.argtypes = [P]
    lib.nms_phase_clocks.restype = I
    boxes, scores, classes = nms_case(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    apart = boxes.clone()
    apart[..., :2] = torch.rand(1, 900, 2, device=dev, generator=g) * 10
    apart[..., 2:] = apart[..., :2] + 0.05
    cases = (("4 classes", boxes, classes, None),
             ("1 class", boxes, torch.zeros_like(classes), None),
             ("80 classes", boxes, torch.randint(0, 80, classes.shape, device=dev, generator=g),
              None),
             ("every box its own class", boxes, torch.arange(900, device=dev)[None], None),
             ("all invalid", boxes, classes, torch.zeros_like(classes, dtype=torch.bool)),
             ("4 classes, boxes apart", apart, classes, None))
    for label, b, c, v in cases:
        keep = torch.empty((1, 900), dtype=torch.bool, device=dev)

        def run():
            _build.check(lib, lib.nms_fused(b.data_ptr(), scores.data_ptr(), c.data_ptr(),
                                            None if v is None else v.data_ptr(), keep.data_ptr(),
                                            1, 900, 0.7, _build.stream_of(b)), "nms_fused")
        ms = event_ms(run, 50)
        run()
        torch.cuda.synchronize()
        if not torch.equal(keep, nms.batched_nms_plain(b, scores, c, 0.7, v)):
            raise AssertionError(f"nms phases, {label}: keep mask differs from the plain version")
        clk = (ctypes.c_longlong * 8)()
        _build.check(lib, lib.nms_phase_clocks(ctypes.addressof(clk)), "nms_phase_clocks")
        cycles = [clk[i + 1] - clk[i] for i in range(len(_PHASES))]
        print(f"[nms phases] {label}: {ms * 1e3:.1f} us over graph replays ({int(keep.sum())} "
              f"kept); cycles {', '.join(f'{n} {x}' for n, x in zip(_PHASES, cycles))}; "
              f"total {clk[len(_PHASES)] - clk[0]}")


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    repeat = int(argv[argv.index("--repeat") + 1]) if "--repeat" in argv else 3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    boxes, scores, classes = nms_case(dev)
    thr = 0.7
    want = nms.batched_nms_plain(boxes, scores, classes, thr)
    got = nms.batched_nms(boxes, scores, classes, thr)
    if not torch.equal(got, want):
        raise AssertionError("batched_nms: keep mask differs from the plain version")
    wrapper = lambda: nms.batched_nms(boxes, scores, classes, thr)
    alone = nms_kernels_alone(boxes, scores, classes, thr)
    for k in range(repeat):
        print(f"[nms] N=900 read {k}: wrapper eager {eager_ms(wrapper):.4f} ms, wrapper "
              f"graph {event_ms(wrapper, 50):.4f} ms, kernels alone graph "
              f"{event_ms(alone, 50):.4f} ms ({int(got.sum())} kept)")
    for name, us in device_kernels(wrapper):
        print(f"[nms] one wrapper call, profiler: {us:8.2f} us  {name[:120]}")
    for name, us in device_kernels(alone):
        print(f"[nms] kernels alone, profiler: {us:8.2f} us  {name[:120]}")

    g = torch.Generator(device=dev).manual_seed(3)
    S, D = lab.L * lab.P, lab.D
    N = lab.pad_q_fused(lab.B, lab.M, lab.LQ)[2]
    rows32 = torch.randn(S, N, 4 * D, device=dev, generator=g)
    w32 = torch.rand(S, N, 4, device=dev, generator=g)
    for dt in (torch.bfloat16, torch.float32):
        rows, w = rows32.to(dt), w32.to(dt)
        err = (gf.msda_fold(rows, w) - gf.msda_fold_plain(rows, w)).abs().max().item()
        times = [event_ms(lambda: gf.msda_fold(rows, w), 20) for _ in range(repeat)]
        print(f"[fold] S={S} N={N} D={D} {str(dt)[6:]}: max_abs_err {err:.3g}, graph "
              f"{', '.join(f'{t:.4f}' for t in times)} ms")
        del rows, w
    if hasattr(gf, "launch_floor"):
        times = [event_ms(gf.launch_floor, 200) for _ in range(repeat)]
        print(f"[floor] empty kernel, graph {', '.join(f'{t:.5f}' for t in times)} ms")
    if "--phases" in argv:
        nms_phases(dev)


if __name__ == "__main__":
    main(sys.argv[1:])
