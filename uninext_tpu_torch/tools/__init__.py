"""Ports of the JAX package's lab tools whose kernels were written in
Pallas: `msda_v6_lab` (tools/msda_v6_lab.py), `gather_probe`
(tools/pallas_gather_probe.py) and `dma_probe` (tools/pallas_dma_probe.py).
Each runs on the card by default:

    python -m uninext_tpu_torch.tools.msda_v6_lab
    python -m uninext_tpu_torch.tools.gather_probe
    python -m uninext_tpu_torch.tools.dma_probe

and `kernel_times`, which times the NMS kernel and fold B (see its
docstring), `ap_check`, which trains `image_joint_r50` on the in-repo
mini-COCO and reports its AP (`tools/real_ap_check.py --flagship`'s
protocol), `vis_check`, which trains a video config on the in-repo
mini-YTVIS and reports its track mAP (`tools/real_vis_check.py`'s),
`sot_check` (`tools/real_sot_check.py`'s SOT AUC and VOS J&F), the
training recipe's `rec_check` (`tools/real_rec_check.py`'s REC/RES
scores), `pipeline_check` (`tools/pipeline3_check.py`'s three stages:
BoxInst, image joint, video joint through the hand-off) and `joint_check`
(`tools/real_joint_check.py`'s one model on five video families), which
share `evidence.py`, and `multihost_smoke`, two ranks that take one
data-parallel step together (`tools/multihost_smoke.py`'s).
"""
import torch


def event_ms(fn, iters=20, warmup=3) -> float:
    """Mean milliseconds per call of `fn` on the card: `iters` calls
    captured in one CUDA graph, whose replay is timed with CUDA events, so
    the host's launch overhead (which exceeds the small kernels' run time)
    stays out of the number. `fn` must be capturable: no host syncs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                      # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)
