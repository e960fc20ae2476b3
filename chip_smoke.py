#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: ViT-H detection
serving and training, R50's three serving paths (detection, instance masks,
REC/RES), its training step and its training loop with checkpoints and COCO
evaluation, the video family of `video_joint_r50` (VIS, MOT and MOTS
serving, the two-frame training step and the video loop to a track mAP),
its annotation-prompt family (SOT, VOS, R-VOS serving, the SOT training
step, the ViT-H SOT/VOS frame step and the SOT loop to an AUC and a J&F),
data and tensor parallelism, the three-stage training recipe (BoxInst,
the stage hand-off, the routed image and video stages), ConvNeXt-L's
image and video presets (serving, training, the hand-off, SOT/VOS/R-VOS
and the SOT step) with a RoBERTa request, and the labs (`tools/`).

    python3 chip_smoke.py [--profile]

Phases (each prints its lines and raises on failure, so the exit code is
nonzero):
  1. device: the card's name and power limit (nvidia-smi), the build of
     the kernel libraries from `uninext_tpu_torch/csrc/` (one nvcc each,
     all started together) and ptxas's registers and spills of the
     tensor-core routes of kernels A and A-bwd and of MSDA and MSDA-bwd;
  2. kernels: each forward kernel (A, MSDA, NMS) against its plain PyTorch
     version on the card at the slice's shapes, in fp32 and bf16 (kernel A:
     bf16 on the tensor cores, fp32 on the CUDA cores), with both times
     (CUDA events), the least time the card could take (bound) and, where
     one exists, one PyTorch library call's time. MSDA on two location
     sets (uniform, and shaped like the model's), also over CUDA graph
     replays, with the L2 volume it moves; NMS's keep mask equal to the
     plain version's, its wrapper eagerly and over graph replays, and the
     one kernel the profiler sees it launch;
  3. backward kernels: A-bwd and MSDA-bwd against autograd through the
     plain versions at the training shapes, fp32 and bf16 (A-bwd: bf16 on
     the tensor cores, fp32 on the CUDA cores), timed the same way; A-bwd's
     wrapper and its kernels alone also over CUDA graph replays, beside
     the backward of SDPA with a float bias mask at both shapes; MSDA-bwd
     on both location sets and with every sample on level 0 or on level 3
     (whether same-address reductions set its pace);
  3b. labs: the labs' kernels in `csrc/gather_fold.cu` (the fold, TPU
     kernel B of `tools/msda_v6_lab.py`, and the gather probes C0-C2) and
     `csrc/dma_gather.cu` (the DMA probes C3, C4) against their plain
     versions at the tools' shapes, fp32 and bf16, timed over CUDA graph
     replays, and an empty kernel's time over graph replays, the floor under
     any launch; then the lab path with its launches counted:
     `tools/msda_v6_lab.py` (parity, and v6 against the port's MSDA kernel
     at the encoder shape in fp32 and bf16), the three probes of
     `tools/gather_probe.py` and the three of `tools/dma_probe.py`;
  4. correctness: two small models, each with the same weights on the card
     (kernels) and on the CPU (plain versions), fp32: a 2-block ViT (the
     serving outputs) and `tiny_test_config` (R50 at full width; the serving
     outputs, the instance masks of the top 100 and the REC/RES top-1 box
     and mask), then one train step's losses and every gradient of each,
     with the launches counted as path "reference" (the path of the fp32
     routes of kernels A and A-bwd);
  5. serving: `image_joint_vit_huge()` at full width with random weights
     from a seed, the 80-class COCO prompt encoded once, and 4 requests at
     800x1216 (the last padded from 800x1088) through forward and
     `postprocess_detection`, with the kernel launches of each request
     counted (kernel A on the tensor-core route only);
  6. training: the same config, bs=2 at 800x1216 (one image valid on
     800x1088), synthetic targets, 1 warm-up and 3 timed steps of
     `engine/train.py:train_step` (forward, losses, backward, clip, AdamW),
     with losses, grad norm, step time, peak memory and per-step launches;
  7. R50 serving: `image_joint_r50()` at full width (R50, 6+6 layers of
     width 256, 900 queries, BERT-base, bf16 compute) with random weights
     from a seed, 4 requests (the last padded from 800x1088) of each task:
     detection (the COCO prompt encoded once; MSDA 12, NMS 1 a request),
     instance segmentation (the same and the masks of the top 100; MSDA 12,
     NMS 1) and REC/RES (a 20-token expression through BERT on every
     request, the top-1 box and mask; MSDA 12, NMS 0), with latency and
     peak memory per task;
  8. R50 training: as 6 with 1 warm-up and 2 timed steps (MSDA 18 of which
     6 recomputes, MSDA-bwd 12); the frozen parameters (stem, res2, every
     FrozenBN mean and var) come out bit-equal, a res3 convolution moves;
  9. R50 training loop: a mini-COCO of 8 train and 8 val images written to
     a temporary directory, at the flagship fixture run's data settings
     (`uninext_tpu_torch/tools/ap_check.py`: LSJ 224 with masks, bs=2);
     the port's `Trainer` for 10 updates with a checkpoint at step 10; a
     second `Trainer` (other weights, `grad_accum_steps` 2) resumes it, its
     state bit-equal to the first's, and takes 10 micro-steps (5 updates);
     `DetectionEvaluator` (bbox, then segm; the C++ COCO matcher, built by
     g++ into `build/`) on the val images, whose AP values must be finite;
     step times, peak memory and seconds per evaluated image; launches
     (MSDA 18 and MSDA-bwd 12 a micro-step, MSDA 12 and NMS 1 an evaluated
     image) counted as path "r50_train_loop".
 10. VIS and MOT/MOTS: `video_joint_r50()` at full width (the deformable
     reid head, frozen BERT; random weights from a seed, bf16, the COCO
     prompt encoded once per video): one video of 6 frames at 480x736
     through `VISDriver` (IDOL; NMS at 0.9 over the thresholded selection,
     the masks and reid embeddings of the top 50, one copy to the host a
     frame), then 6 frames of 720x1280 under the `mot` preset (750x1333
     padded to 768x1344) through `MOTDriver` without and with masks
     (QDTrack, NMS at 0.7); per-frame latency (the first frame apart),
     peak memory, the tracks; launches per frame asserted (MSDA 14 of which
     2 in the reid head, NMS 1), as paths "vis" and "mot". Then MSDA and
     NMS against their plain versions at every input these paths gave them
     (NMS with the frame step's partly false `valid` mask, and with the
     upper half of the same scores valid), MSDA timed at S = 7341 and
     21420;
 11. video training: `engine/train.py:train_step` on a pair batch at bs=2 (key, ref)
     pairs at 800x1216 with masks, 1 warm-up and 2 timed steps; launches
     per step asserted (MSDA 40 of which 12 recomputes, MSDA-bwd 22);
     frozen BERT: no gradient, and after each update every parameter equals
     its value before times (1 - lr_lang x schedule x wd); the R50 frozen
     group bit-equal;
 12. video loop: a mini-YTVIS of 4 + 2 videos in a temporary directory
     (`tools/vis_check.py --flagship`'s settings), `Trainer(video=True)`
     for 10 steps, `VISDriver` and `evaluate_ytvis` on the val videos;
     launches asserted as path "video_loop"; then MSDA and MSDA-bwd against
     their plain versions at every shape the loop gave them.
 13. SOT, VOS and R-VOS: `video_joint_r50()` at full width with the
     template branch (the 4-channel template R50 and the P3-P6 fuser: a
     256 crop is a 1024-token prompt, 2048 with the second template):
     `SOTDriver` over 6 frames at 800x1216 with online updates every 2
     frames; `VOSDriver` over 6 frames at 480x736 with 2 objects (the
     second from frame 2) and `inference_on_3f`; `RVOSDriver` over 6
     frames at 480x736 with a 20-token expression at temporal weight 0 and
     0.3; `run_refdavis_offline` (2 objects x 2 expressions, 3 frames).
     The update, refresh and VOS thresholds are 0 so that every branch
     runs with random weights. Template encode times, per-frame latency,
     peak memory; launches per frame step asserted (SOT, VOS: MSDA 12, the
     reid head skipped; R-VOS: 14; NMS 0), as paths "sot", "vos", "rvos";
     MSDA against its plain version at every input these paths gave it.
 14. SOT training: `train_step(task="sot")` on a pair batch at bs=2,
     800x1216 with masks, 1 warm-up and 2 timed steps: launches per step
     asserted (MSDA 18 of which 6 recomputes, MSDA-bwd 12), as path
     "sot_training"; a res3 convolution of the template R50, `sot_fuser`
     and `adjust_layer` move, the template R50's stem and res2 (and the
     whole frozen group) stay bit-equal, the frozen BERT decays as in 11;
     MSDA and MSDA-bwd against their plain versions at the step's shapes.
 15. ViT-H SOT/VOS: `video_joint_vit_huge()` at full width with the
     4-channel ViT-H template backbone: `VOSDriver`, one object, 4 frames
     at 480x736 and 4 at 800x1216 (a template encode and a frame step with
     the mask): kernel A asserted at 32 launches per backbone pass, as path
     "sot_vith"; kernel A against its plain version, with its time, bound
     and SDPA's, at the template's shapes (global 1x16x16, 4 windows) and
     the 480x736 frame's (global 1x30x46, 12 windows).
 16. SOT loop: a single-object mini-YTVIS of 4 + 2 videos of 8 frames
     (`tools/sot_check.py --flagship`'s settings), `Trainer(video=True,
     task="sot")` for 10 steps, `SOTDriver` + `evaluate_sot` and
     `VOSDriver` + `evaluate_davis` on the val videos (AUC and J&F
     finite), one referring val video through `RVOSDriver`; launches
     asserted as path "sot_loop"; MSDA and MSDA-bwd against their plain
     versions at every shape the loop gave them.
 17. parallel (`uninext_tpu_torch/parallel/`): the one-process ViT-H and
     R50 steps of phase 6 and 8 as references, then 4 ranks spawned
     (`parallel/mesh.py:launch`) that share the one card over gloo (NCCL
     refuses two ranks on one device; with 2 or more cards the checks run
     again over NCCL, one rank per card): A′ (`models/vit.py:
     flash_rel_pos_attention_tp`, kernel A on each rank's heads) at k = 2
     and 4 on ViT-H's global block and windows against its plain version
     and the slice of kernel A on all 16 heads, each rank timed alone beside
     SDPA; `image_joint_vit_huge` on a 1 dp x 2 tp mesh (ranks 0, 1) and
     `image_joint_r50` on a 2 dp x 1 tp mesh (ranks 2, 3), one step each
     from the reference's weights, batch and draws, held to it
     (`PARALLEL_TOL`); launches per rank asserted (ViT-H: A′ and kernel A
     64 of which 32 recomputes, A-bwd 32; MSDA 18, MSDA-bwd 12), as paths
     "vith_tp_training" and "r50_dp_training"; peak memory per rank. Times
     are of ranks sharing one card over gloo: no speed of the parallel
     steps.
  18. recipe (`uninext_tpu_torch/tools/pipeline_check.py`'s flow at full
     width): 3 BoxInst steps of `image_joint_r50` (bs=2 at 800x1216, images
     of flat colour patches, box bitmasks and the LAB colour similarity from
     `data/boxinst.py`, warm-up 1: `loss_prj` and `loss_pairwise` positive
     on step 2, every layer's two losses of step 2 equal to
     `loss_masks_boxinst` on CPU copies of its inputs within 1e-4
     relative), one instance-segmentation request of that model (NMS held
     to its plain version); the state saved by `CheckpointManager` and
     restored bit-equal by `restore_params` into an `image_joint_r50`
     `Trainer`, a routed detection and grounding step; `load_stage_weights`
     into a routed `Trainer(video=True)` of `video_joint_r50` (inflated,
     template remapped, no mismatch, the template conv1 the image conv1
     with a zero 4th channel) and its VIS-pair, then SOT-pair step (ROADMAP
     §3.23). Launches per step asserted (MSDA 18, MSDA-bwd 12; the VIS
     pair 40, 22), as paths "recipe_boxinst", "recipe_image_joint" and
     "recipe_video_joint"; MSDA and MSDA-bwd against their plain versions
     at every shape the phase gave them.
  19. ConvNeXt-L and RoBERTa (`phase_convnext`): `image_joint_convnext_large`
     (depths 3/3/27/3, dims 192-1536, 337.73M parameters, random weights
     from a seed) through phase 7's requests (detection, instance masks,
     REC/RES; MSDA 12 and NMS 1, 1, 0 a request) and phase 8's step with
     drop-path 0.7 on (1 warm-up and 3 timed steps; MSDA 18 of which 6
     recomputes, MSDA-bwd 12; the stem frozen and bit-equal, a stage-1 MLP
     moves); the small ConvNeXt model of `tools/convnext_check.py` card vs
     CPU in fp32 (phase 4's check); `load_stage_weights` into
     `video_joint_convnext_large` with its 4-channel template ConvNeXt (1
     inflated: the stem, (192, 3, 4, 4) -> (192, 4, 4, 4)); phase 13's SOT,
     VOS and R-VOS paths and phase 14's SOT step on that preset; one
     REC/RES request of `image_joint_r50` with `roberta_base_language()`
     (20 seeded ids, the last 6 the pad id 1). Paths "convnext_detection",
     "convnext_instseg", "convnext_rec", "convnext_training",
     "convnext_reference", "convnext_sot", "convnext_vos", "convnext_rvos",
     "convnext_sot_training", "roberta_rec"; MSDA and MSDA-bwd held to
     their plain versions at every shape the phase gave them, NMS's keep
     masks at its requests' inputs.
     `--profile` adds one profiled detection request and one profiled step
     of each backbone, and one profiled R50 REC/RES request, and prints
     their device time by kernel and the device's idle share.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Exits nonzero and prints no
result without a CUDA device or outside a checkout of the repository.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGE_HW = (800, 1216)
N_REQUESTS = 4
TRAIN_BATCH = 2
TRAIN_STEPS = 3
R50_TRAIN_STEPS = 2
LOOP_STEPS = 10            # updates before the checkpoint, then as many micro-steps
LOOP_IMAGES = 8            # train and val images of the loop's mini-COCO
VIS_HW = (480, 736)        # YT-VIS's eval size (min 480), bench.py's
MOT_ORI = (720, 1280)      # BDD100K's frame size
VIDEO_FRAMES = 6
VIDEO_TRAIN_STEPS = 2
VIDEO_LOOP_STEPS = 10
VIDEO_LOOP_VIDEOS = (4, 2)  # train and val videos of the loop's mini-YTVIS
SOT_HW = (800, 1216)       # bench.py:bench_sot's SOT size
SOT_FRAMES = 6
SOT_TRAIN_STEPS = 2
CONVNEXT_TRAIN_STEPS = 3   # timed steps of image_joint_convnext_large, after 1 warm-up
SOT_LOOP_STEPS = 10
SOT_LOOP_VIDEOS = (4, 2)   # train and val videos of the loop's single-object mini-YTVIS
# NVIDIA H100 SXM data sheet, dense, at 700 W: the bound of a kernel is the
# larger of its bytes over HBM_BPS and its operations over the peak of
# their type (bf16 tensor cores for the attention products, fp32 CUDA
# cores for MSDA's and NMS's arithmetic)
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


def _timed(fn, iters, warmup=2):
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    import torch
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


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    from uninext_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()              # one nvcc per source, all at once
    for name in _build.KERNELS:
        _build.library(name)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {len(_build.KERNELS)} kernel libraries "
          f"built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("rel_pos_flash_attn_mma", "rel_pos_flash_attn_bwd_mma", "ms_deform_attn"):
        _print_ptxas(_build.build_log(name))
    return smi.stdout.strip().splitlines()[0]


def _print_ptxas(log):
    """One line per kernel that ptxas -v reported: its stack frame, spills,
    registers and static shared memory (the log is empty when the library
    was built by an earlier run without its log)."""
    entry, spill = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            print(f"[ptxas] {entry}: {spill}; {line.split(':', 1)[1].strip()}")
            entry = None


def _check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def _check_rel(name, got, want, tol):
    """max |got - want| <= tol x max |want|. Returns (absolute error, the
    error over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-6)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs error {err} > {tol} x {scale}")
    return err, err / scale


def _bound(nbytes, ops, kind):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the peak of their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_inputs(dev, g, B, h, w, nh=16, hd=80):
    """qkv (B, S, 3, nh, hd) and rel-pos tables Rh, Rw, fp32."""
    import torch
    base = torch.randn(B, h * w, 3, nh, hd, device=dev, generator=g)
    rh = 0.1 * torch.randn(h, h, hd, device=dev, generator=g)
    rw = 0.1 * torch.randn(w, w, hd, device=dev, generator=g)
    return base, rh, rw


def _sdpa_args(q5, k, v, rh, rw):
    """SDPA's layout of the same attention: q, k, v (B, nh, S, hd) and the
    rel-pos bias as a float mask (B, nh, S, S), built outside the call."""
    import torch
    B, H, W, nh, hd = q5.shape
    S = H * W
    qf = q5.float()
    bh = torch.einsum("byxhd,yid->bhyxi", qf, rh.float())
    bw = torch.einsum("byxhd,xjd->bhyxj", qf, rw.float())
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(B, nh, S, S).to(q5.dtype)
    t = lambda x: x.reshape(B, S, nh, hd).transpose(1, 2)
    return t(q5), t(k), t(v), bias


def _msda_shapes():
    shapes = tuple((IMAGE_HW[0] // s, IMAGE_HW[1] // s) for s in (8, 16, 32))
    return shapes + (((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2),)


def _msda_model_set(g, B, Lq, shapes, M, P, encoder):
    """Locations and weights shaped like the model's: reference points at
    the pixel centres of every level (encoder; the decoder's are uniform in
    (0, 1)), plus the init offsets of `models/layers.py:sampling_offsets_bias`
    over each level's size, plus N(0, 0.5 px) noise; softmaxed weights."""
    import torch
    from uninext_tpu_torch.models.layers import sampling_offsets_bias
    dev = g.device
    L = len(shapes)
    if encoder:
        ref = []
        for h, w in shapes:
            ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                    indexing="ij")
            ref.append(torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1).reshape(-1, 2))
        ref = torch.cat(ref)[None].expand(B, Lq, 2)
    else:
        ref = torch.rand(B, Lq, 2, device=dev, generator=g)
    size = torch.tensor([[w, h] for h, w in shapes], device=dev, dtype=torch.float32)
    off = sampling_offsets_bias(M, L, P).to(dev).reshape(M, L, P, 2)
    noise = 0.5 * torch.randn(B, Lq, M, L, P, 2, device=dev, generator=g)
    loc = ref[:, :, None, None, None] + (off + noise) / size[:, None]
    att = torch.randn(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
    return loc.contiguous(), att.reshape(B, Lq, M, L, P)


def _off_centres(loc, shapes, margin=1e-3):
    """`loc` moved at least `margin` pixels off every pixel centre, the kink
    of bilinear sampling where the gradient w.r.t. the location depends on
    rounding (grid_sample rescales through [-1, 1], the kernels do not)."""
    import torch
    out = loc.clone()
    for lvl, (h, w) in enumerate(shapes):
        size = torch.tensor([w, h], device=loc.device, dtype=torch.float64)
        px = loc[:, :, :, lvl].double() * size - 0.5
        frac = px - px.floor()
        px = torch.where(frac < margin, px + margin,
                         torch.where(frac > 1 - margin, px - margin, px))
        out[:, :, :, lvl] = ((px + 0.5) / size).float()
    return out


def _msda_corner_rows(shapes, loc):
    """In-frame bilinear corners of these locations: the value rows the
    forward gathers and the backward gathers and reduces into, with each
    sample's `in_range` as in the kernels."""
    import torch
    rows = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0].double() * w - 0.5
        y = loc[:, :, :, lvl, :, 1].double() * h - 0.5
        x0, y0 = x.floor(), y.floor()
        inr = (x >= -1) & (x < w) & (y >= -1) & (y < h)
        for cx in (x0, x0 + 1):
            for cy in (y0, y0 + 1):
                rows += int((inr & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).sum())
    return rows


def phase_kernels():
    """Each forward kernel vs its plain version at the slice's shapes.
    Returns the per-kernel record (bf16 = the compute dtype) for the JSON
    line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda, nms
    from uninext_tpu_torch.tools import event_ms
    from uninext_tpu_torch.tools.kernel_times import device_kernels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # fp32: only the order of fp32 sums differs. bf16: both read the same
    # bf16 inputs and compute in fp32; outputs may differ by one bf16
    # rounding (1 ulp at |x| < 8 is 3.1e-2).
    tol = {torch.float32: 5e-5, torch.bfloat16: 3.2e-2}
    rec = {}

    # kernel A: global blocks (1, 50x76 grid) and windowed blocks (24 windows
    # of 14x14); bf16 on the tensor cores ("rel_pos_flash_attn"), fp32 on the
    # CUDA cores ("rel_pos_flash_attn_fp32"). Each dtype must take its own
    # route. The tensor-core kernel also rounds P to bf16 before P.V (2^-9
    # of each term of a weighted mean), far below the output's rounding.
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    routes = {torch.bfloat16: ("rel_pos_flash_attn", vit.rel_pos_flash_attn_mma),
              torch.float32: ("rel_pos_flash_attn_fp32", vit.rel_pos_flash_attn_fp32)}
    for label, (B, h, w) in (("global", (1, H, W)), ("window", (24, 14, 14))):
        nh, hd = 16, 80
        S = h * w
        base, rh, rw = _attention_inputs(dev, g, B, h, w, nh, hd)
        for dt in (torch.float32, torch.bfloat16):
            name, route = routes[dt]
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(B, h, w, nh, hd)
            args = (q5, k, v, rh.to(dt), rw.to(dt), hd ** -0.5)
            before = {n: r.launches for n, r in routes.values()}
            got = vit.flash_rel_pos_attention(*args)
            moved = {n: r.launches - before[n] for n, r in routes.values()}
            if moved != {n: int(n == name) for n in moved}:
                raise AssertionError(f"kernel A {label} {dt}: launches by route {moved}")
            want = vit.rel_pos_attention_plain(*args)
            err = _check(f"{name} {label} {dt}", got, want, tol[dt])
            ms = _timed(lambda: vit.flash_rel_pos_attention(*args),
                        20 if dt == torch.bfloat16 else 5)
            pms = _timed(lambda: vit.rel_pos_attention_plain(*args), 3)
            del got, want
            e = 2 if dt == torch.bfloat16 else 4
            b_ms, b_by = _bound(
                e * (4 * B * S * nh * hd + h * h * hd + w * w * hd),
                B * nh * (4 * S * S * hd + 2 * S * (h + w) * hd),
                "bf16" if dt == torch.bfloat16 else "fp32")
            sq, sk, sv, bias = _sdpa_args(q5, k, v, rh.to(dt), rw.to(dt))
            lib = _timed(lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias),
                         20 if dt == torch.bfloat16 else 5)
            del sq, sk, sv, bias
            if dt == torch.bfloat16:
                # the wrapper's library part alone, over CUDA graph replays
                bias_ms = event_ms(lambda: vit.rel_pos_bias(q5, rh.to(dt), rw.to(dt)))
                print(f"[kernel A] {name} {label}: of the wrapper, the bias products "
                      f"bh = q.Rh, bw = q.Rw (rel_pos_bias, CUDA graph replays) "
                      f"{bias_ms:.4f} ms")
            print(f"[kernel A] {name} {label} B={B} {h}x{w} nh={nh} hd={hd} "
                  f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) wrapper "
                  f"(bias products and kernel) {ms:.4f} ms ({100 * b_ms / ms:.1f}% of "
                  f"its bound {b_ms:.4f} ms, "
                  f"{b_by}), plain {pms:.3f} ms; library scaled_dot_product_attention "
                  f"with a float bias mask built outside the timing: {lib:.4f} ms")
            r = rec.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if label == "global":
                r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         shape=f"global B={B} {h}x{w} {str(dt)[6:]}")
            else:
                r.update(window_ms=ms, window_library_ms=lib, window_bound_ms=b_ms)
            torch.cuda.empty_cache()
    a = rec["rel_pos_flash_attn"]
    print(f"[kernel A] tensor-core route, global block: {a['ms']:.4f} ms against SDPA's "
          f"{a['library_ms']:.4f} ms in this run")
    del base, q, k, v, q5, args
    torch.cuda.empty_cache()

    # MSDA: encoder (Lq = S = 20197) and decoder (Lq = 900) calls, on two
    # location sets: uniform in [-0.1, 1.1] (the set of the first timings) and
    # shaped like the model's (`_msda_model_set`, its own generator)
    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    value32 = torch.randn(1, S, M, D, device=dev, generator=g)
    gm = torch.Generator(device=dev).manual_seed(10)
    r = rec["ms_deform_attn_fwd"] = {"max_abs_err": 0.0}
    for label, Lq in (("encoder", S), ("decoder", 900)):
        loc = torch.rand(1, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att = torch.rand(1, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att = att.reshape(1, Lq, M, L, P)
        sets = {"uniform": (loc, att),
                "model": _msda_model_set(gm, 1, Lq, shapes, M, P, label == "encoder")}
        for set_name, (loc, att) in sets.items():
            for dt in (torch.float32, torch.bfloat16):
                args = (value32.to(dt), shapes, loc, att)
                got = msda.ms_deform_attn(*args)
                want = msda.ms_deform_attn_plain(*args)
                err = _check(f"ms_deform_attn {label} {set_name} {dt}", got, want, tol[dt])
                ms = _timed(lambda: msda.ms_deform_attn(*args), 20)
                gms = event_ms(lambda: msda.ms_deform_attn(*args), 20)
                pms = _timed(lambda: msda.ms_deform_attn_plain(*args), 5)
                rows = _msda_corner_rows(shapes, loc)
                vol = rows * D * value32.new_empty((), dtype=dt).element_size()
                print(f"[MSDA] ms_deform_attn {label} {set_name} Lq={Lq} S={S} M={M} D={D} "
                      f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol[dt]}) kernel "
                      f"{ms:.4f} ms (CUDA graph replays {gms:.4f} ms), plain {pms:.3f} ms; "
                      f"L2 volume {rows} corner rows x {vol // rows} B = {vol / 1e6:.1f} MB, "
                      f"{vol / gms / 1e9:.2f} TB/s")
                if dt != torch.bfloat16:
                    continue
                r["max_abs_err"] = max(r["max_abs_err"], err)
                key = {"encoder": "", "decoder": "decoder_"}[label] + (
                    "" if set_name == "uniform" else "model_")
                r.update({key + "ms": ms, key + "graph_ms": gms, key + "plain_ms": pms})
                if label == "encoder" and set_name == "uniform":
                    n = Lq * M * L * P
                    b_ms, b_by = _bound(2 * S * M * D + 4 * 3 * n + 2 * Lq * M * D,
                                        n * 10 * D, "fp32")
                    r.update(plain_ms=pms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"encoder B=1 Lq={Lq} bf16, uniform locations")
                    print(f"[MSDA] bound {b_ms:.4f} ms ({b_by}); no single PyTorch call "
                          f"computes MSDA")
    torch.cuda.empty_cache()

    # NMS: 900 boxes in 4 classes around 40 centres (many overlaps), exact
    N = 900
    centers = torch.rand(1, 40, 2, device=dev, generator=g) * 0.6 + 0.2
    pick = torch.randint(0, 40, (1, N), device=dev, generator=g)
    cxcy = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    cxcy = cxcy + 0.01 * torch.randn(1, N, 2, device=dev, generator=g)
    wh = torch.rand(1, N, 2, device=dev, generator=g) * 0.1 + 0.1
    boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], -1)
    scores = torch.rand(1, N, device=dev, generator=g)
    classes = torch.randint(0, 4, (1, N), device=dev, generator=g)
    args = (boxes, scores, classes, 0.7)
    got = nms.batched_nms(*args)
    want = nms.batched_nms_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError("batched_nms: keep mask differs from the plain version")
    kept = int(got.sum())
    ms = _timed(lambda: nms.batched_nms(*args), 20)
    gms = event_ms(lambda: nms.batched_nms(*args), 50)
    pms = _timed(lambda: nms.batched_nms_plain(*args), 2, warmup=1)
    launched = device_kernels(lambda: nms.batched_nms(*args))
    if len(launched) != 1 or "nms" not in launched[0][0]:
        raise AssertionError(f"batched_nms: one kernel expected, the profiler saw {launched}")
    counts = torch.bincount(classes[0], minlength=4).double()
    pairs = float((counts * (counts - 1) / 2).sum())    # same-class pairs
    b_ms, b_by = _bound(N * (16 + 4 + 8 + 1), pairs * 12, "fp32")
    print(f"[NMS] batched_nms N={N}: keep masks identical ({kept} kept); wrapper "
          f"{ms:.4f} ms eagerly, {gms:.4f} ms over graph replays; plain {pms:.3f} ms; "
          f"bound {b_ms:.5f} ms ({b_by}); profiler: one kernel, {launched[0][0]} "
          f"{launched[0][1]:.2f} us; no PyTorch call computes NMS (torchvision is absent)")
    rec["nms"] = {"max_abs_err": 0.0, "ms": gms, "eager_ms": ms, "plain_ms": pms,
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                  "shape": f"N={N}, 4 classes"}
    return rec


def _bwd_kernels_alone(q5, k, v, rh, rw, scale, out, lse, cot):
    """A closure that launches A-bwd's kernels of q5's dtype alone, on
    inputs prepared once as the wrapper prepares them (the bias tables, dO
    rows, Dq, the outputs), so that its timing holds no bias products, Dq
    or chain rule."""
    import torch
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import _build
    B, H, W, nh, hd = q5.shape
    S = H * W
    bf16 = q5.dtype == torch.bfloat16
    name = "rel_pos_flash_attn_bwd_mma" if bf16 else "rel_pos_flash_attn_bwd"
    q3 = q5.reshape(B, S, nh, hd)
    bh, bw = vit.rel_pos_bias(q5, rh, rw)
    dout4, dsum = vit._bwd_inputs(q5, out, cot)
    dq = torch.empty(B, S, nh, hd, dtype=torch.float32, device=q5.device)
    dk = torch.empty(B, S, nh, hd, dtype=q5.dtype, device=q5.device)
    dv = torch.empty(B, S, nh, hd, dtype=q5.dtype, device=q5.device)
    dbh, dbw = vit._bias_grad_buffers(bh, bw)
    tensors = (q3, k, v, dout4, lse, dsum, bh, bw, dq, dk, dv, dbh, dbw)
    args = (*(t.data_ptr() for t in tensors), B, H, W, nh, hd, *q3.stride()[:3],
            *(dout4.stride()[:3] if bf16 else ()), vit._strides(bh), vit._strides(bw),
            float(scale))
    fn, lib = vit._entry(name), _build.library(name)

    def run():
        _build.check(lib, fn(*args, _build.stream_of(q5)), name)
    run.tensors = tensors          # alive as long as the closure
    return run


def phase_backward_kernels():
    """A-bwd and MSDA-bwd vs autograd through the plain versions at the
    training shapes (bs=2). Returns their records for the JSON line."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda
    from uninext_tpu_torch.tools import event_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # relative to each gradient's largest entry. fp32: summation order (MSDA-
    # bwd adds dvalue with fp32 atomics, in an order that changes between runs).
    # bf16: each side rounds its gradients to bf16 once (2^-8 = 3.9e-3 of
    # the value) after fp32 sums of other orders; A-bwd's tensor-core
    # kernels also round P and dS to bf16 before the products that read
    # them, as the Pallas backward does.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
    rec = {}
    B = TRAIN_BATCH
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    nh, hd = 16, 80
    windows = B * (-(-H // 14)) * (-(-W // 14))
    # A-bwd: bf16 on the tensor cores ("rel_pos_flash_attn_bwd"), fp32 on
    # the CUDA cores ("rel_pos_flash_attn_bwd_fp32"); each dtype must take
    # its own route
    routes = {torch.bfloat16: ("rel_pos_flash_attn_bwd", vit.rel_pos_flash_attn_bwd_mma),
              torch.float32: ("rel_pos_flash_attn_bwd_fp32", vit.rel_pos_flash_attn_bwd_fp32)}
    for label, (Bw, h, w) in (("global", (B, H, W)), ("window", (windows, 14, 14))):
        base, rh0, rw0 = _attention_inputs(dev, g, Bw, h, w, nh, hd)
        S = h * w
        for dt in (torch.float32, torch.bfloat16):
            name, _ = routes[dt]
            bf16 = dt == torch.bfloat16
            cot = torch.randn(Bw, h, w, nh * hd, device=dev, generator=g).to(dt)
            grads, graphs = [], []
            for fn in (vit.flash_rel_pos_attention, vit.rel_pos_attention_plain):
                qkv = base.to(dt).requires_grad_()
                rh, rw = rh0.to(dt).requires_grad_(), rw0.to(dt).requires_grad_()
                q, k, v = qkv.unbind(2)
                out = fn(q.reshape(Bw, h, w, nh, hd), k, v, rh, rw, hd ** -0.5)
                before = {n: r.launches for n, r in routes.values()}
                grads.append(torch.autograd.grad(out, (qkv, rh, rw), cot,
                                                 retain_graph=True))
                moved = {n: r.launches - before[n] for n, r in routes.values()}
                if fn is vit.flash_rel_pos_attention and moved != {
                        n: int(n == name) for n in moved}:
                    raise AssertionError(f"kernel A-bwd {label} {dt}: launches by route {moved}")
                graphs.append((out, (qkv, rh, rw)))
            errs, rels = zip(*(
                _check_rel(f"{name} {label} {dt} {n}", a, b, tol[dt])
                for n, a, b in zip(("dqkv", "dRh", "dRw"), *grads)))
            # the kernel's function: the saved forward (out, lse) -> gradients;
            # the wrapper and the kernels alone over CUDA graph replays
            q, k, v = base.to(dt).unbind(2)
            q5 = q.reshape(Bw, h, w, nh, hd)
            fargs = (q5, k, v, rh0.to(dt), rw0.to(dt), hd ** -0.5)
            out, lse = vit.rel_pos_flash_attn_fwd(*fargs, with_lse=True)
            iters = 10 if bf16 else 2
            ms = event_ms(lambda: vit.rel_pos_flash_attn_bwd(*fargs, out, lse, cot), iters,
                          warmup=1)
            kms = event_ms(_bwd_kernels_alone(*fargs, out, lse, cot), iters, warmup=1)
            pout, pin = graphs[1]
            pms = _timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True),
                         3, warmup=1)
            del graphs, grads, pout, pin
            # library: the backward of SDPA with the bias as a float mask
            # (dq, dk, dv, dbias), the mask built outside the timing
            sq, sk, sv, bias = _sdpa_args(q5, k, v, rh0.to(dt), rw0.to(dt))
            leaves = [x.detach().requires_grad_() for x in (sq, sk, sv, bias)]
            lout = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
            lcot = cot.reshape(Bw, S, nh, hd).transpose(1, 2)
            lib = _timed(lambda: torch.autograd.grad(lout, leaves, lcot, retain_graph=True),
                         10 if bf16 else 3)
            del lout, leaves, bias, sq, sk, sv
            e = 2 if bf16 else 4
            b_ms, b_by = _bound(
                e * 8 * Bw * S * nh * hd + 4 * Bw * nh * S
                + 2 * e * (h * h * hd + w * w * hd),
                Bw * nh * (10 * S * S * hd + 6 * S * (h + w) * hd),
                "bf16" if bf16 else "fp32")
            print(f"[kernel A-bwd] {name} {label} B={Bw} {h}x{w} nh={nh} hd={hd} "
                  f"{str(dt)[6:]}: max_abs_err dqkv/dRh/dRw = "
                  + "/".join(f"{e:.3g}" for e in errs) + ", / max |grad| = "
                  + "/".join(f"{e:.3g}" for e in rels)
                  + f" (tol {tol[dt]}); CUDA graph replays: wrapper (bias products, Dq, "
                  f"kernels, chain rule) {ms:.4f} ms, kernels alone {kms:.4f} ms "
                  f"({100 * b_ms / kms:.1f}% of the bound {b_ms:.4f} ms, {b_by}); plain "
                  f"backward {pms:.3f} ms; library: backward of scaled_dot_product_attention "
                  f"with a float bias mask (dq, dk, dv, dbias) {lib:.4f} ms")
            r = rec.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            r["max_rel_err"] = max(r["max_rel_err"], *rels)
            if label == "global":
                r.update(ms=ms, kernel_ms=kms, plain_ms=pms, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, shape=f"global B={Bw} {h}x{w} {str(dt)[6:]}")
            else:
                r.update(window_ms=ms, window_kernel_ms=kms, window_plain_ms=pms,
                         window_library_ms=lib, window_bound_ms=b_ms)
            torch.cuda.empty_cache()
    a = rec["rel_pos_flash_attn_bwd"]
    print(f"[kernel A-bwd] tensor-core route at bs={B}: global block wrapper {a['ms']:.4f} "
          f"ms, kernels {a['kernel_ms']:.4f} ms against SDPA's backward "
          f"{a['library_ms']:.4f} ms; window blocks wrapper {a['window_ms']:.4f} ms, kernels "
          f"{a['window_kernel_ms']:.4f} ms against {a['window_library_ms']:.4f} ms, in this run")

    # MSDA-bwd on the two location sets of phase_kernels, then the
    # contention diagnostic: every sample on one level of 15200 or 247 pixels
    shapes = _msda_shapes()
    S = sum(a * b for a, b in shapes)
    M, D, L, P = 8, 32, 4, 4
    gm = torch.Generator(device=dev).manual_seed(11)
    r = rec["ms_deform_attn_bwd"] = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, Lq in (("encoder", S), ("decoder", 900)):
        value0 = torch.randn(B, S, M, D, device=dev, generator=g)
        loc0 = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
        att0 = torch.rand(B, Lq, M, L * P, device=dev, generator=g).softmax(-1)
        att0 = att0.reshape(B, Lq, M, L, P)
        cots = {dt: torch.randn(B, Lq, M * D, device=dev, generator=g).to(dt)
                for dt in (torch.float32, torch.bfloat16)}
        sets = {"uniform": (loc0, att0),
                "model": _msda_model_set(gm, B, Lq, shapes, M, P, label == "encoder")}
        for set_name, (loc0, att0) in sets.items():
            for dt in (torch.float32, torch.bfloat16):
                cot = cots[dt]
                errs, rels, pms = _msda_bwd_check(
                    f"{label} {set_name} {dt}", value0.to(dt), shapes, loc0, att0, cot, tol[dt])
                fargs = (value0.to(dt), shapes, loc0, att0)
                ms = _timed(lambda: msda.ms_deform_attn_bwd(*fargs, cot), 10)
                gms = event_ms(lambda: msda.ms_deform_attn_bwd(*fargs, cot), 10)
                rows = _msda_corner_rows(shapes, loc0)
                e = value0.new_empty((), dtype=dt).element_size()
                vol = rows * D * (e + 4)
                print(f"[MSDA-bwd] ms_deform_attn_bwd {label} {set_name} B={B} Lq={Lq} "
                      f"S={S} {str(dt)[6:]}: max_abs_err dvalue/dloc/datt = "
                      + "/".join(f"{x:.3g}" for x in errs) + ", / max |grad| = "
                      + "/".join(f"{x:.3g}" for x in rels)
                      + f" (tol {tol[dt]}) kernel {ms:.4f} ms (CUDA graph replays "
                      f"{gms:.4f} ms), plain backward {pms:.3f} ms; L2 volume {rows} "
                      f"corner rows x ({D * e} B read + {D * 4} B reduced) = "
                      f"{vol / 1e6:.1f} MB, {vol / gms / 1e9:.2f} TB/s")
                if dt != torch.bfloat16:
                    continue
                r["max_abs_err"] = max(r["max_abs_err"], *errs)
                r["max_rel_err"] = max(r["max_rel_err"], *rels)
                key = {"encoder": "", "decoder": "decoder_"}[label] + (
                    "" if set_name == "uniform" else "model_")
                r.update({key + "ms": ms, key + "graph_ms": gms, key + "plain_ms": pms})
                if label == "encoder" and set_name == "uniform":
                    n = B * Lq * M * L * P
                    # value read + dvalue written (bf16), loc/att read and
                    # dloc/datt written (fp32), dout read once (bf16)
                    b_ms, b_by = _bound(2 * 2 * B * S * M * D + 2 * 4 * 3 * n
                                        + 2 * B * Lq * M * D, n * (16 * D + 20), "fp32")
                    r.update(plain_ms=pms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"encoder B={B} Lq={Lq} bf16, uniform locations")
                    print(f"[MSDA-bwd] bound {b_ms:.4f} ms ({b_by}); no single PyTorch "
                          f"call computes MSDA's gradients")
        torch.cuda.empty_cache()
    # diagnostic: the encoder's work (B x 20197 queries x 8 heads x 16
    # samples, bf16), every sample on one level: level 0 (100 x 152) spreads
    # the dvalue reductions over 15200 pixels, level 3 (13 x 19) stacks them
    # on 247, about 1300 on each address at bs=2
    for lvl in (0, 3):
        h, w = shapes[lvl]
        one = ((h, w),)
        value = torch.randn(B, h * w, M, D, device=dev, generator=gm).to(torch.bfloat16)
        loc = _off_centres(torch.rand(B, S, M, 1, L * P, 2, device=dev, generator=gm), one)
        att = torch.rand(B, S, M, 1, L * P, device=dev, generator=gm).softmax(-1)
        cot = torch.randn(B, S, M * D, device=dev, generator=gm).to(torch.bfloat16)
        errs, rels, _ = _msda_bwd_check(f"level {lvl} only bf16", value, one, loc, att, cot,
                                           tol[torch.bfloat16], plain_ms=False)
        fms = event_ms(lambda: msda.ms_deform_attn(value, one, loc, att), 10)
        gms = event_ms(lambda: msda.ms_deform_attn_bwd(value, one, loc, att, cot), 10)
        r[f"level{lvl}_graph_ms"] = gms
        print(f"[MSDA-bwd] diagnostic, every sample on level {lvl} ({h}x{w}, {h * w} px), "
              f"B={B} Lq={S} bf16: backward {gms:.4f} ms, forward {fms:.4f} ms (CUDA graph "
              f"replays); max_abs_err dvalue/dloc/datt = "
              + "/".join(f"{x:.3g}" for x in errs) + ", / max |grad| = "
              + "/".join(f"{x:.3g}" for x in rels))
    return rec


def _msda_bwd_check(what, value0, shapes, loc0, att0, cot, tol, plain_ms=True):
    """MSDA-bwd against autograd through the plain version. Returns the
    absolute and relative errors of (dvalue, dloc, datt) and the plain
    backward's ms (None unless `plain_ms`)."""
    import torch
    from uninext_tpu_torch.ops import msda
    grads, graphs = [], []
    for fn in (msda.ms_deform_attn, msda.ms_deform_attn_plain):
        value = value0.detach().requires_grad_()
        loc, att = loc0.clone().requires_grad_(), att0.clone().requires_grad_()
        out = fn(value, shapes, loc, att)
        grads.append(torch.autograd.grad(out, (value, loc, att), cot, retain_graph=True))
        graphs.append((out, (value, loc, att)))
    errs, rels = zip(*(_check_rel(f"ms_deform_attn_bwd {what} {n}", a, b, tol)
                       for n, a, b in zip(("dvalue", "dloc", "datt"), *grads)))
    pout, pin = graphs[1]
    pms = (_timed(lambda: torch.autograd.grad(pout, pin, cot, retain_graph=True), 3)
           if plain_ms else None)
    return errs, rels, pms


def _bag_index(rows, S, device):
    """embedding_bag's index of the same sum over a table viewed as
    (rows * 4, D): bag i holds rows[i, s] * 4 + c for s < S, c < 4."""
    import torch
    c = torch.arange(4, device=device)
    return (rows.long()[..., None] * 4 + c).reshape(-1, S * 4)


def _library_bag(table, bags, weights):
    """ms of one `F.embedding_bag(mode="sum")` over `table` (rows of D),
    with per-sample weights (cast to the table's dtype) where given."""
    import torch.nn.functional as F
    from uninext_tpu_torch.tools import event_ms
    if weights is not None:
        weights = weights.to(table.dtype)
    return event_ms(lambda: F.embedding_bag(bags, table, per_sample_weights=weights,
                                            mode="sum"), 20)


def phase_labs():
    """The labs' kernels vs their plain versions at the tools' shapes (fp32
    and bf16), then the lab path with its launches counted. Returns the
    kernels' records (bf16 times) and the lab path's launches. Times are
    CUDA graph replays (`tools.event_ms`): the probes' kernels run for less
    time than the host takes to launch them."""
    import torch
    from uninext_tpu_torch.ops import gather_fold as gf
    from uninext_tpu_torch.tools import dma_probe, event_ms, gather_probe, msda_v6_lab as lab
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    # both versions return fp32 from the same inputs: only the order of fp32
    # sums (and fused multiply-adds) of at most 64 terms below 10 differs
    tol = 5e-5
    rec = {}

    # kernel B at the lab's encoder shape: L*P = 16 rows of 4D per column,
    # B*M*Lq_pad = 163840 columns
    S_lp, D = lab.L * lab.P, lab.D
    N = lab.pad_q_fused(lab.B, lab.M, lab.LQ)[2]
    rows32 = torch.randn(S_lp, N, 4 * D, device=dev, generator=g)
    w32 = torch.rand(S_lp, N, 4, device=dev, generator=g)
    r = rec["msda_fold"] = {"max_abs_err": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        rows, w = rows32.to(dt), w32.to(dt)
        err = _check(f"msda_fold {dt}", gf.msda_fold(rows, w), gf.msda_fold_plain(rows, w), tol)
        ms = event_ms(lambda: gf.msda_fold(rows, w), 20)
        pms = event_ms(lambda: gf.msda_fold_plain(rows, w), 5)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        print(f"[lab B] msda_fold S={S_lp} N={N} D={D} {str(dt)[6:]}: max_abs_err="
              f"{err:.3g} (tol {tol}) kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # rows and w are bf16 here, as msda_v6 makes them
    n_idx = (torch.arange(S_lp, device=dev)[None] * N
             + torch.arange(N, device=dev)[:, None])             # (N, S): row s*N + n
    bags = _bag_index(n_idx, S_lp, dev)
    lib = _library_bag(rows.view(-1, D), bags, w.permute(1, 0, 2).reshape(N, S_lp * 4))
    del n_idx, bags
    b_ms, b_by = _bound(rows.numel() * 2 + w.numel() * 2 + N * D * 4,
                        2 * S_lp * 4 * D * N, "fp32")
    r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
             shape=f"S={S_lp} N={N} D={D} bf16")
    print(f"[lab B] bound {b_ms:.4f} ms ({b_by}); library embedding_bag(sum, "
          f"per_sample_weights) in bf16: {lib:.4f} ms")
    floor = event_ms(gf.launch_floor, 200)
    print(f"[lab] launch floor: an empty kernel (1 warp) takes {floor:.5f} ms over "
          f"CUDA graph replays, the least time of any launch")
    del rows32, w32, rows, w
    torch.cuda.empty_cache()

    # kernels C0-C2 at the probes' shapes (bf16 tables, as the probes)
    probes = (("gather_rowsum_scalar", "C0", gf.gather_rowsum_scalar, gather_probe.R),
              ("gather_rowsum_vec", "C1", gf.gather_rowsum_vec, gather_probe.R),
              ("gather_weighted", "C2", gf.gather_weighted, gather_probe.R_ONEHOT))
    for name, tag, fn, R in probes:
        weighted = fn is gf.gather_weighted
        buf16, idx, *w = gather_probe.probe_inputs(r=R, weighted=weighted, device=dev)
        plain = gf.gather_weighted_plain if weighted else gf.gather_rowsum_plain
        r = rec[name] = {"max_abs_err": 0.0}
        M, TQ, SAMP = idx.shape
        for dt in (torch.float32, torch.bfloat16):
            args = (buf16.to(dt), idx, *w)
            err = _check(f"{name} {dt}", fn(*args), plain(*args), tol)
            ms = event_ms(lambda: fn(*args), 50)
            pms = event_ms(lambda: plain(*args), 10)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            print(f"[lab {tag}] {name} R={R} M={M} TQ={TQ} SAMP={SAMP} D={D} "
                  f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol}) kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms")
        bags = _bag_index(idx.view(M * TQ, SAMP), SAMP, dev)
        lib = _library_bag(buf16.view(-1, D), bags,
                           w[0].view(M * TQ, SAMP * 4) if weighted else None)
        nbytes = (buf16.numel() * 2 + idx.numel() * 4 + M * TQ * D * 4
                  + (w[0].numel() * 4 if weighted else 0))
        b_ms, b_by = _bound(nbytes, (2 if weighted else 1) * idx.numel() * 4 * D, "fp32")
        r.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=f"R={R} M={M} TQ={TQ} SAMP={SAMP} D={D} bf16")
        print(f"[lab {tag}] bound {b_ms:.5f} ms ({b_by}); library embedding_bag(sum"
              f"{', per_sample_weights' if weighted else ''}) in bf16: {lib:.4f} ms")

    # kernels C3 and C4 at the DMA probe's shapes (bf16 tables, as the probes)
    _check_dma_kernels(rec, dev, tol)

    # the lab path: the three tools as a user runs them, launches counted
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    lab.parity()
    v6 = {dt: lab.bench(dt) for dt in (torch.float32, torch.bfloat16)}
    outs = {k: f()[0] for k, f in gather_probe.PROBES.items()}
    dma = {k: f() for k, f in dma_probe.PROBES.items()}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for k, o in outs.items():
        if o.shape != (gather_probe.M_STEPS, gather_probe.TQ, D) or not torch.isfinite(o).all():
            raise AssertionError(f"probe {k}: {tuple(o.shape)} or non-finite values")
    n_idx = dma_probe.TILES * dma_probe.K
    for k, (o, _) in dma.items():
        rows = n_idx * 8 if k == "3" else dma_probe.TILES * 8
        if o.shape != (rows, dma_probe.D4) or not torch.isfinite(o).all():
            raise AssertionError(f"dma probe {k}: {tuple(o.shape)} or non-finite values")
    print(f"[lab] dma probes: probe 1 (C3) {dma['1'][1]:.4f} ms, "
          f"{n_idx / dma['1'][1] / 1e3:.0f} rows/us; probe 2 (C3, L2 evict_last) "
          f"{dma['2'][1]:.4f} ms, {n_idx / dma['2'][1] / 1e3:.0f} rows/us; probe 3 (C4) "
          f"{dma['3'][1]:.4f} ms, {n_idx / dma['3'][1] / 1e3:.0f} blocks/us")
    del dma
    # fp32: the lab's tolerance. bf16: v6 rounds the corner weights to bf16
    # (2^-9 of each term) and both round their outputs to bf16 (|out| < 8:
    # 3.2e-2)
    for dt, t in ((torch.float32, 1e-4), (torch.bfloat16, 6.3e-2)):
        if not v6[dt]["max_abs_err"] <= t:
            raise AssertionError(f"msda_v6 vs MSDA kernel {dt}: {v6[dt]['max_abs_err']} > {t}")
    print(f"[lab] msda_v6 (index_select + kernel B) vs the port's MSDA kernel at the "
          f"encoder shape: fp32 max_abs_err {v6[torch.float32]['max_abs_err']:.3g} "
          f"(tol 1e-4), MSDA {v6[torch.float32]['msda_ms']:.3f} ms, v6 "
          f"{v6[torch.float32]['v6_ms']:.3f} ms; bf16 max_abs_err "
          f"{v6[torch.bfloat16]['max_abs_err']:.3g} (tol 6.3e-2), MSDA "
          f"{v6[torch.bfloat16]['msda_ms']:.3f} ms, v6 {v6[torch.bfloat16]['v6_ms']:.3f} ms")
    print(f"[lab] kernel launches on the lab path: {launches}")
    torch.cuda.empty_cache()
    return rec, launches


def _check_dma_kernels(rec, dev, tol):
    """C3 (both cache policies) and C4 vs their plain versions at the DMA
    probe's shapes, fp32 and bf16 tables, with their times (CUDA graph
    replays), bounds and library calls, into `rec`."""
    import functools

    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.ops import dma_gather as dg
    from uninext_tpu_torch.tools import dma_probe, event_ms
    K, D4 = dma_probe.K, dma_probe.D4
    # C3: fp32 sums of 32 terms below 5 in two orders; C4 copies exactly
    cases = (("dma_gather_rowsum", "C3", False, tol, dg.dma_gather_rowsum_plain,
              {"": dg.dma_gather_rowsum,
               " evict_last": functools.partial(dg.dma_gather_rowsum, l2_resident=True)}),
             ("dma_block_gather", "C4", True, 0.0, dg.dma_block_gather_plain,
              {"": dg.dma_block_gather}))
    for name, tag, blocks, t, plain, variants in cases:
        buf16, idx = dma_probe.probe_inputs(blocks=blocks, device=dev)
        r = rec[name] = {"max_abs_err": 0.0}
        for dt in (torch.float32, torch.bfloat16):
            buf = buf16.to(dt)
            want = plain(buf, idx)
            for label, fn in variants.items():
                err = _check(f"{name}{label} {dt}", fn(buf, idx), want, t)
                r["max_abs_err"] = max(r["max_abs_err"], err)
                ms = event_ms(lambda: fn(buf, idx), 10)
                print(f"[lab {tag}] {name}{label} R={buf.shape[0]} D4={D4} "
                      f"{idx.numel()} indices {str(dt)[6:]}: max_abs_err={err:.3g} "
                      f"(tol {t}) kernel {ms:.4f} ms")
                if not label:
                    kernel_ms = ms
            del want
            pms = event_ms(lambda: plain(buf, idx), 5)
            print(f"[lab {tag}] {name} plain {str(dt)[6:]}: {pms:.4f} ms")
        out_numel = (idx.numel() * 8 if blocks else idx.numel() // K * 8) * D4
        b_ms, b_by = _bound(buf16.numel() * 2 + idx.numel() * 4 + out_numel * 4,
                            out_numel if blocks else idx.numel() * D4, "fp32")
        if blocks:
            # the table as 1963 blocks of 8 rows, cast to fp32 once (untimed)
            table = buf16[:8 * (buf16.shape[0] // 8)].reshape(-1, 8 * D4).float()
            lib = event_ms(lambda: F.embedding(idx, table), 10)
            lib_what = "embedding(idx, table as (1963, 1024) fp32, cast outside the timing)"
            del table
        else:
            bags = idx.view(-1, K).long()
            lib = event_ms(lambda: F.embedding_bag(bags, buf16, mode="sum"), 10)
            lib_what = "embedding_bag(sum) over bags of 32, bf16, one row per tile (not 8)"
        r.update(ms=kernel_ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                 shape=f"R={buf16.shape[0]} D4={D4} {idx.numel()} indices bf16")
        print(f"[lab {tag}] bound {b_ms:.5f} ms ({b_by}); library {lib_what}: {lib:.4f} ms")
        del buf16, idx
        torch.cuda.empty_cache()


def _tiny_vit_config():
    import dataclasses
    from uninext_tpu_torch.config import BackboneConfig, tiny_test_config
    return dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(
        name="vit_huge", vit_embed_dim=64, vit_depth=2, vit_num_heads=2,
        vit_window_size=4, vit_global_blocks=(1,), out_channels=(32, 64, 64),
        vit_drop_path_rate=0.0))


def _reference_pair(cfg, label, tasks, hw):
    """One small model, the same weights, kernels on the card vs plain
    versions on the CPU, fp32, on images of `hw`: the serving outputs of
    `tasks` (detection; with "masks" also the instance masks of the top 100
    and the grounding forward's top-1 box and mask), then one train step's
    losses and every gradient.

    A ReLU network's gradient jumps where a pre-activation crosses 0, and
    the card's forward differs from the CPU's by ~1e-6 of a value: at
    128x160 the R50 step's res3 gradients move by more than the tolerance
    on the CPU alone when the images are scaled by 1 + 1e-6. So the
    gradients are compared only after the CPU's own gradient is shown to
    stay within a tenth of the tolerance under that scaling."""
    import copy

    import numpy as np
    import torch
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import postprocess_instseg, postprocess_rec
    cpu = build_model(cfg, "cpu", seed=1)
    # off the initial sampling-offset ring: at init every MSDA sample sits on
    # a pixel centre, where bilinear sampling has a kink and the gradient
    # (compared below) depends on which side rounding puts it
    with torch.no_grad():
        g = torch.Generator().manual_seed(11)
        for p in cpu.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(0)
    H, W = hw
    images = torch.from_numpy(rng.randn(2, H, W, 3).astype(np.float32))
    mask = torch.zeros(2, H, W, dtype=torch.bool)
    mask[0, 3 * H // 4:] = True
    sizes = torch.tensor([[3 * H // 4, W], [H, W]])
    ids = torch.from_numpy(rng.randint(0, 1000, (2, 16)))
    tmask = torch.ones(2, 16, dtype=torch.int32)
    cmap = torch.eye(16, dtype=torch.bool)[1:6]

    def serve(model, dev):
        args = [t.to(dev) for t in (images, mask, sizes, ids, tmask)]
        out = model(*args)
        res = {k: out[k] for k in ("pred_logits", "pred_boxes", "pred_boxious")}
        if "masks" in tasks:
            inst = postprocess_instseg(model, out, cmap.to(dev), args[2])
            rec = postprocess_rec(model, model(*args, task="grounding"), args[2])
            res.update(inst_query_idx=inst["query_idx"], inst_masks=inst["mask_logits"],
                       rec_query_idx=rec["query_idx"], rec_box=rec["box"],
                       rec_masks=rec["mask_logits"])
        return res

    with torch.inference_mode():
        want, got = serve(cpu, "cpu"), serve(gpu, "cuda")
    errs = {}
    for k, w in want.items():
        if k.endswith("query_idx"):
            if not torch.equal(got[k].cpu(), w):
                raise AssertionError(f"small {label} {k} differs")
        elif k.startswith("pred_"):
            errs[f"{k} max_abs_err"] = _check(f"small {label} {k}", got[k].cpu(), w, 1e-4)
        else:
            errs[f"{k} err/max"] = _check_rel(f"small {label} {k}", got[k].cpu(), w, 1e-4)[1]
    print(f"[reference] small {label} slice, fp32, card (kernels) vs CPU (plain): "
          + ", ".join(f"{k}={v:.3g}" for k, v in errs.items()) + " (tol 1e-4)"
          + ("; the selected queries equal" if "masks" in tasks else ""))

    # one train step: losses and every gradient
    from uninext_tpu_torch.engine.train import loss_and_grads, loss_weights
    G, T = cfg.data.max_insts, 16
    boxes = torch.zeros(2, G, 4)
    valid = torch.zeros(2, G, dtype=torch.bool)
    pmap = torch.zeros(2, G, T, dtype=torch.bool)
    for b in range(2):
        n = 4 + 3 * b
        boxes[b, :n, :2] = torch.from_numpy(rng.uniform(0.25, 0.75, (n, 2)))
        boxes[b, :n, 2:] = torch.from_numpy(rng.uniform(0.05, 0.4, (n, 2)))
        valid[b, :n] = True
        pmap[b, torch.arange(n), torch.from_numpy(rng.randint(1, 12, n))] = True
    batch = {"images": images, "img_mask": mask, "image_sizes": sizes,
             "text_ids": ids.long(), "text_mask": tmask,
             "targets": {"boxes": boxes, "valid": valid, "positive_map": pmap}}
    gen = torch.Generator().manual_seed(0)
    shape = (2, 5, 2, min(20, G), 4)
    noise = (torch.randint(0, 2, shape, generator=gen).float() * 2 - 1,
             torch.rand(shape, generator=gen))

    def to(x, dev):
        return {k: to(v, dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    grad = lambda p: p.grad if p.grad is not None else torch.zeros_like(p)
    loss_and_grads(cpu, {**batch, "images": images * (1 + 1e-6)}, loss_weights(cfg),
                   dn_noise=noise)
    scaled = {n: grad(p).clone() for n, p in cpu.named_parameters()}
    res = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        _, losses = loss_and_grads(model, to(batch, dev), loss_weights(cfg),
                                   dn_noise=tuple(t.to(dev) for t in noise))
        res.append((losses, dict(model.named_parameters())))
    (cl, cp), (gl, gp) = res
    moved = max((scaled[n] - grad(p)).abs().max().item() / max(grad(p).abs().max().item(), 1e-2)
                for n, p in cp.items())
    if not moved <= 1e-4:
        raise AssertionError(f"small {label} step: the CPU's gradient moves {moved:.3g} of a "
                             "leaf's largest under images x (1 + 1e-6); no card-vs-CPU "
                             "comparison is meaningful at this input")
    if set(cl) != set(gl):
        raise AssertionError(f"loss keys differ: {sorted(set(cl) ^ set(gl))}")
    loss_err = max(_check_rel(f"small step {k}", gl[k].cpu(), cl[k], 1e-4)[1] for k in cl)
    grad_err = 0.0
    for n, p in cp.items():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        got = gp[n].grad.cpu() if gp[n].grad is not None else torch.zeros_like(p)
        scale = max(want.abs().max().item(), 1e-2)
        err = (got - want).abs().max().item()
        # 1e-3 of the leaf's largest gradient, at least 1e-5 (leaves whose
        # exact gradient is 0 hold only rounding noise)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"small step gradient {n}: {err} > 1e-3 x {scale}")
        grad_err = max(grad_err, err / scale)
    print(f"[reference] small {label} train step at {H}x{W}, fp32, card vs CPU (plain): "
          f"{len(cl)} losses, max rel err {loss_err:.3g} (tol 1e-4); "
          f"{len(cp)} gradients, max err / leaf max {grad_err:.3g} (tol 1e-3; the "
          f"CPU's own under images x (1 + 1e-6): {moved:.3g})")


def phase_small_reference():
    """Small models, same weights: kernels on the card vs plain on the CPU,
    in serving and in one train step, fp32: a 2-block ViT (kernel A's and
    A-bwd's fp32 routes, MSDA, MSDA-bwd, NMS), then `tiny_test_config`
    (R50 at full width) with its instance masks and REC/RES. Returns the
    kernel launches of this path."""
    import torch
    from uninext_tpu_torch.config import tiny_test_config
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    _reference_pair(_tiny_vit_config(), "ViT", ("detection",), (128, 160))
    _reference_pair(tiny_test_config(), "R50", ("detection", "masks"), (64, 96))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[reference] kernel launches on the small reference path: {launches}")
    for fp32 in ("rel_pos_flash_attn_fp32", "rel_pos_flash_attn_bwd_fp32"):
        bf16 = fp32.removesuffix("_fp32")
        if launches[bf16] or not launches[fp32]:
            raise AssertionError(f"the fp32 reference path must take {fp32} only, "
                                 f"not {bf16}")
    return launches


def _counters():
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import dma_gather, gather_fold, msda, nms
    return {"rel_pos_flash_attn": vit.rel_pos_flash_attn_mma,
            "rel_pos_flash_attn_fp32": vit.rel_pos_flash_attn_fp32,
            "rel_pos_flash_attn_tp": vit.flash_rel_pos_attention_tp,
            "rel_pos_flash_attn_bwd": vit.rel_pos_flash_attn_bwd_mma,
            "rel_pos_flash_attn_bwd_fp32": vit.rel_pos_flash_attn_bwd_fp32,
            "ms_deform_attn_fwd": msda.ms_deform_attn,
            "ms_deform_attn_bwd": msda.ms_deform_attn_bwd,
            "nms": nms.batched_nms,
            "msda_fold": gather_fold.msda_fold,
            "gather_rowsum_scalar": gather_fold.gather_rowsum_scalar,
            "gather_rowsum_vec": gather_fold.gather_rowsum_vec,
            "gather_weighted": gather_fold.gather_weighted,
            "dma_gather_rowsum": dma_gather.dma_gather_rowsum,
            "dma_block_gather": dma_gather.dma_block_gather}


def _prompt(cfg):
    from uninext_tpu_torch.data.coco_categories import COCO_CATEGORIES
    from uninext_tpu_torch.data.prompts import create_label_token_map
    from uninext_tpu_torch.data.tokenizer import BertTokenizer
    return create_label_token_map(COCO_CATEGORIES, BertTokenizer(), cfg.language.max_len)


def _serving_requests(dev):
    """N_REQUESTS images at IMAGE_HW from a seed; the last is 800x1088
    padded to the bucket."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    Hh, Ww = IMAGE_HW
    requests = []
    for r in range(N_REQUESTS):
        img = torch.randn(1, Hh, Ww, 3, device=dev, generator=g)
        pad = torch.zeros(1, Hh, Ww, dtype=torch.bool, device=dev)
        if r == N_REQUESTS - 1:        # a narrower image padded to the bucket
            pad[:, :, 1088:] = True
            img[:, :, 1088:] = 0
        sizes = torch.tensor([[Hh, 1088 if r == N_REQUESTS - 1 else Ww]])
        requests.append((img, pad, sizes.to(dev)))
    return requests


def phase_serving(cfg, label: str, tasks, profile: bool):
    """`cfg` at full width: N_REQUESTS requests of each task, one at a time
    (with `profile`, one more detection and REC/RES request each under the
    profiler).
    "detection": the 80-class COCO prompt encoded once, forward and
    `postprocess_detection`; "instseg": the same and the masks of the top
    100 (`postprocess_instseg`); "rec": a 20-token expression through BERT
    on every request, the grounding forward and the top-1 box and mask
    (`postprocess_rec`). Returns {task: launch counts of its requests}."""
    import torch
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import (postprocess_detection,
                                                      postprocess_instseg, postprocess_rec)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] {label}: {n_params / 1e6:.2f}M parameters, compute dtype "
          f"{cfg.compute_dtype}, random weights from seed 0, built in "
          f"{time.perf_counter() - t0:.1f} s")
    ids, tmask, cmap = _prompt(cfg)
    counters = _counters()
    t = cfg.transformer
    vit_blocks = cfg.backbone.vit_depth if cfg.backbone.name == "vit_huge" else 0
    g = torch.Generator(device=dev).manual_seed(3)
    launches = {}
    with torch.inference_mode():
        lang = model.encode_text(torch.from_numpy(ids).long()[None].to(dev),
                                 torch.from_numpy(tmask)[None].to(dev))
        cmap_t = torch.from_numpy(cmap).to(dev)
        requests = _serving_requests(dev)

        def serve(task, img, pad, sizes):
            if task == "rec":
                expr = torch.randint(0, 30000, (1, 20), device=dev, generator=g)
                out = model(img, pad, sizes, expr, torch.ones_like(expr), task="grounding")
                return out, postprocess_rec(model, out, sizes)
            out = model(img, pad, sizes, None, lang["masks"], lang_dict=lang)
            if task == "instseg":
                return out, postprocess_instseg(model, out, cmap_t, sizes)
            return out, postprocess_detection(out, cmap_t)

        torch.cuda.synchronize()
        for task in tasks:
            expect = {**dict.fromkeys(counters, 0), "rel_pos_flash_attn": vit_blocks,
                      "ms_deform_attn_fwd": t.enc_layers + t.dec_layers,
                      "nms": int(task != "rec")}
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            latencies, per_request = [], []
            for img, pad, sizes in requests:
                before = {k: c.launches for k, c in counters.items()}
                t0 = time.perf_counter()
                out, post = serve(task, img, pad, sizes)
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
                per_request.append({k: c.launches - before[k] for k, c in counters.items()})
                _check_outputs(task, out, post, cfg)
            launches[task] = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"[serving] {label} {task}: per-request latency ms (host clock, "
                  "synchronised): " + ", ".join(f"{x:.1f}" for x in latencies)
                  + f"; peak device memory {peak:.2f} GiB")
            print(f"[serving] {label} {task}: kernel launches per request: {per_request}")
            for counts in per_request:
                if counts != expect:
                    raise AssertionError(f"{label} {task}: launches per request "
                                         f"{counts} != {expect}")
        if profile:
            img, pad, sizes = requests[1]
            for task in ("detection", "rec"):
                if task in tasks:
                    _profile(lambda: serve(task, img, pad, sizes),
                             f"one {label} {task} request")
    del model, lang, requests, out, post
    torch.cuda.empty_cache()
    return launches


def _check_outputs(task, out, post, cfg):
    """Finite outputs of the expected shapes: detection's 100 boxes in
    [0, 1] with scores in [0, 1] and COCO classes; instseg's mask logits
    (1, 100, H/4, W/4); REC/RES's box and mask logits (1, 1, H/4, W/4)."""
    import torch
    Q = cfg.transformer.num_queries
    for k in ("pred_logits", "pred_boxes", "pred_boxious"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{task}: {k} has non-finite values")
    T = 1 if task == "rec" else cfg.language.max_len
    if out["pred_logits"].shape != (1, Q, T):
        raise AssertionError(f"{task}: pred_logits shape {tuple(out['pred_logits'].shape)}")
    masks = (1, 1 if task == "rec" else 100, IMAGE_HW[0] // 4, IMAGE_HW[1] // 4)
    if task != "detection":
        m = post["mask_logits"]
        if m.shape != masks or not torch.isfinite(m).all():
            raise AssertionError(f"{task}: mask logits {tuple(m.shape)}, not {masks} finite")
    if task == "rec":
        box = post["box"]
        if box.shape != (1, 4) or not ((box >= 0) & (box <= 1)).all():
            raise AssertionError(f"rec: box {box.tolist()} not (cx, cy, w, h) in [0, 1]")
        return
    if post["boxes"].shape != (1, 100, 4) or not torch.isfinite(post["boxes"]).all():
        raise AssertionError(f"boxes {tuple(post['boxes'].shape)} not 100 finite boxes")
    sel = torch.gather(out["pred_boxes"], 1, post["query_idx"][..., None].expand(-1, -1, 4))
    if not ((sel >= 0) & (sel <= 1)).all():
        raise AssertionError("selected boxes (cx, cy, w, h) outside [0, 1]")
    s = post["scores"]
    if not ((s >= 0) & (s <= 1)).all():
        raise AssertionError("scores outside [0, 1]")
    if not (post["classes"] < 80).all():
        raise AssertionError("class index outside the 80 COCO classes")


def _train_batch(cfg, dev):
    """bs=2 at 800x1216; image 1 valid on 800x1088. The 80-class COCO prompt
    for both; 5-20 boxes per image (of max_insts) with random classes, whose
    positive maps are the class's prompt tokens."""
    import numpy as np
    import torch
    ids, tmask, cmap = _prompt(cfg)
    rng = np.random.RandomState(7)
    B, (Hh, Ww), G = TRAIN_BATCH, IMAGE_HW, cfg.data.max_insts
    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(B, Hh, Ww, 3, device=dev, generator=g)
    img_mask = torch.zeros(B, Hh, Ww, dtype=torch.bool, device=dev)
    img_mask[1, :, 1088:] = True
    images[1, :, 1088:] = 0
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    pmap = np.zeros((B, G, cmap.shape[1]), bool)
    for b in range(B):
        n = rng.randint(5, 21)
        boxes[b, :n, :2] = rng.uniform(0.15, 0.85, (n, 2))
        boxes[b, :n, 2:] = rng.uniform(0.03, 0.3, (n, 2))
        valid[b, :n] = True
        pmap[b, :n] = cmap[rng.randint(0, len(cmap), n)]
    T = len(ids)
    return {"images": images, "img_mask": img_mask,
            "image_sizes": torch.tensor([[Hh, Ww], [Hh, 1088]], device=dev),
            "text_ids": torch.from_numpy(ids).long()[None].expand(B, T).to(dev),
            "text_mask": torch.from_numpy(tmask)[None].expand(B, T).to(dev),
            "targets": {"boxes": torch.from_numpy(boxes).to(dev),
                        "valid": torch.from_numpy(valid).to(dev),
                        "positive_map": torch.from_numpy(pmap).to(dev)}}


def phase_training(cfg, label: str, n_steps: int, profile: bool):
    """The training step of `cfg` at full width: 1 warm-up and `n_steps`
    timed steps. The optimizer's frozen group (R50's stem, res2 and every
    FrozenBN mean and var; ConvNeXt's stem) must come out bit-equal, and
    with R50 a res3 convolution, with ConvNeXt a stage-1 MLP, must have
    moved. Returns the launch counts of the timed steps."""
    import torch
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    dev = torch.device("cuda")
    is_vit = cfg.backbone.name == "vit_huge"
    t0 = time.perf_counter()
    state = build_train_state(cfg, seed=0)
    batch = _train_batch(cfg, dev)
    params = dict(state.model.named_parameters())
    frozen = {n: params[n].detach().clone() for n in state.optimizer.names.get("frozen", [])}
    res3 = ("detr.detr.backbone.0.backbone." + BACKBONE_PARAMS[cfg.backbone.name][1]
            if cfg.backbone.name in BACKBONE_PARAMS else None)
    moving = {n: params[n].detach().clone() for n in params if n == res3}
    torch.cuda.synchronize()
    n_valid = batch["targets"]["valid"].sum(1).tolist()
    backbone = (f"ViT drop-path {cfg.backbone.vit_drop_path_rate} and per-block "
                f"checkpointing {cfg.backbone.vit_use_checkpoint}" if is_vit else
                f"{cfg.backbone.name}, {len(frozen)} frozen parameters"
                + (f", drop-path {cfg.backbone.drop_path_rate}"
                   if cfg.backbone.name == "convnext_large" else ""))
    print(f"[training] {label}, bs={TRAIN_BATCH} at {IMAGE_HW[0]}x"
          f"{IMAGE_HW[1]} (image 1 valid on 800x1088), {n_valid} gt boxes, fp32 "
          f"parameters and AdamW state, {cfg.compute_dtype} compute, {backbone}, "
          f"encoder checkpointing {cfg.remat_encoder}; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    warm = float(train_step(state, batch)["grad_norm"])
    torch.cuda.synchronize()
    print(f"[training] {label} warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, grad "
          f"norm before the clip {warm:.6g}")
    if not math.isfinite(warm):
        raise AssertionError(f"{label} warm-up step: grad norm {warm}")

    counters = _counters()
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.ops import msda
    recompute = {"rel_pos_flash_attn": vit.flash_rel_pos_attention,
                 "ms_deform_attn_fwd": msda.ms_deform_attn}
    t = cfg.transformer
    n_remat_msda = t.enc_layers if cfg.remat_encoder else 0
    vit_blocks = cfg.backbone.vit_depth if is_vit else 0
    n_remat_vit = vit_blocks if cfg.backbone.vit_use_checkpoint else 0
    # every block (24 global, 8 windowed in ViT-H) launches A once, again
    # in its recompute, and A-bwd once: all on the tensor-core routes, none
    # on the fp32 routes
    expect = {**dict.fromkeys(counters, 0),
              "rel_pos_flash_attn": vit_blocks + n_remat_vit,
              "rel_pos_flash_attn_bwd": vit_blocks,
              "ms_deform_attn_fwd": t.enc_layers + t.dec_layers + n_remat_msda,
              "ms_deform_attn_bwd": t.enc_layers + t.dec_layers, "nms": 0}
    expect_recompute = {"rel_pos_flash_attn": n_remat_vit,
                        "ms_deform_attn_fwd": n_remat_msda}
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    for c in recompute.values():
        c.recompute_launches = 0
    step_ms, metrics, per_step = [], [], []
    for _ in range(n_steps):
        before = {k: c.launches for k, c in counters.items()}
        before_r = {k: c.recompute_launches for k, c in recompute.items()}
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(({k: c.launches - before[k] for k, c in counters.items()},
                         {k: c.recompute_launches - before_r[k]
                          for k, c in recompute.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(metrics):
        print(f"[training] {label} step {i + 1}: total_loss {m['total_loss']:.6g}, grad norm "
              f"before the clip {m['grad_norm']:.6g}, {step_ms[i]:.1f} ms; losses "
              + json.dumps({k: round(v, 6) for k, v in m.items()
                            if k not in ("total_loss", "grad_norm")}))
    print(f"[training] {label} step ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak device memory {peak:.2f} GiB (max_memory_allocated)")
    print(f"[training] {label} kernel launches per step: {per_step[0][0]}, of them "
          f"recomputes under checkpointing {per_step[0][1]}; expected {expect}, "
          f"recomputes {expect_recompute}")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite {bad}")
        if i and m["total_loss"] == metrics[i - 1]["total_loss"]:
            raise AssertionError(f"step {i + 1}: total loss did not change")
    same = [k for k in metrics[0] if metrics[0][k] == metrics[-1][k]]
    if same:
        raise AssertionError(f"losses unchanged from step 1 to {n_steps}: {same}")
    for counts, rcounts in per_step:
        if counts != expect or rcounts != expect_recompute:
            raise AssertionError(f"launches per step {counts} (recomputes {rcounts}) "
                                 f"!= {expect} ({expect_recompute})")
    moved = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    if moved:
        raise AssertionError(f"{label}: frozen parameters moved: {moved[:5]}")
    still = [n for n, p in moving.items() if torch.equal(params[n], p)]
    if still:
        raise AssertionError(f"{label}: {still} did not move")
    print(f"[training] {label}: the {len(frozen)} frozen parameters are bit-equal to "
          f"their values before the warm-up step" + (f"; {res3} moved" if moving else ""))
    if profile:
        _profile(lambda: train_step(state, batch), f"one {label} train step")
    del state, batch, params, frozen, moving
    torch.cuda.empty_cache()
    return launches


# per backbone family: the prefixes of its frozen parameters (the optimizer's
# "frozen" group holds them, JAX's `classify_param`) and a parameter past
# them that trains
BACKBONE_PARAMS = {
    "resnet50": (("stem.", "res2."), "res3.0.conv2.weight"),
    "convnext_large": (("downsample_layers.0.",), "stages.1.0.pwconv1.weight"),
}


def _recording_msda():
    """Put a pass-through in front of the model's MSDA entry (`models/
    layers.py` calls `ms_deform_attn` by that name) that records each call's
    (B, level shapes, Lq, M, D, P, value dtype, with gradient). Returns the
    records and a function that takes the pass-through out again."""
    import torch
    from uninext_tpu_torch.models import layers
    real, seen = layers.ms_deform_attn, set()

    def recording(value, spatial_shapes, loc, att):
        B, _, M, D = value.shape
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, loc, att))
        seen.add((B, tuple(tuple(int(x) for x in hw) for hw in spatial_shapes),
                  loc.shape[1], M, D, loc.shape[4], value.dtype, grad))
        return real(value, spatial_shapes, loc, att)

    layers.ms_deform_attn = recording
    return seen, lambda: setattr(layers, "ms_deform_attn", real)


def _check_msda_calls(calls, need_grad=True, label="train loop"):
    """MSDA against its plain version at every (B, level shapes, Lq, dtype)
    in `calls`, and MSDA-bwd against autograd through the plain version at
    those taken with a gradient, on random values and locations shaped like
    the model's (`_msda_model_set`; for the backward moved off the pixel
    centres, `_off_centres`), at phase_kernels' and
    phase_backward_kernels' tolerances. With `need_grad`, fails if no call
    had a gradient. Returns each kernel's largest errors and the number of
    shapes held."""
    import torch
    from uninext_tpu_torch.ops import msda
    tol_fwd = {torch.float32: 5e-5, torch.bfloat16: 3.2e-2}
    tol_bwd = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
    g = torch.Generator(device="cuda").manual_seed(12)
    fwd = {"loop_max_abs_err": 0.0, "loop_shapes": 0}
    bwd = {"loop_max_abs_err": 0.0, "loop_max_rel_err": 0.0, "loop_shapes": 0}
    for B, shapes, Lq, M, D, P, dt, grad in sorted(calls, key=str):
        S = sum(h * w for h, w in shapes)
        value = torch.randn(B, S, M, D, device="cuda", generator=g).to(dt)
        loc, att = _msda_model_set(g, B, Lq, shapes, M, P, encoder=Lq == S)
        what = f"B={B} levels={list(shapes)} Lq={Lq} {str(dt)[6:]}"
        err = _check(f"ms_deform_attn at the {label}'s {what}",
                     msda.ms_deform_attn(value, shapes, loc, att),
                     msda.ms_deform_attn_plain(value, shapes, loc, att), tol_fwd[dt])
        fwd["loop_max_abs_err"] = max(fwd["loop_max_abs_err"], err)
        fwd["loop_shapes"] += 1
        line = f"[{label}] {what}: MSDA max_abs_err {err:.3g} (tol {tol_fwd[dt]})"
        if grad:
            # off the pixel centres, where the location gradient jumps and
            # grid_sample's rescale through [-1, 1] may land on the other side
            cot = torch.randn(B, Lq, M * D, device="cuda", generator=g).to(dt)
            errs, rels, _ = _msda_bwd_check(f"at the {label}'s {what}", value, shapes,
                                            _off_centres(loc, shapes), att, cot,
                                            tol_bwd[dt], plain_ms=False)
            bwd["loop_max_abs_err"] = max(bwd["loop_max_abs_err"], *errs)
            bwd["loop_max_rel_err"] = max(bwd["loop_max_rel_err"], *rels)
            bwd["loop_shapes"] += 1
            line += (f"; MSDA-bwd dvalue/dloc/datt / max |grad| = "
                     + "/".join(f"{x:.3g}" for x in rels) + f" (tol {tol_bwd[dt]})")
        print(line)
    if need_grad and not bwd["loop_shapes"]:
        raise AssertionError(f"{label}: no MSDA call with a gradient")
    return {"ms_deform_attn_fwd": fwd, "ms_deform_attn_bwd": bwd}


def phase_train_loop(profile: bool):
    """`image_joint_r50` at full width through the port's training loop on
    a mini-COCO of LOOP_IMAGES train and LOOP_IMAGES val images written to
    a temporary directory, at the flagship fixture run's data settings
    (`tools/ap_check.py`: LSJ 224 with masks, bs=2): `Trainer` for
    LOOP_STEPS updates, a checkpoint at that step; a second `Trainer`
    (other weights) with `grad_accum_steps` 2 resumes it (the state must be
    bit-equal) and takes LOOP_STEPS more micro-steps (LOOP_STEPS / 2
    updates); then `DetectionEvaluator` on the val images (bbox, then segm;
    the C++ matcher, built by g++). With `profile`, one more micro-step and
    one more evaluated image (with masks) under the profiler, after the
    launches are read. After the launches are read, MSDA and MSDA-bwd are
    held against their plain versions at every shape the loop gave them
    (`_check_msda_calls`). Returns the launch counts and those checks."""
    import dataclasses
    import tempfile
    import torch
    from uninext_tpu_torch.engine.checkpoint import state_differences
    from uninext_tpu_torch.engine.trainer import Trainer
    from uninext_tpu_torch.evaluation import fast_eval
    from uninext_tpu_torch.tools import ap_check
    counters = _counters()
    cfg = ap_check.build_cfg(LOOP_STEPS)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, checkpoint_period=LOOP_STEPS))
    accum = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                grad_accum_steps=2))
    t0 = time.perf_counter()
    lib = fast_eval.library()
    print(f"[train loop] C++ COCO matcher {os.path.basename(lib._name)} built and loaded "
          f"in {time.perf_counter() - t0:.1f} s")
    calls, unrecord = _recording_msda()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as root:
        t0 = time.perf_counter()
        loader, val_recs, mapper, cmap = ap_check.fixture(
            os.path.join(root, "data"), cfg, LOOP_IMAGES, LOOP_IMAGES)
        batches = iter(loader)
        run = os.path.join(root, "run")
        log_a, log_b = ap_check.StepLog(), ap_check.StepLog()
        first = Trainer(cfg, batches, output_dir=run, seed=0, extra_hooks=[log_a])
        print(f"[train loop] mini-COCO of {LOOP_IMAGES} + {LOOP_IMAGES} images written and "
              f"the trainer built in {time.perf_counter() - t0:.1f} s")
        first.train()
        saved = first.ckpt.all_steps()
        second = Trainer(accum, batches, output_dir=run, seed=1, extra_hooks=[log_b])
        if not second.resume_or_load():
            raise AssertionError(f"no checkpoint to resume from (saved: {saved})")
        diff = state_differences(first.state, second.state)
        if diff:
            raise AssertionError(f"resumed state differs from the saved one: {diff[:8]}")
        print(f"[train loop] checkpoints at steps {saved}; the resumed state is bit-equal "
              f"to the trainer's (every parameter and buffer, both Adam moments, count "
              f"{second.state.optimizer.count}, step {second.state.step}, generator)")
        del first
        second.train()
        extra = next(batches)
        batches.close()
        opt = second.state.optimizer
        if (opt.count, second.state.step) != (LOOP_STEPS + LOOP_STEPS // 2, 2 * LOOP_STEPS):
            raise AssertionError(f"after the accumulated steps: {opt.count} updates, "
                                 f"{second.state.step} micro-steps")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        results, times = ap_check.evaluate(second.model, accum, cmap, val_recs, mapper)
        eval_s = time.perf_counter() - t0
        sample = mapper(val_recs[0])
    unrecord()
    losses = log_a.total_loss + log_b.total_loss
    step_ms = [x * 1e3 for x in log_a.seconds + log_b.seconds]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite total loss: {losses}")
    print("[train loop] total loss per micro-step: " + ", ".join(f"{x:.4g}" for x in losses))
    print(f"[train loop] step ms (host clock to the end of each step's device work): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; the last {LOOP_STEPS} (accumulating, k=2) median "
          f"{sorted(step_ms[LOOP_STEPS:])[LOOP_STEPS // 2]:.1f}; peak device memory "
          f"{peak:.2f} GiB (max_memory_allocated, two trainers)")
    sec = ap_check.image_seconds(times)
    print(f"[train loop] evaluation of {len(val_recs)} val images, bbox then segm: "
          f"{eval_s:.1f} s; seconds per image {sec}")
    for kind, res in results.items():
        print(f"[train loop] {kind} AP after {2 * LOOP_STEPS} micro-steps: "
              + json.dumps({k: round(v, 4) for k, v in res.items()}))
        bad = [k for k in ("AP", "AP50", "AP75") if not math.isfinite(res[k])]
        if bad:
            raise AssertionError(f"{kind}: non-finite {bad}")
    launches = {k: c.launches for k, c in counters.items()}
    tr = cfg.transformer
    n_eval = 2 * len(val_recs)          # every val image in bbox and in segm
    n_remat = tr.enc_layers if cfg.remat_encoder else 0
    expect = {**dict.fromkeys(counters, 0),
              "ms_deform_attn_fwd": 2 * LOOP_STEPS * (tr.enc_layers + tr.dec_layers + n_remat)
              + n_eval * (tr.enc_layers + tr.dec_layers),
              "ms_deform_attn_bwd": 2 * LOOP_STEPS * (tr.enc_layers + tr.dec_layers),
              "nms": n_eval}
    print(f"[train loop] kernel launches: {launches}; expected {expect}")
    if launches != expect:
        raise AssertionError(f"train loop launches {launches} != {expect}")
    checks = _check_msda_calls(calls)
    if profile:
        from uninext_tpu_torch.engine.evaluator import DetectionEvaluator
        from uninext_tpu_torch.engine.train import train_step
        from uninext_tpu_torch.engine.trainer import to_device
        dev = torch.device("cuda")
        _profile(lambda: train_step(second.state, to_device(extra, dev, True)),
                 "one R50 training-loop micro-step (LSJ 224, bs=2, masks, accumulating)")
        ev = DetectionEvaluator(second.model.eval(), accum, cmap, with_masks=True)
        _profile(lambda: ev.predict(sample), "one R50 evaluated image with masks "
                 f"({sample.bucket[0]}x{sample.bucket[1]})")
    torch.cuda.empty_cache()
    return launches, checks


# ---- the video family of video_joint_r50 ---------------------------------------


def _watch_frames(drv, counters, check):
    """Wrap a VIS/MOT driver's `frame_outputs` (the frame step and its one
    copy to the host, which synchronises): each frame's host time and the
    kernel launches it made, and `check` on its outputs."""
    import torch
    real, log = drv.frame_outputs, []

    def watched(*args):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args)
        log.append(((time.perf_counter() - t0) * 1e3,
                    {k: c.launches - before[k] for k, c in counters.items()}))
        check(out)
        return out

    drv.frame_outputs = watched
    return log


def _recording_nms(module=None):
    """A pass-through in front of the NMS of `module` (which calls
    `batched_nms` by that name; by default the frame step's,
    `engine/video_inference.py`) that keeps each call's inputs. Returns the
    records and a function that takes the pass-through out again."""
    if module is None:
        from uninext_tpu_torch.engine import video_inference as module
    real, seen = module.batched_nms, []

    def recording(boxes, scores, classes, thr, valid=None):
        seen.append((boxes.clone(), scores.clone(), classes.clone(), thr,
                     None if valid is None else valid.clone()))
        return real(boxes, scores, classes, thr, valid=valid)

    module.batched_nms = recording
    return seen, lambda: setattr(module, "batched_nms", real)


def _check_nms_calls(calls, label):
    """The NMS kernel's keep mask equal to the plain version's on every
    recorded input, whose `valid` mask (the frame step's selection) must be
    partly false, and on the same boxes, scores and classes with the upper
    half of the scores valid (random weights select few queries, so this
    makes NMS suppress at the path's shapes); no box outside `valid` kept.
    The kernel (over CUDA graph replays) and the plain version timed on the
    last input, with each mask."""
    import torch
    from uninext_tpu_torch.ops import nms
    from uninext_tpu_torch.tools import event_ms
    kept = {"frame": [], "upper half": []}
    for boxes, scores, classes, thr, valid in calls:
        if valid is None or bool(valid.all()):
            raise AssertionError(f"{label}: NMS got no valid mask, or one all true")
        half = (scores > scores.median()).contiguous()
        for kind, v in (("frame", valid), ("upper half", half)):
            got = nms.batched_nms(boxes, scores, classes, thr, valid=v)
            want = nms.batched_nms_plain(boxes, scores, classes, thr, valid=v)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: NMS keep mask ({kind} valid) differs from "
                                     "the plain version")
            if bool((got & ~v).any()):
                raise AssertionError(f"{label}: NMS kept a box outside the valid mask")
            kept[kind].append((int(v.sum()), int(got.sum())))
    boxes, scores, classes, thr, valid = calls[-1]
    times = {}
    for kind, v in (("frame", valid), ("upper half", (scores > scores.median()).contiguous())):
        times[kind] = (event_ms(lambda: nms.batched_nms(boxes, scores, classes, thr,
                                                        valid=v), 50),
                       _timed(lambda: nms.batched_nms_plain(boxes, scores, classes, thr,
                                                            valid=v), 2, warmup=1))
    N = boxes.shape[1]
    print(f"[{label}] NMS at the frame step's {len(calls)} inputs (N={N}, thr {thr}): keep "
          f"masks identical to the plain version's with the frame step's valid mask, "
          f"(valid, kept) per frame {kept['frame']}, and with the upper half of the scores "
          f"valid, {kept['upper half']}; kernel over graph replays "
          f"{times['frame'][0]:.4f} ms and {times['upper half'][0]:.4f} ms, plain "
          f"{times['frame'][1]:.3f} ms and {times['upper half'][1]:.3f} ms")
    return {f"{label}_ms": times["frame"][0], f"{label}_plain_ms": times["frame"][1],
            f"{label}_half_valid_ms": times["upper half"][0],
            f"{label}_half_valid_plain_ms": times["upper half"][1],
            f"{label}_calls": len(calls), f"{label}_valid_kept": kept["frame"],
            f"{label}_half_valid_kept": kept["upper half"]}


def _msda_bound(B, S, Lq, M, D, L, P, elt):
    """MSDA's bound: the value (`elt` bytes), fp32 locations and weights and
    the output moved once; 10 flops per sample and channel (4 corner
    weights, 4 multiply-adds, the weight)."""
    n = B * Lq * M * L * P
    return _bound(elt * B * S * M * D + 4 * 3 * n + elt * B * Lq * M * D, n * 10 * D, "fp32")


def _time_msda_calls(calls, label):
    """MSDA (kernel, CUDA graph replays) and its plain version timed at each
    recorded (B, level shapes, Lq, dtype), beside the bound. Returns
    {"<label>_<encoder|decoder>_{ms,plain_ms,bound_ms}": ...}."""
    import torch
    from uninext_tpu_torch.ops import msda
    from uninext_tpu_torch.tools import event_ms
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for B, shapes, Lq, M, D, P, dt, _ in sorted(calls, key=str):
        S = sum(h * w for h, w in shapes)
        value = torch.randn(B, S, M, D, device="cuda", generator=g).to(dt)
        loc, att = _msda_model_set(g, B, Lq, shapes, M, P, encoder=Lq == S)
        args = (value, shapes, loc, att)
        ms = event_ms(lambda: msda.ms_deform_attn(*args), 20)
        pms = _timed(lambda: msda.ms_deform_attn_plain(*args), 3)
        b_ms, b_by = _msda_bound(B, S, Lq, M, D, len(shapes), P,
                                 value.element_size())
        kind = "encoder" if Lq == S else "decoder"
        out.update({f"{label}_{kind}_ms": ms, f"{label}_{kind}_plain_ms": pms,
                    f"{label}_{kind}_bound_ms": b_ms})
        print(f"[{label}] MSDA {kind} B={B} levels={list(shapes)} S={S} Lq={Lq} "
              f"{str(dt)[6:]}: kernel {ms:.4f} ms (CUDA graph replays, "
              f"{100 * b_ms / ms:.1f}% of its bound {b_ms:.4f} ms, {b_by}), plain "
              f"{pms:.3f} ms")
    return out


def _moving_frames(g, n, H, W, valid_hw=None):
    """`n` frames (1, H, W, 3) of one random scene moving 6 px a frame, the
    padding beyond `valid_hw` zero, with their padding mask (1, H, W)."""
    import torch
    dev = g.device
    h, w = valid_hw or (H, W)
    scene = torch.randn(1, H, W + 6 * n, 3, device=dev, generator=g)
    pad = torch.zeros(1, H, W, dtype=torch.bool, device=dev)
    pad[:, h:] = True
    pad[:, :, w:] = True
    frames = [torch.where(pad[..., None], 0.0, scene[:, :, 6 * t:6 * t + W])
              for t in range(n)]
    return frames, pad


def _video_frame_check(cfg, hw, with_masks):
    """Finite frame-step outputs of the expected shapes: TOPK_VIS slots,
    embeddings of d_model, scores in [0, 1], and the masks (K, H/4, W/4)."""
    import numpy as np
    from uninext_tpu_torch.engine.video_inference import TOPK_VIS
    K, d = TOPK_VIS, cfg.transformer.d_model

    def check(o):
        shapes = {"valid": (K,), "boxes": (K, 4), "max_scores": (K,),
                  "embeds": (K, d), "scores_full": (K, 80)}
        if with_masks:
            shapes["mask_logits"] = (K, hw[0] // 4, hw[1] // 4)
        for k, s in shapes.items():
            if o[k].shape != s:
                raise AssertionError(f"frame step {k}: shape {o[k].shape} != {s}")
            if not np.isfinite(o[k].astype(np.float64)).all():
                raise AssertionError(f"frame step {k}: non-finite values")
        if not o["valid"].any():
            raise AssertionError("frame step: no valid slot (the best query is kept)")
        s = o["max_scores"][o["valid"]]
        if not ((s > 0) & (s <= 1)).all():
            raise AssertionError(f"frame step: scores outside (0, 1]: {s}")
    return check


def _video_launch_check(label, log, counters, cfg):
    """Launches per frame: MSDA enc + dec + reid layers, NMS 1, no other."""
    t = cfg.transformer
    expect = {**dict.fromkeys(counters, 0), "nms": 1,
              "ms_deform_attn_fwd": t.enc_layers + t.dec_layers + cfg.n_layer_deformable_reid}
    for i, (_, counts) in enumerate(log):
        if counts != expect:
            raise AssertionError(f"{label} frame {i}: launches {counts} != {expect}")
    ms = [x for x, _ in log]
    rest = sorted(ms[1:])
    print(f"[{label}] frame step (forward, NMS, masks, reid, one copy to the host) ms: "
          f"first frame {ms[0]:.1f}; frames 2-{len(ms)}: median {rest[len(rest) // 2]:.1f}, "
          f"range {rest[0]:.1f}-{rest[-1]:.1f}; launches per frame "
          f"{ {k: v for k, v in expect.items() if v} }")
    return ms


def phase_video_serving(cfg):
    """`video_joint_r50` at full width (random weights from seed 0, bf16,
    the 80-class COCO prompt encoded once per video): VIS, one video of
    VIDEO_FRAMES frames at VIS_HW through `VISDriver` (IDOL, NMS at 0.9);
    then MOT and MOTS, VIDEO_FRAMES frames of MOT_ORI (BDD100K) under the
    `mot` preset (800 / 1333: 750x1333 padded to 768x1344) through
    `MOTDriver` without and with masks (QDTrack, NMS at 0.7). Launches per
    frame asserted (MSDA 14, NMS 1). After the counts are read, MSDA and
    NMS are held against their plain versions at every input these paths
    gave them (NMS with the frame step's partly false `valid` mask), and
    MSDA is timed at the VIS and MOT shapes. Returns ({"vis": launches,
    "mot": launches}, kernel records)."""
    import torch
    from uninext_tpu_torch.config import eval_config
    from uninext_tpu_torch.data.coco import resize_shortest_edge
    from uninext_tpu_torch.engine.mot_inference import MOTDriver
    from uninext_tpu_torch.engine.video_inference import VISDriver
    from uninext_tpu_torch.models.detr import build_model
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0).eval()
    torch.cuda.synchronize()
    print(f"[vis] video_joint_r50: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
          f"parameters (reid head: deformable, {cfg.n_layer_deformable_reid} layers), "
          f"{cfg.compute_dtype} compute, random weights from seed 0, built in "
          f"{time.perf_counter() - t0:.1f} s")
    ids, tmask, cmap = _prompt(cfg)
    counters = _counters()
    g = torch.Generator(device=dev).manual_seed(5)
    launches, records = {}, {"msda": {}, "nms": {}}

    # VIS
    H, W = VIS_HW
    frames, pad = _moving_frames(g, VIDEO_FRAMES, H, W)
    sizes = torch.tensor([[H, W]], device=dev)
    drv = VISDriver(model, cfg, cmap)
    log = _watch_frames(drv, counters, _video_frame_check(cfg, VIS_HW, True))
    msda_calls, unrecord_msda = _recording_msda()
    nms_calls, unrecord_nms = _recording_nms()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = drv.run_video(frames, pad, sizes, ids[None], tmask[None], ori_size=(720, 1280))
    video_ms = (time.perf_counter() - t0) * 1e3
    unrecord_msda(), unrecord_nms()
    launches["vis"] = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _video_launch_check("vis", log, counters, cfg)
    n_masks = [sum(m is not None for m in ms) for ms in out["pred_masks"]]
    print(f"[vis] one video of {VIDEO_FRAMES} frames at {H}x{W} (original 720x1280): "
          f"{video_ms:.1f} ms with the tracker, masks to the original size and RLE; "
          f"peak device memory {peak:.2f} GiB; {len(out['pred_scores'])} tracks "
          f"(labels {out['pred_labels'][:10]}, scores "
          f"{[round(s, 4) for s in out['pred_scores'][:10]]}, frames with a mask "
          f"{n_masks[:10]})")
    if len(out["pred_masks"]) and any(len(m) != VIDEO_FRAMES for m in out["pred_masks"]):
        raise AssertionError("vis: a track's mask list does not span the video")
    records["msda"].update(_check_vis_mot_msda(msda_calls, "vis"))
    records["nms"].update(_check_nms_calls(nms_calls, "vis"))
    del frames, pad

    # MOT and MOTS at BDD100K's frame size under the mot preset
    mot_cfg, _, _ = eval_config(cfg, "mot")
    h, w = resize_shortest_edge(*MOT_ORI, mot_cfg.data.min_size_test,
                                mot_cfg.data.max_size_test)
    Hp, Wp = -(-h // 32) * 32, -(-w // 32) * 32
    frames, pad = _moving_frames(g, VIDEO_FRAMES, Hp, Wp, (h, w))
    sizes = torch.tensor([[h, w]], device=dev)
    msda_calls, unrecord_msda = _recording_msda()
    nms_calls, unrecord_nms = _recording_nms()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for with_masks in (False, True):
        label = "mots" if with_masks else "mot"
        drv = MOTDriver(model, mot_cfg, cmap, with_masks=with_masks)
        log = _watch_frames(drv, counters, _video_frame_check(cfg, (Hp, Wp), with_masks))
        t0 = time.perf_counter()
        per_frame = drv.run_video(frames, pad, sizes, ids[None], tmask[None],
                                  ori_size=MOT_ORI)
        video_ms = (time.perf_counter() - t0) * 1e3
        _video_launch_check(label, log, counters, cfg)
        tracks = sorted({d["id"] for dets in per_frame for d in dets})
        if with_masks and any(d["mask"].shape != MOT_ORI for dets in per_frame
                              for d in dets):
            raise AssertionError("mots: a mask is not at the original size")
        print(f"[{label}] {VIDEO_FRAMES} frames of {MOT_ORI[0]}x{MOT_ORI[1]} at {h}x{w} "
              f"padded to {Hp}x{Wp}: {video_ms:.1f} ms with QDTrack"
              + (" and the masks at the original size" if with_masks else "")
              + f"; detections per frame {[len(d) for d in per_frame]}, "
              f"{len(tracks)} track ids")
    unrecord_msda(), unrecord_nms()
    launches["mot"] = {k: c.launches for k, c in counters.items()}
    print(f"[mot] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"(MOT and MOTS)")
    records["msda"].update(_check_vis_mot_msda(msda_calls, "mot"))
    records["nms"].update(_check_nms_calls(nms_calls, "mot"))
    del model, frames, pad
    torch.cuda.empty_cache()
    return launches, records


def _check_vis_mot_msda(calls, label):
    """MSDA against its plain version at every shape a serving path gave it
    (`_check_msda_calls`), then timed there."""
    checks = _check_msda_calls(calls, need_grad=False, label=label)["ms_deform_attn_fwd"]
    out = {f"{label}_max_abs_err": checks["loop_max_abs_err"],
           f"{label}_shapes": checks["loop_shapes"]}
    out.update(_time_msda_calls(calls, label))
    return out


def _video_train_batch(cfg, dev):
    """A (key, ref) pair batch at bs=2 from `_train_batch`'s key frames:
    the ref frames are other random images (image 1 valid on 800x1088), the
    boxes move up to 2% of the image, object 0 of image 0 is gone from the
    ref frame; instance masks (the boxes filled) for both frames."""
    import torch
    b = _train_batch(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    images_ref = torch.randn(b["images"].shape, device=dev, generator=g)
    images_ref[1, :, 1088:] = 0
    tk = b["targets"]
    boxes_r = tk["boxes"].clone()
    boxes_r[..., :2] += 0.02 * (torch.rand(boxes_r[..., :2].shape, device=dev,
                                           generator=g) * 2 - 1)
    valid_r = tk["valid"].clone()
    valid_r[0, 0] = False
    h4, w4 = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4

    def masks(boxes, valid):
        ys = (torch.arange(h4, device=dev) + 0.5) / h4
        xs = (torch.arange(w4, device=dev) + 0.5) / w4
        cx, cy, w, h = boxes.unbind(-1)
        inside = (((ys[:, None] - cy[..., None, None]).abs() < h[..., None, None] / 2)
                  & ((xs[None] - cx[..., None, None]).abs() < w[..., None, None] / 2))
        return (inside & valid[..., None, None]).float()

    return {"images_key": b["images"], "images_ref": images_ref, "img_mask": b["img_mask"],
            "image_sizes": b["image_sizes"], "text_ids": b["text_ids"],
            "text_mask": b["text_mask"],
            "targets_key": {**tk, "masks": masks(tk["boxes"], tk["valid"]),
                            "has_masks": True},
            "targets_ref": {"boxes": boxes_r, "valid": valid_r,
                            "positive_map": tk["positive_map"],
                            "masks": masks(boxes_r, valid_r), "has_masks": True}}


def phase_video_training(cfg, n_steps: int):
    """The two-frame training step of `video_joint_r50` at full width
    (`engine/train.py:train_step` on a pair batch: one R50 pass over the 2B clip, two
    transformer passes, the key frame's detection and mask losses, simOTA on
    both frames, the reid head on both, `loss_reid_static`), 1 warm-up and
    `n_steps` timed steps at bs=2 with key and ref at IMAGE_HW. Launches
    per step asserted; the frozen BERT: no gradient, and after every update
    each parameter equals its value before times (1 - lr_lang * schedule *
    wd) to fp32 rounding (AdamW's decay on a zero gradient, as optax
    decays it); the R50 frozen group bit-equal. Returns the launches of the
    timed steps."""
    import torch
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    from uninext_tpu_torch.ops import msda
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = build_train_state(cfg, seed=0)
    batch = _video_train_batch(cfg, dev)
    params = dict(state.model.named_parameters())
    frozen = {n: params[n].detach().clone() for n in state.optimizer.names["frozen"]}
    bert = [n for n in params if n.startswith("text_encoder.")]
    if not bert or set(bert) - set(state.optimizer.names["lang"]):
        raise AssertionError("BERT's parameters are not all in the optimizer's lang group")
    torch.cuda.synchronize()
    print(f"[video training] video_joint_r50, bs={TRAIN_BATCH} (key, ref) pairs at "
          f"{IMAGE_HW[0]}x{IMAGE_HW[1]} (image 1 valid on 800x1088), gt boxes key "
          f"{batch['targets_key']['valid'].sum(1).tolist()}, ref "
          f"{batch['targets_ref']['valid'].sum(1).tolist()}, with masks; frozen BERT "
          f"({len(bert)} parameters), detach_reid {cfg.detach_reid}, encoder "
          f"checkpointing {cfg.remat_encoder}; set up in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_step(state, batch)
    torch.cuda.synchronize()
    print(f"[video training] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    counters = _counters()
    t = cfg.transformer
    n_reid = cfg.n_layer_deformable_reid
    n_remat = t.enc_layers if cfg.remat_encoder else 0
    # forward: both frames' encoders and decoders and the reid head on both;
    # the recompute of both encoders. Backward: the key frame's encoder and
    # decoder, the ref frame's encoder (the reid head attends to its
    # memory), the reid head on both; the ref decoder's outputs are all
    # stopped (its heads and references, and with detach_reid its states)
    expect = {**dict.fromkeys(counters, 0),
              "ms_deform_attn_fwd": 2 * (t.enc_layers + t.dec_layers + n_reid + n_remat),
              "ms_deform_attn_bwd": 2 * t.enc_layers + t.dec_layers + 2 * n_reid
              + (0 if cfg.detach_reid else t.dec_layers)}
    expect_recompute = {"ms_deform_attn_fwd": 2 * n_remat}
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    msda.ms_deform_attn.recompute_launches = 0
    lr, wd = cfg.solver.lang_lr, cfg.solver.weight_decay
    step_ms, metrics, per_step, decay_err = [], [], [], 0.0
    for _ in range(n_steps):
        before = {k: c.launches for k, c in counters.items()}
        before_r = msda.ms_deform_attn.recompute_launches
        old = {n: params[n].detach().clone() for n in bert}
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(({k: c.launches - before[k] for k, c in counters.items()},
                         {"ms_deform_attn_fwd": msda.ms_deform_attn.recompute_launches
                          - before_r}))
        metrics.append({k: float(v) for k, v in m.items()})
        graded = [n for n in bert if params[n].grad is not None]
        if graded:
            raise AssertionError(f"frozen BERT parameters got a gradient: {graded[:5]}")
        factor = 1.0 - lr * state.optimizer.schedule(state.optimizer.count - 1) * wd
        for n in bert:
            want = old[n] * factor
            err = ((params[n] - want).abs() / want.abs().clamp(min=1e-30)).max().item()
            decay_err = max(decay_err, err)
            if not err <= 2.5e-7:
                raise AssertionError(f"{n}: after the update {err:.3g} (relative) from "
                                     f"its value before x (1 - lr_lang x schedule x wd)")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(metrics):
        print(f"[video training] step {i + 1}: total_loss {m['total_loss']:.6g}, grad norm "
              f"before the clip {m['grad_norm']:.6g}, {step_ms[i]:.1f} ms; losses "
              + json.dumps({k: round(v, 6) for k, v in m.items()
                            if k not in ("total_loss", "grad_norm")}))
    print(f"[video training] step ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak device memory {peak:.2f} GiB (max_memory_allocated)")
    print(f"[video training] kernel launches per step: {per_step[0][0]}, of them "
          f"recomputes {per_step[0][1]}; expected {expect}, recomputes {expect_recompute}")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"video step {i + 1}: non-finite {bad}")
        if m["loss_reid"] <= 0:
            raise AssertionError(f"video step {i + 1}: loss_reid {m['loss_reid']}")
    if metrics[0]["total_loss"] == metrics[-1]["total_loss"]:
        raise AssertionError("video training: the total loss did not change")
    for counts, rcounts in per_step:
        if counts != expect or rcounts != expect_recompute:
            raise AssertionError(f"video launches per step {counts} (recomputes {rcounts})"
                                 f" != {expect} ({expect_recompute})")
    moved = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    if moved:
        raise AssertionError(f"video training: frozen parameters moved: {moved[:5]}")
    print(f"[video training] frozen BERT: no gradient in any step; each of its {len(bert)} "
          f"parameters after each update = before x (1 - lr_lang x schedule x wd) within "
          f"{decay_err:.3g} (relative; tolerance 2.5e-7); the {len(frozen)} frozen R50 "
          f"parameters bit-equal")
    del state, batch, params, frozen
    torch.cuda.empty_cache()
    return launches


def phase_video_loop():
    """`video_joint_r50` at full width through the port's video loop on a
    mini-YTVIS of VIDEO_LOOP_VIDEOS train and val videos (6 frames of
    192x256) written to a temporary directory, at the flagship fixture run's
    settings (`tools/vis_check.py --flagship`): `VideoPairMapper` ->
    `MultiDatasetLoader` (bs=2) -> `Trainer(video=True)` for
    VIDEO_LOOP_STEPS updates -> `VISDriver` on every val video ->
    `evaluate_ytvis` (any track mAP; it has to run). Launches counted as
    path "video_loop"; after they are read, MSDA and MSDA-bwd are held
    against their plain versions at every shape the loop gave them.
    Returns the launches and those checks."""
    import tempfile
    import torch
    from uninext_tpu_torch.data.loader import MultiDatasetLoader
    from uninext_tpu_torch.data.mini_coco import make_mini_ytvis
    from uninext_tpu_torch.data.video import VideoPairMapper, load_ytvis_json
    from uninext_tpu_torch.engine.trainer import Trainer
    from uninext_tpu_torch.tools import ap_check, vis_check
    counters = _counters()
    cfg = vis_check.build_cfg(VIDEO_LOOP_STEPS, flagship=True)
    calls, unrecord = _recording_msda()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_train, n_val = VIDEO_LOOP_VIDEOS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as root:
        t0 = time.perf_counter()
        paths = make_mini_ytvis(os.path.join(root, "data"), n_train=n_train, n_val=n_val)
        train_recs, cats = load_ytvis_json(paths["train_json"], paths["train_root"])
        val_recs, _ = load_ytvis_json(paths["val_json"], paths["val_root"])
        mapper = VideoPairMapper(cfg.data, cats, is_train=True, with_masks=True,
                                 sampling_frame_range=5)
        batches = iter(MultiDatasetLoader([(train_recs, mapper, 2)], [1.0], seed=0,
                                          num_workers=2))
        log = ap_check.StepLog()
        trainer = Trainer(cfg, batches, output_dir=os.path.join(root, "run"), seed=0,
                          video=True, extra_hooks=[log])
        print(f"[video loop] mini-YTVIS of {n_train} + {n_val} videos written and the "
              f"trainer built in {time.perf_counter() - t0:.1f} s")
        trainer.train()
        batches.close()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        res, video_s = vis_check.eval_vis(trainer.model, cfg, val_recs, paths["val_json"],
                                          cats, "cuda")
        eval_s = time.perf_counter() - t0
        n_frames = sum(r["length"] for r in val_recs)
    unrecord()
    step_ms = [x * 1e3 for x in log.seconds]
    if not all(map(math.isfinite, log.total_loss)):
        raise AssertionError(f"video loop: non-finite total loss {log.total_loss}")
    print("[video loop] total loss per step: "
          + ", ".join(f"{x:.4g}" for x in log.total_loss))
    print(f"[video loop] step ms (host clock to the end of each step's device work): "
          + ", ".join(f"{x:.1f}" for x in step_ms) + f"; peak device memory {peak:.2f} GiB")
    print(f"[video loop] VISDriver on {n_val} val videos ({n_frames} frames): {eval_s:.1f} s "
          f"(per video {[round(x, 2) for x in video_s]} s); track mAP after "
          f"{VIDEO_LOOP_STEPS} steps: "
          + json.dumps({k: (round(v, 4) if math.isfinite(v) else v) for k, v in res.items()}))
    if not math.isfinite(res["AP"]):
        raise AssertionError(f"video loop: track mAP {res['AP']}")
    launches = {k: c.launches for k, c in counters.items()}
    t = cfg.transformer
    n_reid = cfg.n_layer_deformable_reid
    n_remat = t.enc_layers if cfg.remat_encoder else 0
    expect = {**dict.fromkeys(counters, 0),
              "ms_deform_attn_fwd": VIDEO_LOOP_STEPS * 2 * (t.enc_layers + t.dec_layers
                                                            + n_reid + n_remat)
              + n_frames * (t.enc_layers + t.dec_layers + n_reid),
              "ms_deform_attn_bwd": VIDEO_LOOP_STEPS * (
                  2 * t.enc_layers + t.dec_layers + 2 * n_reid
                  + (0 if cfg.detach_reid else t.dec_layers)),
              "nms": n_frames}
    print(f"[video loop] kernel launches: {launches}; expected {expect}")
    if launches != expect:
        raise AssertionError(f"video loop launches {launches} != {expect}")
    checks = _check_msda_calls(calls, label="video loop")
    torch.cuda.empty_cache()
    return launches, checks


def _watch_calls(drv, attr, counters):
    """Wrap a driver's `attr` (its frame step or template encoder): the
    kernel launches of each call, and its time on the host clock
    (synchronised before and after). Returns the log of (ms, launches)."""
    import torch
    real, log = getattr(drv, attr), []

    def watched(*args):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t0) * 1e3,
                    {k: c.launches - before[k] for k, c in counters.items()}))
        return out

    setattr(drv, attr, watched)
    return log


def _per_call_check(label, log, expect):
    """Every call of `log` made exactly the launches of `expect` (0 for the
    kernels it does not name)."""
    for i, (_, counts) in enumerate(log):
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{label} call {i}: launches {counts} != {want}")


def _median_after_first(ms):
    rest = sorted(ms[1:]) or [float("nan")]
    return rest[len(rest) // 2], rest[0], rest[-1]


def _box_masks(boxes_xyxy, H, W):
    """(H, W) float masks, each a box filled."""
    import numpy as np
    out = []
    for x0, y0, x1, y1 in boxes_xyxy:
        m = np.zeros((H, W), np.float32)
        m[int(y0):int(y1), int(x0):int(x1)] = 1
        out.append(m)
    return out


def phase_sot_serving(cfg, label: str = "video_joint_r50"):
    """The annotation-prompt family of `video_joint_r50` at full width
    (random weights from seed 0, bf16, the 4-channel template R50 and the
    P3-P6 fuser: a 256x256 crop makes a 1024-token prompt, 2048 with a
    second template): `SOTDriver` over SOT_FRAMES frames at SOT_HW with
    `online_update` every 2 frames; `VOSDriver` over SOT_FRAMES frames at
    VIS_HW with 2 objects (the second from frame 2) and `inference_on_3f`;
    `RVOSDriver` over SOT_FRAMES frames at VIS_HW with a 20-token expression
    at `rvos_temporal_weight` 0, then 0.3; `run_refdavis_offline` with 2
    objects x 2 expressions over 3 frames. The update, refresh and VOS
    thresholds are set to 0 so that with random weights every branch runs
    (the template re-encodings, the 3f refresh and the merge). Launches per
    frame step asserted (SOT and VOS: MSDA 12, the reid head skipped; R-VOS
    14; NMS 0; a template encode launches none), as paths "sot", "vos",
    "rvos". Then MSDA against its plain version at every input these paths
    gave it, and timed there. Returns ({path: launches}, MSDA records)."""
    import dataclasses
    import numpy as np
    import torch
    from uninext_tpu_torch.engine.mot_inference import RVOSDriver
    from uninext_tpu_torch.engine.rvos_offline import run_refdavis_offline
    from uninext_tpu_torch.engine.sot_inference import SOTDriver, VOSDriver
    from uninext_tpu_torch.models.detr import build_model
    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfg, sot=dataclasses.replace(
        cfg.sot, online_update=True, update_interval=2, update_threshold=0.0,
        inference_on_3f=True, inst_threshold_vos=0.0))
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, template=True).eval()
    torch.cuda.synchronize()
    n_tb = sum(p.numel() for n, p in model.named_parameters()
               if n.startswith(("detr.detr.ref_backbone.", "detr.sot_fuser.",
                                "detr.adjust_layer.")))
    print(f"[sot] {label} with the template branch: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters (template "
          f"branch {n_tb / 1e6:.2f}M: 4-channel {cfg.backbone.name}, fuser, adjust_layer), "
          f"{cfg.compute_dtype} compute, random weights from seed 0, built in "
          f"{time.perf_counter() - t0:.1f} s")
    counters = _counters()
    t = cfg.transformer
    plain_step = {"ms_deform_attn_fwd": t.enc_layers + t.dec_layers}
    reid_step = {"ms_deform_attn_fwd": t.enc_layers + t.dec_layers
                 + cfg.n_layer_deformable_reid}
    g = torch.Generator(device=dev).manual_seed(6)
    launches, msda_rec = {}, {}

    def run_path(label, fn):
        calls, unrecord = _recording_msda()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        unrecord()
        launches[label] = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, calls, total_ms, peak

    # SOT at bench.py:bench_sot's size, online update every 2 frames
    H, W = SOT_HW
    frames, pad = _moving_frames(g, SOT_FRAMES, H, W)
    sizes = torch.tensor([[H, W]], device=dev)
    drv = SOTDriver(model, cfg)
    enc_log = _watch_calls(drv, "encode", counters)
    step_log = _watch_calls(drv, "step", counters)
    box0 = np.array([500.0, 300.0, 700.0, 460.0], np.float32)
    (boxes, times), calls, total_ms, peak = run_path(
        "sot", lambda: drv.run_video(frames, pad, sizes, box0))
    _per_call_check("sot frame step", step_log, plain_step)
    _per_call_check("sot template", enc_log, {})
    if boxes.shape != (SOT_FRAMES, 4) or not np.isfinite(boxes).all():
        raise AssertionError(f"sot: boxes {boxes.shape}, finite {np.isfinite(boxes).all()}")
    if len(enc_log) != 1 + (SOT_FRAMES - 1) // 2:
        raise AssertionError(f"sot: {len(enc_log)} template encodes, expected the first "
                             f"and one every 2 frames")
    med, lo, hi = _median_after_first([x * 1e3 for x in times[1:]])
    print(f"[sot] {SOT_FRAMES} frames at {H}x{W}, prompt {2 * 1024} tokens (the first "
          f"template and the latest): template encodes ms {[round(x, 1) for x, _ in enc_log]} "
          f"(crop, 4-channel {cfg.backbone.name}, fuser, adjust_layer); per-frame ms (frame step, box to the "
          f"host, the re-encode on every 2nd frame) first {times[1] * 1e3:.1f}, then median "
          f"{med:.1f} ({lo:.1f}-{hi:.1f}); frame steps alone ms "
          f"{[round(x, 1) for x, _ in step_log]}; video {total_ms:.1f} ms; peak "
          f"{peak:.2f} GiB; launches per frame step {plain_step}, per template encode none")
    print(f"[sot] boxes (xyxy px) {np.round(boxes, 1).tolist()}")
    msda_rec.update(_check_vis_mot_msda(calls, "sot"))
    del frames, pad

    # VOS: two objects, the second from frame 2, inference_on_3f
    H, W = VIS_HW
    frames, pad = _moving_frames(g, SOT_FRAMES, H, W)
    sizes = torch.tensor([[H, W]], device=dev)
    drv = VOSDriver(model, cfg)
    enc_log = _watch_calls(drv, "encode", counters)
    step_log = _watch_calls(drv, "step", counters)
    obj_boxes = [(100.0, 80.0, 300.0, 260.0), (400.0, 200.0, 640.0, 420.0)]
    m1, m2 = _box_masks(obj_boxes, H, W)
    init = {1: {"frame": 0, "box_xyxy": np.array(obj_boxes[0]), "mask": m1},
            2: {"frame": 2, "box_xyxy": np.array(obj_boxes[1]), "mask": m2}}
    labels, calls, total_ms, peak = run_path(
        "vos", lambda: drv.run_video(frames, pad, sizes, init))
    _per_call_check("vos frame step", step_log, plain_step)
    _per_call_check("vos template", enc_log, {})
    if len(step_log) != 2 + 2 * (SOT_FRAMES - 2):
        raise AssertionError(f"vos: {len(step_log)} frame steps")
    if any(l.shape != (H, W) or not set(np.unique(l)) <= {0, 1, 2} for l in labels):
        raise AssertionError("vos: label maps of another shape or with other ids")
    print(f"[vos] {SOT_FRAMES} frames at {H}x{W}, objects 1 (frame 0) and 2 (frame 2), "
          f"inference_on_3f (prompt 2 x 1024 tokens): {len(enc_log)} template encodes "
          f"(2 first templates, the rest 3f refreshes), ms "
          f"{[round(x, 1) for x, _ in enc_log]}; frame steps (one per object) ms "
          f"{[round(x, 1) for x, _ in step_log]}; video {total_ms:.1f} ms with the "
          f"upsample, merge and refreshes; peak {peak:.2f} GiB; pixels per label in the "
          f"last frame {np.bincount(labels[-1].ravel(), minlength=3).tolist()}")
    msda_rec.update(_check_vis_mot_msda(calls, "vos"))

    # R-VOS: a 20-token expression, temporal weight 0 then 0.3; Ref-DAVIS offline
    def rvos_paths():
        out = {}
        for w in (0.0, 0.3):
            rcfg = dataclasses.replace(cfg, rvos_temporal_weight=w)
            drv = RVOSDriver(model, rcfg)
            step_log = _watch_calls(drv, "step", counters)
            expr = torch.randint(0, 30000, (1, 20), device=dev, generator=g)
            lang = drv.encode_prompt(expr, torch.ones_like(expr))
            masks = drv.run_video(frames, pad, sizes, lang["hidden"], lang["masks"],
                                  ori_size=MOT_ORI)
            out[w] = (masks, step_log)
        drv = RVOSDriver(model, dataclasses.replace(cfg, rvos_temporal_weight=0.3))
        exprs = {}
        for oid in (1, 2):
            exprs[oid] = []
            for _ in range(2):
                expr = torch.randint(0, 30000, (1, 20), device=dev, generator=g)
                lang = drv.encode_prompt(expr, torch.ones_like(expr))
                exprs[oid].append((lang["hidden"], lang["masks"]))
        step_log = _watch_calls(drv, "step", counters)
        out["refdavis"] = (run_refdavis_offline(drv, frames[:3], pad, sizes, exprs, MOT_ORI),
                           step_log)
        return out

    res, calls, total_ms, peak = run_path("rvos", rvos_paths)
    for key, (out, step_log) in res.items():
        _per_call_check(f"rvos {key} frame step", step_log, reid_step)
        ms = [x for x, _ in step_log]
        med, lo, hi = _median_after_first(ms)
        if key == "refdavis":
            if len(out) != 3 or any(l.shape != MOT_ORI for l in out):
                raise AssertionError("refdavis: label maps of another shape")
            print(f"[rvos] run_refdavis_offline, 2 objects x 2 expressions over 3 frames at "
                  f"{H}x{W} to {MOT_ORI}: {len(step_log)} frame steps, median {med:.1f} ms; "
                  f"pixels per label in frame 0 "
                  f"{np.bincount(out[0].ravel(), minlength=3).tolist()}")
        else:
            if len(out) != SOT_FRAMES or any(m.shape != MOT_ORI for m in out):
                raise AssertionError(f"rvos {key}: masks of another shape")
            print(f"[rvos] RVOSDriver, rvos_temporal_weight {key}: {SOT_FRAMES} frames at "
                  f"{H}x{W}, masks to {MOT_ORI}: frame steps ms first {ms[0]:.1f}, then "
                  f"median {med:.1f} ({lo:.1f}-{hi:.1f}); mask pixels per frame "
                  f"{[int(m.sum()) for m in out]}")
    print(f"[rvos] all R-VOS paths {total_ms:.1f} ms; peak {peak:.2f} GiB; launches per "
          f"frame step {reid_step} (the reid head's 2 of them)")
    msda_rec.update(_check_vis_mot_msda(calls, "rvos"))
    del model, frames, pad
    torch.cuda.empty_cache()
    return launches, msda_rec


def phase_sot_training(cfg, n_steps: int, label: str = "video_joint_r50"):
    """The SOT training step of `video_joint_r50` at full width
    (`engine/train.py:train_step(task="sot")` on a pair batch at bs=2, key
    and ref at IMAGE_HW with masks: the ref frame's template crop with its
    gt mask as 4th channel through the 4-channel template R50, the fuser
    and adjust_layer, then a grounding pass with DN queries on the key
    frame, its losses scaled by `sot_loss_scale`), 1 warm-up and `n_steps`
    timed steps. Launches per step asserted (MSDA: the key frame's encoder,
    its recompute and the decoder; MSDA-bwd: the encoder and the decoder;
    no reid head). A res3 convolution of the template backbone moves, its
    stem and res2 stay bit-equal (with the whole frozen group); `sot_fuser`
    and `adjust_layer` move; the frozen BERT gets no gradient and decays as
    in phase 11. MSDA and MSDA-bwd against their plain versions at the
    step's shapes. Returns (launches, MSDA checks)."""
    import torch
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = build_train_state(cfg, seed=0, template=True)
    batch = _video_train_batch(cfg, dev)
    params = dict(state.model.named_parameters())
    frozen = {n: params[n].detach().clone() for n in state.optimizer.names["frozen"]}
    tb = "detr.detr.ref_backbone.0.backbone."
    frozen_prefixes, trains = BACKBONE_PARAMS[cfg.backbone.name]
    template_frozen = [n for n in frozen if n.startswith(tb)]
    missing = [p for p in frozen_prefixes
               if not any(n.startswith(tb + p) for n in template_frozen)]
    if missing:
        raise AssertionError(f"the template backbone's {missing} are not in the frozen group")
    moving = [tb + trains, "detr.sot_fuser.refine.3.weight", "detr.adjust_layer.weight"]
    before_moving = {n: params[n].detach().clone() for n in moving}
    bert = [n for n in params if n.startswith("text_encoder.")]
    torch.cuda.synchronize()
    print(f"[sot training] {label} with the template branch, bs={TRAIN_BATCH} (key, "
          f"ref) pairs at {IMAGE_HW[0]}x{IMAGE_HW[1]} with masks, the template from the first "
          f"valid ref slot (crop {cfg.sot.template_size}, 4th channel its gt mask), "
          f"sot_loss_scale {cfg.loss.sot_loss_scale}; {len(template_frozen)} template "
          f"{cfg.backbone.name} parameters frozen; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    warm = float(train_step(state, batch, task="sot")["grad_norm"])
    torch.cuda.synchronize()
    print(f"[sot training] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, grad norm "
          f"before the clip {warm:.6g}")
    if not math.isfinite(warm):
        raise AssertionError(f"sot training warm-up step: grad norm {warm}")
    counters = _counters()
    t = cfg.transformer
    n_remat = t.enc_layers if cfg.remat_encoder else 0
    expect = {**dict.fromkeys(counters, 0),
              "ms_deform_attn_fwd": t.enc_layers + t.dec_layers + n_remat,
              "ms_deform_attn_bwd": t.enc_layers + t.dec_layers}
    calls, unrecord = _recording_msda()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    lr, wd = cfg.solver.lang_lr, cfg.solver.weight_decay
    step_ms, metrics, per_step, decay_err = [], [], [], 0.0
    for _ in range(n_steps):
        before = {k: c.launches for k, c in counters.items()}
        old = {n: params[n].detach().clone() for n in bert}
        t0 = time.perf_counter()
        m = train_step(state, batch, task="sot")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c.launches - before[k] for k, c in counters.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if any(params[n].grad is not None for n in bert):
            raise AssertionError("sot training: the frozen BERT got a gradient")
        factor = 1.0 - lr * state.optimizer.schedule(state.optimizer.count - 1) * wd
        for n in bert:
            want = old[n] * factor
            err = ((params[n] - want).abs() / want.abs().clamp(min=1e-30)).max().item()
            decay_err = max(decay_err, err)
            if not err <= 2.5e-7:
                raise AssertionError(f"{n}: after the update {err:.3g} from its decay")
    unrecord()
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(metrics):
        print(f"[sot training] step {i + 1}: total_loss {m['total_loss']:.6g}, grad norm "
              f"before the clip {m['grad_norm']:.6g}, {step_ms[i]:.1f} ms; losses "
              + json.dumps({k: round(v, 6) for k, v in m.items()
                            if k not in ("total_loss", "grad_norm")}))
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or "loss_reid" in m:
            raise AssertionError(f"sot step {i + 1}: non-finite {bad} or a reid loss")
    print(f"[sot training] step ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak device memory {peak:.2f} GiB (max_memory_allocated)")
    print(f"[sot training] kernel launches per step: {per_step[0]}; expected {expect}")
    for counts in per_step:
        if counts != expect:
            raise AssertionError(f"sot launches per step {counts} != {expect}")
    still = [n for n in moving if torch.equal(params[n], before_moving[n])]
    if still:
        raise AssertionError(f"sot training: parameters that should move did not: {still}")
    moved = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    if moved:
        raise AssertionError(f"sot training: frozen parameters moved: {moved[:5]}")
    print(f"[sot training] moved: {moving}; the {len(frozen)} frozen parameters bit-equal "
          f"({len(template_frozen)} of them the template {cfg.backbone.name}'s "
          f"{', '.join(frozen_prefixes)} parameters (and a ResNet's FrozenBN statistics)); "
          f"frozen BERT: no gradient, each update = before x (1 - lr_lang x "
          f"schedule x wd) within {decay_err:.3g} (relative; tolerance 2.5e-7)")
    checks = _check_msda_calls(calls, label="sot training")
    del state, batch, params, frozen
    torch.cuda.empty_cache()
    return launches, checks


def _kernel_a_at(g, label, B, h, w):
    """Kernel A (bf16, tensor cores) against its plain version at (B, h, w)
    with ViT-H's 16 heads of 80, timed beside its bound and SDPA with a
    float bias mask: eagerly (CUDA events) and, since at these sizes the
    host's launches take longer than the device's work, over CUDA graph
    replays. Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    sdpa_ms, graph_ms, sdpa_graph_ms)."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.tools import event_ms
    nh, hd, dt = 16, 80, torch.bfloat16
    S = h * w
    base, rh, rw = _attention_inputs(g.device, g, B, h, w, nh, hd)
    q, k, v = base.to(dt).unbind(2)
    q5 = q.reshape(B, h, w, nh, hd)
    args = (q5, k, v, rh.to(dt), rw.to(dt), hd ** -0.5)
    err = _check(f"kernel A at the {label} shape", vit.flash_rel_pos_attention(*args),
                 vit.rel_pos_attention_plain(*args), 3.2e-2)
    ms = _timed(lambda: vit.flash_rel_pos_attention(*args), 20)
    pms = _timed(lambda: vit.rel_pos_attention_plain(*args), 3)
    b_ms, b_by = _bound(2 * (4 * B * S * nh * hd + h * h * hd + w * w * hd),
                        B * nh * (4 * S * S * hd + 2 * S * (h + w) * hd), "bf16")
    sq, sk, sv, bias = _sdpa_args(q5, k, v, rh.to(dt), rw.to(dt))
    sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias)
    lib = _timed(sdpa, 20)
    gms = event_ms(lambda: vit.flash_rel_pos_attention(*args))
    lib_g = event_ms(sdpa)
    print(f"[kernel A] {label} B={B} {h}x{w} nh={nh} hd={hd} bf16: max_abs_err={err:.3g} "
          f"(tol 3.2e-2), wrapper {ms:.4f} ms eagerly, {gms:.4f} ms over CUDA graph replays "
          f"({100 * b_ms / gms:.1f}% of its bound {b_ms:.4f} ms, {b_by}), plain {pms:.3f} ms; "
          f"SDPA with a float bias mask {lib:.4f} ms eagerly, {lib_g:.4f} ms over graph "
          f"replays")
    return err, ms, pms, b_ms, b_by, lib, gms, lib_g


def phase_sot_vith():
    """`video_joint_vit_huge()` at full width with the template branch (the
    4-channel ViT-H template backbone; random weights from seed 0, bf16):
    `VOSDriver` with one object over 4 frames at VIS_HW, then 4 frames at
    IMAGE_HW, each video a template encode (a 256 crop: a 16x16 patch grid)
    and a frame step with masks per frame. Kernel A asserted at 32 launches
    per backbone pass (24 global, 8 windowed blocks), as path "sot_vith".
    Then kernel A against its plain version, timed beside its bound and
    SDPA, at the template's shapes (global 1x16x16, windows: the grid padded
    to 28x28, 4 of 14x14) and the 480x736 frame's (global 1x30x46, windows:
    42x56, 12 of 14x14). Returns (launches, kernel A records)."""
    import numpy as np
    import torch
    from uninext_tpu_torch.config import video_joint_vit_huge
    from uninext_tpu_torch.engine.sot_inference import VOSDriver
    from uninext_tpu_torch.models.detr import build_model
    dev = torch.device("cuda")
    cfg = video_joint_vit_huge()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, template=True).eval()
    torch.cuda.synchronize()
    print(f"[sot_vith] video_joint_vit_huge with the template branch: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters (two ViT-H: "
          f"3 and 4 input channels), built in {time.perf_counter() - t0:.1f} s")
    counters = _counters()
    t = cfg.transformer
    blocks = cfg.backbone.vit_depth
    step_expect = {"rel_pos_flash_attn": blocks, "ms_deform_attn_fwd": t.enc_layers + t.dec_layers}
    g = torch.Generator(device=dev).manual_seed(8)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for H, W in (VIS_HW, IMAGE_HW):
        frames, pad = _moving_frames(g, 4, H, W)
        sizes = torch.tensor([[H, W]], device=dev)
        drv = VOSDriver(model, cfg)
        enc_log = _watch_calls(drv, "encode", counters)
        step_log = _watch_calls(drv, "step", counters)
        box = np.array([W * 0.3, H * 0.3, W * 0.3 + 240, H * 0.3 + 200], np.float32)
        init = {1: {"frame": 0, "box_xyxy": box, "mask": _box_masks([box], H, W)[0]}}
        labels = drv.run_video(frames, pad, sizes, init)
        _per_call_check("sot_vith frame step", step_log, step_expect)
        _per_call_check("sot_vith template", enc_log, {"rel_pos_flash_attn": blocks})
        if any(l.shape != (H, W) for l in labels):
            raise AssertionError("sot_vith: label maps of another shape")
        ms = [x for x, _ in step_log]
        med, lo, hi = _median_after_first(ms)
        print(f"[sot_vith] {H}x{W}: template encode (4-channel ViT-H on a 256 crop, fuser, "
              f"adjust_layer) {enc_log[0][0]:.1f} ms; frame step with the mask ms first "
              f"{ms[0]:.1f}, then median {med:.1f} ({lo:.1f}-{hi:.1f}); launches per frame "
              f"step {step_expect}, per template encode {blocks} of kernel A")
        del frames, pad
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[sot_vith] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB; launches {launches}")
    del model
    torch.cuda.empty_cache()
    rec = {}
    gk = torch.Generator(device=dev).manual_seed(9)
    vh, vw = VIS_HW[0] // 16, VIS_HW[1] // 16
    for key, (B, h, w) in (("sot_vith_template", (1, 16, 16)),
                           ("sot_vith_template_window", (4, 14, 14)),
                           ("sot_vith_480", (1, vh, vw)),
                           ("sot_vith_480_window", (12, 14, 14))):
        err, ms, pms, b_ms, b_by, lib, gms, lib_g = _kernel_a_at(gk, key, B, h, w)
        rec.update({f"{key}_max_abs_err": err, f"{key}_ms": ms, f"{key}_plain_ms": pms,
                    f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                    f"{key}_library_ms": lib, f"{key}_graph_ms": gms,
                    f"{key}_library_graph_ms": lib_g, f"{key}_shape": f"B={B} {h}x{w} bf16"})
        torch.cuda.empty_cache()
    return launches, rec


def phase_sot_loop():
    """`video_joint_r50` with the template branch through the port's SOT
    loop on a single-object mini-YTVIS of SOT_LOOP_VIDEOS train and val
    videos (8 frames of 192x256) in a temporary directory, at
    `tools/sot_check.py --flagship`'s settings: `VideoPairMapper` ->
    `MultiDatasetLoader` (bs=2, batches routed to "sot") ->
    `Trainer(video=True, task="sot")` for SOT_LOOP_STEPS updates ->
    `SOTDriver` + `evaluate_sot` and `VOSDriver` + `evaluate_davis` on the
    val videos (AUC and J&F finite); then one referring val video
    (`make_mini_ytvis(referring=True)`) through `RVOSDriver` to a J&F.
    Launches counted as path "sot_loop"; after they are read, MSDA and
    MSDA-bwd against their plain versions at every shape the loop gave them.
    Returns the launches and those checks."""
    import tempfile
    import numpy as np
    import torch
    from uninext_tpu_torch.data.loader import MultiDatasetLoader
    from uninext_tpu_torch.data.mini_coco import make_mini_ytvis
    from uninext_tpu_torch.data.tokenizer import BertTokenizer
    from uninext_tpu_torch.data.video import VideoPairMapper, load_ytvis_json
    from uninext_tpu_torch.engine.mot_inference import RVOSDriver
    from uninext_tpu_torch.engine.trainer import Trainer
    from uninext_tpu_torch.evaluation.davis_eval import evaluate_davis
    from uninext_tpu_torch.tools import ap_check, sot_check, vis_check
    counters = _counters()
    cfg = sot_check.build_cfg(SOT_LOOP_STEPS, flagship=True)
    calls, unrecord = _recording_msda()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_train, n_val = SOT_LOOP_VIDEOS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sot_") as root:
        t0 = time.perf_counter()
        paths = make_mini_ytvis(os.path.join(root, "data"), n_train=n_train, n_val=n_val,
                                length=8, max_objects=1)
        train_recs, cats = load_ytvis_json(paths["train_json"], paths["train_root"])
        val_recs, _ = load_ytvis_json(paths["val_json"], paths["val_root"])
        mapper = VideoPairMapper(cfg.data, cats, is_train=True, with_masks=True,
                                 sampling_frame_range=sot_check.FRAME_RANGE)
        batches = iter(MultiDatasetLoader([(train_recs, mapper, 2, "sot")], [1.0], seed=0,
                                          num_workers=2))
        log = ap_check.StepLog()
        trainer = Trainer(cfg, batches, output_dir=os.path.join(root, "run"), seed=0,
                          task="sot", video=True, extra_hooks=[log])
        print(f"[sot loop] single-object mini-YTVIS of {n_train} + {n_val} videos written "
              f"and the trainer built in {time.perf_counter() - t0:.1f} s")
        trainer.train()
        batches.close()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model = trainer.model.eval()
        t0 = time.perf_counter()
        agg, jf, per_video = sot_check.eval_sot_vos(model, cfg, val_recs, "cuda")
        eval_s = time.perf_counter() - t0
        ref = make_mini_ytvis(os.path.join(root, "ref"), n_train=1, n_val=1, length=8,
                              max_objects=2, referring=True)
        ref_recs, _ = load_ytvis_json(ref["val_json"], ref["val_root"], has_expression=True)
        rec = ref_recs[0]
        tok = BertTokenizer()(rec["expressions"][0], max_length=cfg.data.max_text_len)
        drv = RVOSDriver(model, cfg)
        lang = drv.encode_prompt(tok["input_ids"][None], tok["attention_mask"][None])
        Hh, Ww = vis_check.H, vis_check.W
        masks = drv.run_video(vis_check.frames_of(rec), np.zeros((1, Hh, Ww), bool),
                              np.array([[Hh, Ww]]), lang["hidden"], lang["masks"],
                              ori_size=(rec["height"], rec["width"]))
        _, _, gt = sot_check.scaled_track_gt(rec, rec["height"], rec["width"])
        rvos_jf = evaluate_davis({1: masks}, {1: gt})["J&F"]
        n_frames = sum(r["length"] for r in val_recs)
        n_ref_frames = rec["length"]
    unrecord()
    step_ms = [x * 1e3 for x in log.seconds]
    if not all(map(math.isfinite, log.total_loss)):
        raise AssertionError(f"sot loop: non-finite total loss {log.total_loss}")
    print("[sot loop] total loss per step: " + ", ".join(f"{x:.4g}" for x in log.total_loss))
    print(f"[sot loop] step ms (host clock to the end of each step's device work): "
          + ", ".join(f"{x:.1f}" for x in step_ms) + f"; peak device memory {peak:.2f} GiB")
    print(f"[sot loop] SOTDriver and VOSDriver on {n_val} val videos ({n_frames} frames): "
          f"{eval_s:.1f} s; after {SOT_LOOP_STEPS} steps AUC {agg['AUC']:.4f}, P "
          f"{agg['P']:.4f}, J&F {jf:.4f}; per video "
          + json.dumps([{k: (round(v, 4) if isinstance(v, float) else v) for k, v in x.items()}
                        for x in per_video])
          + f"; R-VOS on a referring val video ({rec['expressions'][0]!r}): J&F {rvos_jf:.4f}")
    if not (math.isfinite(agg["AUC"]) and math.isfinite(jf) and math.isfinite(rvos_jf)):
        raise AssertionError(f"sot loop: AUC {agg['AUC']}, J&F {jf}, R-VOS J&F {rvos_jf}")
    launches = {k: c.launches for k, c in counters.items()}
    t = cfg.transformer
    n_remat = t.enc_layers if cfg.remat_encoder else 0
    per_frame = t.enc_layers + t.dec_layers
    expect = {**dict.fromkeys(counters, 0),
              "ms_deform_attn_fwd": SOT_LOOP_STEPS * (per_frame + n_remat)
              + per_frame * (2 * n_frames - n_val)
              + n_ref_frames * (per_frame + cfg.n_layer_deformable_reid),
              "ms_deform_attn_bwd": SOT_LOOP_STEPS * per_frame}
    print(f"[sot loop] kernel launches: {launches}; expected {expect}")
    if launches != expect:
        raise AssertionError(f"sot loop launches {launches} != {expect}")
    checks = _check_msda_calls(calls, label="sot loop")
    torch.cuda.empty_cache()
    return launches, checks


PARALLEL_WATCH = {   # parameters the parallel phase holds to the one-process step
    "vit": ("detr.detr.backbone.0.backbone.blocks.31.attn.qkv.weight",
            "detr.detr.backbone.0.backbone.blocks.31.attn.proj.weight",
            "detr.detr.backbone.0.backbone.blocks.31.attn.rel_pos_h",
            "text_encoder.body.model.encoder.layer.11.intermediate.dense.weight",
            "detr.detr.transformer.decoder.layers.5.cross_attn.value_proj.weight"),
    "r50": ("detr.detr.backbone.0.backbone.res3.0.conv2.weight",
            "text_encoder.body.model.encoder.layer.11.intermediate.dense.weight",
            "detr.detr.transformer.decoder.layers.5.cross_attn.value_proj.weight"),
}
# One-process step against the k-rank step in bf16 (the row-parallel
# partial sums are rounded to bf16 before their fp32 sum; a near-tie of the
# matching may flip): the total loss within 3e-2 and the grad norm within
# 1e-1 relative; each watched gradient (Adam's first moment) at a cosine of
# at least 0.95 to the one-process one; each watched weight within 2.05
# times the one-process step's largest move (Adam's first update moves a
# weight by about lr, a flipped sign by 2 lr). The share of its entries
# within 1% of that move is printed, not held: where a gradient is near 0
# (unused rows of a rel-pos table) its sign is rounding noise.
PARALLEL_TOL = {"total_loss": 3e-2, "grad_norm": 1e-1, "cosine": 0.95, "move": 2.05}


def _one_process_reference(cfg, label, path_key, out, dev):
    """The one-process step the parallel phase holds its ranks to: seed-0
    weights, `_train_batch` and the state's generator, as every rank makes
    them. Keeps the losses, the watched parameters before and after and
    their first moments in `out[path_key]`."""
    import torch
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    state = build_train_state(cfg, dev, seed=0)
    params = dict(state.model.named_parameters())
    watch = PARALLEL_WATCH[path_key]
    before = {n: params[n].detach().cpu().clone() for n in watch}
    t0 = time.perf_counter()
    m = train_step(state, _train_batch(cfg, dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    opt = state.optimizer
    mu = {n: m_.detach().cpu().clone() for g, names in opt.names.items()
          for n, m_ in zip(names, opt.mu[g]) if n in watch}
    out[path_key] = {"metrics": {k: float(v) for k, v in m.items()}, "before": before,
                     "after": {n: params[n].detach().cpu().clone() for n in watch},
                     "mu": mu}
    print(f"[parallel] one-process {label} step at bs={TRAIN_BATCH} (the reference of the "
          f"ranks): total_loss {out[path_key]['metrics']['total_loss']:.6g}, grad norm "
          f"{out[path_key]['metrics']['grad_norm']:.6g}, {ms:.1f} ms")
    del state, params
    torch.cuda.empty_cache()


def _check_launches(label, launches, expect):
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} != {expect}")


def _hold_step(label, state, m, ref, mesh):
    """A rank's step against the one-process reference (PARALLEL_TOL);
    raises on a miss. Returns the numbers."""
    import torch
    import torch.nn.functional as F
    from uninext_tpu_torch.parallel import sharding
    got = {k: float(v) for k, v in m.items()}
    out = {}
    for key in ("total_loss", "grad_norm"):
        want = ref["metrics"][key]
        rel = abs(got[key] - want) / abs(want)
        out[f"{key}_rel_err"] = rel
        if not rel <= PARALLEL_TOL[key]:
            raise AssertionError(f"{label}: {key} {got[key]} against one process's {want} "
                                 f"(relative {rel:.3g} > {PARALLEL_TOL[key]})")
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    mus = {n: m_ for g, names in opt.names.items() for n, m_ in zip(names, opt.mu[g])}
    for name in ref["after"]:
        p = params[name]
        cut = lambda t: sharding.cut_like(t.to(p.device), p, mesh)
        step = (cut(ref["after"][name]) - cut(ref["before"][name])).abs().max().item()
        diff = (p.detach() - cut(ref["after"][name])).abs()
        agree = (diff <= 0.01 * step).float().mean().item()
        cos = F.cosine_similarity(mus[name].flatten().float(),
                                  cut(ref["mu"][name]).flatten().float(), dim=0).item()
        short = name.split(".", 2)[-1]
        out[short] = {"max_diff_over_step": diff.max().item() / step, "agree": agree,
                      "mu_cosine": cos, "shape": list(p.shape)}
        if not (diff.max().item() <= PARALLEL_TOL["move"] * step
                and cos >= PARALLEL_TOL["cosine"]):
            raise AssertionError(f"{label}: {name} {out[short]} against {PARALLEL_TOL}")
    return got, out


def _a_prime_rank(dev, mesh, k):
    """A′ on this rank's heads of ViT-H's global block (1x50x76) and its 24
    windows of 14x14, bf16: against the plain version on the same heads and
    against the slice of kernel A on all 16 heads; then, one rank at a time
    (the others wait), its time, the plain version's and SDPA's with a float
    bias mask on the same heads."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from uninext_tpu_torch.models import vit
    nh, hd, dt = 16, 80, torch.bfloat16
    nl = nh // k
    heads = slice(mesh.model_rank * nl, (mesh.model_rank + 1) * nl)
    g = torch.Generator(device=dev).manual_seed(0)          # the same on every rank
    H, W = IMAGE_HW[0] // 16, IMAGE_HW[1] // 16
    rec = {}
    for label, (B, h, w) in (("global", (1, H, W)), ("window", (24, 14, 14))):
        S = h * w
        base, rh, rw = _attention_inputs(dev, g, B, h, w, nh, hd)
        rh, rw = rh.to(dt), rw.to(dt)
        q, kk, v = base.to(dt).unbind(2)
        whole = vit.flash_rel_pos_attention(q.reshape(B, h, w, nh, hd), kk, v, rh, rw,
                                            hd ** -0.5)
        lq, lk, lv = base.to(dt)[:, :, :, heads].contiguous().unbind(2)
        args = (lq.reshape(B, h, w, nl, hd), lk, lv, rh, rw, hd ** -0.5)
        got = vit.flash_rel_pos_attention_tp(*args)
        err = _check(f"A' k={k} {label}", got, vit.rel_pos_attention_plain(*args), 3.2e-2)
        err_a = _check(f"A' k={k} {label} against kernel A on all heads", got,
                       whole.reshape(B, h, w, nh, hd)[..., heads, :].reshape(got.shape),
                       3.2e-2)
        sq, sk, sv, bias = _sdpa_args(*args[:5])
        b_ms, b_by = _bound(2 * (4 * B * S * nl * hd + h * h * hd + w * w * hd),
                            B * nl * (4 * S * S * hd + 2 * S * (h + w) * hd), "bf16")
        times = None
        for turn in range(mesh.model_size):
            dist.barrier(group=mesh.model_group)
            if turn == mesh.model_rank:
                times = (_timed(lambda: vit.flash_rel_pos_attention_tp(*args), 20),
                         _timed(lambda: vit.rel_pos_attention_plain(*args), 3),
                         _timed(lambda: F.scaled_dot_product_attention(
                             sq, sk, sv, attn_mask=bias), 20))
        dist.barrier(group=mesh.model_group)
        ms, pms, lib = times
        print(f"[parallel] A' k={k} rank {mesh.rank} (heads {heads.start}-{heads.stop - 1}) "
              f"{label} B={B} {h}x{w}x{nl}x{hd} bf16: max_abs_err {err:.3g} against the plain "
              f"version, {err_a:.3g} against kernel A on all 16 heads (tol 3.2e-2); {ms:.4f} ms "
              f"({100 * b_ms / ms:.1f}% of its bound {b_ms:.4f} ms, {b_by}), plain {pms:.3f} "
              f"ms, SDPA with a float bias mask {lib:.4f} ms (alone on the card)", flush=True)
        rec[label] = {"max_abs_err": max(err, err_a), "ms": ms, "plain_ms": pms,
                      "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
        del base, q, kk, v, whole, lq, lk, lv, got, sq, sk, sv, bias
        torch.cuda.empty_cache()
    return rec


def _parallel_rank(dev, ref_path):
    """One rank of the parallel phase: A′ at k = 2 (ranks 0, 1) and k = 4;
    the ViT-H step on a 1 dp x 2 tp mesh (ranks 0, 1) and the R50 step on a
    2 dp x 1 tp mesh (ranks 2, 3, or 0, 1 with two ranks), each held to the
    one-process step; kernel launches counted around each step."""
    import torch
    import torch.distributed as dist
    from uninext_tpu_torch.config import image_joint_r50, image_joint_vit_huge
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    from uninext_tpu_torch.models import vit
    from uninext_tpu_torch.parallel.mesh import create_mesh, shard_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    # every rank makes every group, in one order
    tp = create_mesh(2, ranks=[0, 1])
    dp = create_mesh(1, ranks=[2, 3] if world >= 4 else [0, 1])
    m4 = create_mesh(4, ranks=[0, 1, 2, 3]) if world >= 4 else None
    out = {"rank": rank}
    if tp is not None:
        out["a_prime_k2"] = _a_prime_rank(dev, tp, 2)
    if m4 is not None:
        out["a_prime_k4"] = _a_prime_rank(dev, m4, 4)
    ref = torch.load(ref_path, map_location="cpu", weights_only=True)
    counters = _counters()
    steps = [("vit", image_joint_vit_huge(), tp, True)] if tp is not None else []
    if dp is not None:
        steps.append(("r50", image_joint_r50(), dp, False))
    for key, cfg, mesh, cut in steps:
        label = (f"image_joint_vit_huge 1 dp x 2 tp rank {rank}" if cut else
                 f"image_joint_r50 2 dp x 1 tp rank {rank}")
        state = build_train_state(cfg, dev, seed=0, mesh=mesh, tp=cut)
        batch = shard_batch(_train_batch(cfg, dev), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        vit.flash_rel_pos_attention.recompute_launches = 0
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        recompute = vit.flash_rel_pos_attention.recompute_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, held = _hold_step(label, state, m, ref[key], mesh)
        t = cfg.transformer
        n_msda = t.enc_layers + t.dec_layers
        expect = {**dict.fromkeys(counters, 0),
                  "ms_deform_attn_fwd": n_msda + (t.enc_layers if cfg.remat_encoder else 0),
                  "ms_deform_attn_bwd": n_msda}
        if cut:
            blocks = cfg.backbone.vit_depth
            n_a = blocks * (2 if cfg.backbone.vit_use_checkpoint else 1)
            expect.update(rel_pos_flash_attn=n_a, rel_pos_flash_attn_tp=n_a,
                          rel_pos_flash_attn_bwd=blocks)
        _check_launches(label, launches, expect)
        print(f"[parallel] {label}: bs={batch['images'].shape[0]} on this rank at "
              f"{IMAGE_HW[0]}x{IMAGE_HW[1]}; step {ms:.1f} ms (gloo on one card: not a speed "
              f"of the parallel step), peak device memory {peak:.2f} GiB; total_loss "
              f"{got['total_loss']:.6g} (one process {ref[key]['metrics']['total_loss']:.6g}), "
              f"grad norm {got['grad_norm']:.6g} ({ref[key]['metrics']['grad_norm']:.6g}); "
              f"held: {json.dumps(held)}; launches {launches}"
              + (f", of kernel A {recompute} recomputes, A' {launches['rel_pos_flash_attn_tp']}"
                 f" at {16 // 2} heads" if cut else ""), flush=True)
        out[key] = {"launches": launches, "recompute": recompute, "ms": ms, "peak_gib": peak,
                    "metrics": got, "held": held}
        del state, batch, m
        torch.cuda.empty_cache()
    return out


def phase_parallel(vit_h, r50):
    """Data and tensor parallelism on the card: the one-process references,
    then 4 ranks (`parallel/mesh.py:launch`, spawned) that share the one
    card over gloo (NCCL refuses two ranks on one device); with 2 or more
    cards the same checks again over NCCL, one rank per card. Returns the
    records of A′ and the launches of the two parallel steps, summed over
    their ranks."""
    import tempfile
    import torch
    from uninext_tpu_torch.parallel.mesh import launch
    t0 = time.perf_counter()
    refs = {}
    dev = torch.device("cuda")
    _one_process_reference(vit_h, "image_joint_vit_huge", "vit", refs, dev)
    _one_process_reference(r50, "image_joint_r50", "r50", refs, dev)
    n_cards = torch.cuda.device_count()
    runs = [("gloo", 4)]
    if n_cards >= 2:
        runs.append(("nccl", min(4, n_cards)))
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.pt")
        torch.save(refs, ref_path)
        results = {}
        for backend, n in runs:
            print(f"[parallel] {n} ranks over {backend}, torch.cuda.device_count() = "
                  f"{n_cards}: " + ("the ranks share one card (NCCL refuses two ranks on one "
                                    "device)" if backend == "gloo" else "one rank per card"),
                  flush=True)
            results[backend] = launch(_parallel_rank, n, backend, None, ref_path)
    ranks = results["gloo"]
    count = lambda key: {k: sum(r[key]["launches"][k] for r in ranks if key in r)
                         for k in ranks[0]["vit"]["launches"]}
    launches = {"vith_tp_training": count("vit"), "r50_dp_training": count("r50")}
    k2 = [r["a_prime_k2"] for r in ranks if "a_prime_k2" in r]
    k4 = [r["a_prime_k4"] for r in ranks if "a_prime_k4" in r]
    a = k2[0]["global"]
    rec = {"max_abs_err": max(x[lbl]["max_abs_err"] for x in k2 + k4 for lbl in x),
           **{key: a[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
           "shape": "global 1x50x76x8x80 bf16 per rank at k=2 (kernel A on the rank's heads)",
           "launches_per_rank": [r["vit"]["launches"]["rel_pos_flash_attn_tp"]
                                 for r in ranks if "vit" in r],
           "peak_gib_per_rank": {p: [r[p]["peak_gib"] for r in ranks if p in r]
                                 for p in ("vit", "r50")},
           "step_rel_err": {p: [{k: r[p]["held"][k] for k in ("total_loss_rel_err",
                                                               "grad_norm_rel_err")}
                                for r in ranks if p in r] for p in ("vit", "r50")}}
    for tag, per in (("k2", k2), ("k4", k4)):
        for lbl in ("global", "window"):
            rec[f"{tag}_{lbl}_ms_per_rank"] = [x[lbl]["ms"] for x in per]
            rec[f"{tag}_{lbl}_plain_ms_per_rank"] = [x[lbl]["plain_ms"] for x in per]
            rec[f"{tag}_{lbl}_library_ms_per_rank"] = [x[lbl]["library_ms"] for x in per]
            rec[f"{tag}_{lbl}_bound_ms"] = per[0][lbl]["bound_ms"]
    if "nccl" in results:
        rec["nccl_ranks"] = len(results["nccl"])
    print(f"[parallel] done in {time.perf_counter() - t0:.1f} s: A' per rank at k=2 "
          f"{rec['k2_global_ms_per_rank']} ms, at k=4 {rec['k4_global_ms_per_rank']} ms "
          f"(ranks timed one at a time on the one card; SDPA {rec['k2_global_library_ms_per_rank']}"
          f", {rec['k4_global_library_ms_per_rank']}); A' launches per ViT-H TP rank "
          f"{rec['launches_per_rank']}", flush=True)
    return rec, launches


# ---- the training recipe: BoxInst, the stage hand-off, the routed stages ------

RECIPE_BOXINST_STEPS = 3


def _patch_images(B, Hh, Ww, seed):
    """(B, Hh, Ww, 3) in [0, 255]: flat colour patches of 32 to 160 pixels and
    a little noise, so that most neighbours pass BoxInst's 0.3 similarity
    threshold (on random pixels almost none does)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    img = np.zeros((B, Hh, Ww, 3), np.float32)
    for b in range(B):
        y = 0
        while y < Hh:
            dy = rng.randint(32, 161)
            x = 0
            while x < Ww:
                dx = rng.randint(32, 161)
                img[b, y:y + dy, x:x + dx] = rng.uniform(0, 255, 3)
                x += dx
            y += dy
    return np.clip(img + rng.randn(*img.shape) * 1.0, 0, 255).astype(np.float32)


def _boxinst_batch(cfg, dev):
    """`_train_batch` (bs=2 at 800x1216, image 1 valid on 800x1088) with
    BoxInst's targets and no gt masks: images of flat colour patches
    (normalised, zero on the padding), each image's colour similarity from
    `data/boxinst.py:color_similarity` (the bottom rows of its valid area
    cleared as the mapper clears them) and the box bitmasks of its boxes
    from `boxes_to_bitmasks`."""
    import numpy as np
    import torch
    from uninext_tpu_torch.data.boxinst import boxes_to_bitmasks, color_similarity
    b = _train_batch(cfg, dev)
    B, (Hh, Ww) = TRAIN_BATCH, IMAGE_HW
    raw = _patch_images(B, Hh, Ww, seed=21)
    mean, std = np.array(cfg.data.pixel_mean, np.float32), np.array(cfg.data.pixel_std,
                                                                     np.float32)
    sizes = b["image_sizes"].cpu().numpy()
    boxes = b["targets"]["boxes"].cpu().numpy()
    valid = b["targets"]["valid"].cpu().numpy()
    images, sims, bits = (raw - mean) / std, [], []
    pr = cfg.loss.boxinst_bottom_pixels_removed
    for i, (h, w) in enumerate(sizes):
        images[i, :, w:] = 0
        raw[i, :, w:] = mean
        vm = np.zeros((Hh, Ww), np.float32)
        vm[:h - pr, :w] = 1.0
        sims.append(color_similarity(raw[i], vm))
        xyxy = np.concatenate([boxes[i, :, :2] - boxes[i, :, 2:] / 2,
                               boxes[i, :, :2] + boxes[i, :, 2:] / 2], -1) * [w, h, w, h]
        bits.append(boxes_to_bitmasks(xyxy, valid[i], Hh, Ww))
    b["images"] = torch.from_numpy(images).to(dev)
    b["targets"].update(has_masks=True, box_bitmasks=torch.from_numpy(np.stack(bits)).to(dev),
                        color_similarity=torch.from_numpy(np.stack(sims)).to(dev))
    return b


def _recording_boxinst():
    """A pass-through in front of `models/criterion.py:loss_masks_boxinst`
    (`models/detr.py` calls it through the module) that, while `on[0]`,
    keeps each call's inputs and losses on the card. Returns the records,
    the switch and a function that takes the pass-through out again."""
    from uninext_tpu_torch.models import criterion
    real, seen, on = criterion.loss_masks_boxinst, [], [False]

    def recording(*args):
        out = real(*args)
        if on[0]:
            seen.append(([a.detach().clone() if hasattr(a, "detach") else a for a in args],
                         {k: v.detach() for k, v in out.items()}))
        return out

    criterion.loss_masks_boxinst = recording
    return seen, on, lambda: setattr(criterion, "loss_masks_boxinst", real)


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _numpy_batch(batch, task):
    """A batch of tensors as the loader's numpy batch, routed to `task`."""
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items() if k != "has_masks"}
        return x.cpu().numpy()
    return {**host(batch), "__task__": task}


class _LaunchLog:
    """A trainer hook: each micro-step's kernel launches."""

    def __init__(self, counters):
        self.counters, self.per_step, self.ms = counters, [], []

    def before_train(self, trainer):
        pass

    def after_train(self, trainer):
        pass

    def before_step(self, trainer):
        self.before = {k: c.launches for k, c in self.counters.items()}

    def after_step(self, trainer, metrics):
        self.per_step.append({k: c.launches - self.before[k]
                              for k, c in self.counters.items()})
        self.ms.append(float(metrics["time"]) * 1e3)
        bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"recipe: non-finite {bad} at micro-step "
                                 f"{trainer.state.step}")


def phase_recipe(dev=None):
    """UNINEXT's three-stage training recipe at full width, one stage after
    the other (`uninext_tpu_torch/tools/pipeline_check.py`'s flow at the
    slice's sizes):
      a. BoxInst: `image_joint_r50` with `loss.boxinst` (warm-up 1, so the
         pairwise term is at full weight from the second step),
         RECIPE_BOXINST_STEPS steps of `train_step` on `_boxinst_batch`;
         every loss finite, `loss_prj` and `loss_pairwise` above 0 on step
         2, the card's two losses of every layer of step 2 equal to
         `loss_masks_boxinst` on CPU copies of that step's mask logits and
         targets (1e-4 relative); then one instance-segmentation request of
         the trained model (MSDA 12, NMS 1), NMS held to its plain version
         on its input;
      b. the hand-off: the BoxInst state saved by `CheckpointManager`, a
         `Trainer` of `image_joint_r50` (other weights) restored from the
         file by `restore_params` (bit-equal to the BoxInst model), then a
         routed detection step and a grounding step;
      c. `video_joint_r50` with the template branch: a `Trainer(video=True)`
         on a routed loader whose first batch is a VIS pair and second a
         SOT pair (ROADMAP §3.23), its weights from stage b's by
         `load_stage_weights` (inflated >= 1, remapped template > 0, no
         mismatch; the template conv1's 4th input channel zero, its first
         three the image conv1), two steps.
    Launches per step asserted (BoxInst, detection, grounding, SOT: MSDA 18,
    MSDA-bwd 12; VIS: 40, 22), as paths "recipe_boxinst", "recipe_image_joint"
    and "recipe_video_joint"; then MSDA and MSDA-bwd against their plain
    versions at every shape the phase gave them. Returns (launches by path,
    MSDA checks, NMS check)."""
    import dataclasses
    import tempfile
    import torch
    from uninext_tpu_torch.config import image_joint_r50, video_joint_r50
    from uninext_tpu_torch.data.tokenizer import BertTokenizer
    from uninext_tpu_torch.engine.checkpoint import (BACKBONE, TEMPLATE_BACKBONE,
                                                     CheckpointManager, load_stage_weights)
    from uninext_tpu_torch.engine.train import build_train_state, train_step
    from uninext_tpu_torch.engine.trainer import Trainer
    from uninext_tpu_torch.models import criterion
    from uninext_tpu_torch.models import postprocess
    from uninext_tpu_torch.models.postprocess import postprocess_detection, take_queries
    from uninext_tpu_torch.ops import nms
    dev = dev or torch.device("cuda")
    t_phase = time.perf_counter()
    counters = _counters()
    base = image_joint_r50()
    cfg1 = dataclasses.replace(base, loss=dataclasses.replace(
        base.loss, boxinst=True, boxinst_warmup_iters=1))
    t = cfg1.transformer
    n_remat = t.enc_layers if cfg1.remat_encoder else 0
    step_expect = {**dict.fromkeys(counters, 0),
                   "ms_deform_attn_fwd": t.enc_layers + t.dec_layers + n_remat,
                   "ms_deform_attn_bwd": t.enc_layers + t.dec_layers}
    launches = {}
    msda_calls, unrecord_msda = _recording_msda()

    # a. BoxInst
    state = build_train_state(cfg1, dev, seed=0)
    batch = _boxinst_batch(cfg1, dev)
    tg = batch["targets"]
    n_pass = float((tg["color_similarity"] >= cfg1.loss.boxinst_pairwise_color_thresh)
                   .float().mean())
    N = cfg1.mask_head.max_insts
    h4, w4 = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    print(f"[recipe] a. BoxInst on image_joint_r50, bs={TRAIN_BATCH} at {IMAGE_HW[0]}x"
          f"{IMAGE_HW[1]} (image 1 valid on "
          f"{'x'.join(map(str, batch['image_sizes'][1].tolist()))}), gt boxes "
          f"{tg['valid'].sum(1).tolist()}, no gt masks: box bitmasks "
          f"{tuple(tg['box_bitmasks'].shape)}, colour similarity "
          f"{tuple(tg['color_similarity'].shape)} ({100 * n_pass:.1f}% of the neighbours at "
          f"or above {cfg1.loss.boxinst_pairwise_color_thresh}); warm-up "
          f"{cfg1.loss.boxinst_warmup_iters}; one pairwise tensor (B, N={N}, 8, {h4}, {w4}) "
          f"in fp32 would be {TRAIN_BATCH * N * 8 * h4 * w4 * 4 / 1e6:.0f} MB, the port "
          f"takes the term one neighbour at a time under checkpointing")
    records, recording_on, unrecord_boxinst = _recording_boxinst()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics, per_step = [], [], []
    for i in range(RECIPE_BOXINST_STEPS):
        recording_on[0] = i == 1
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c.launches - before[k] for k, c in counters.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    recording_on[0] = False
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    # one instance-segmentation request of the trained model
    nms_calls, unrecord_nms = _recording_nms(postprocess)
    _, _, cmap = _prompt(cfg1)
    cmap = torch.from_numpy(cmap).to(dev)
    before = {k: c.launches for k, c in counters.items()}
    model = state.model.eval()
    with torch.inference_mode():
        sl = slice(0, 1)
        out = model(batch["images"][sl], batch["img_mask"][sl], batch["image_sizes"][sl],
                    batch["text_ids"][sl], batch["text_mask"][sl], task="detection")
        post = postprocess_detection(out, cmap, use_nms=cfg1.loss.ota)
        idx = post["query_idx"]
        masks = model.predict_masks(out["memory"], out["spatial_shapes"],
                                    take_queries(out["hs"], idx),
                                    take_queries(out["base_reference"], idx),
                                    batch["image_sizes"][sl])
    torch.cuda.synchronize()
    eval_launches = {k: c.launches - before[k] for k, c in counters.items()}
    unrecord_nms()
    launches["recipe_boxinst"] = {k: c.launches for k, c in counters.items()}
    unrecord_boxinst()
    for i, m in enumerate(metrics):
        print(f"[recipe] BoxInst step {i + 1}: total_loss {m['total_loss']:.6g}, "
              f"{step_ms[i]:.1f} ms; loss_prj {m['loss_prj']:.6g}, loss_pairwise "
              f"{m['loss_pairwise']:.6g} (layer 0: {m['loss_prj_0']:.6g}, "
              f"{m['loss_pairwise_0']:.6g})")
    print(f"[recipe] BoxInst step ms (host clock, synchronised): "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak device memory {peak_a:.2f} GiB (max_memory_allocated); launches per "
          f"step {_nonzero(per_step[0])}; expected {_nonzero(step_expect)}")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"BoxInst step {i + 1}: non-finite {bad}")
        if any(k.startswith(("loss_mask", "loss_dice")) for k in m):
            raise AssertionError(f"BoxInst step {i + 1}: gt-mask losses {sorted(m)}")
    if metrics[0]["loss_pairwise"] != 0.0:
        raise AssertionError(f"BoxInst step 1 (warm-up factor 0): loss_pairwise "
                             f"{metrics[0]['loss_pairwise']}")
    if not (metrics[1]["loss_prj"] > 0 and metrics[1]["loss_pairwise"] > 0):
        raise AssertionError(f"BoxInst step 2: loss_prj {metrics[1]['loss_prj']}, "
                             f"loss_pairwise {metrics[1]['loss_pairwise']}")
    for counts in per_step:
        _check_launches("BoxInst step", counts, step_expect)
    eval_expect = {**dict.fromkeys(counters, 0),
                   "ms_deform_attn_fwd": t.enc_layers + t.dec_layers, "nms": 1}
    _check_launches("BoxInst instance-segmentation request", eval_launches, eval_expect)
    if masks.shape != (1, idx.shape[1], h4, w4) or not torch.isfinite(masks).all():
        raise AssertionError(f"BoxInst request: masks {tuple(masks.shape)}")
    # the card's BoxInst losses against the same function on CPU copies
    if len(records) != t.dec_layers:
        raise AssertionError(f"{len(records)} BoxInst loss calls in step 2, not "
                             f"{t.dec_layers}")
    loss_err = 0.0
    for args, got in records:
        cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
        want = criterion.loss_masks_boxinst(*cpu)
        for k, v in want.items():
            err = abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-12)
            loss_err = max(loss_err, err)
            if not err <= 1e-4:
                raise AssertionError(f"BoxInst {k}: card {float(got[k])} vs CPU {float(v)}")
    print(f"[recipe] BoxInst losses of step 2 on the card equal loss_masks_boxinst on CPU "
          f"copies of the step's mask logits {tuple(records[0][0][0].shape)} and targets, "
          f"all {len(records)} layers, within {loss_err:.3g} relative (tolerance 1e-4)")
    kept = []
    for boxes, scores, classes, thr, valid in nms_calls:
        half = (scores > scores.median()).contiguous()
        for v in (valid, half):
            got = nms.batched_nms(boxes, scores, classes, thr, valid=v)
            if not torch.equal(got, nms.batched_nms_plain(boxes, scores, classes, thr,
                                                          valid=v)):
                raise AssertionError("BoxInst request: NMS keep mask differs from the "
                                     "plain version")
            kept.append(int(got.sum()))
    print(f"[recipe] instance segmentation request of the BoxInst model: masks "
          f"{tuple(masks.shape)}, launches {_nonzero(eval_launches)}; NMS keep masks identical to the "
          f"plain version's at its {len(nms_calls)} input(s), kept {kept} (as given; with "
          f"the upper half of the scores valid)")
    del out, post, masks

    # b. the hand-off into the image joint stage
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as root:
        ckpt_dir = os.path.join(root, "stage1")
        t0 = time.perf_counter()
        CheckpointManager(ckpt_dir).save(state.step, state)
        save_s = time.perf_counter() - t0
        stage1 = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        del state, model
        torch.cuda.empty_cache()
        cfg2 = dataclasses.replace(base, solver=dataclasses.replace(
            base.solver, max_iter=2, checkpoint_period=10 ** 9))
        det = _train_batch(cfg2, dev)
        tok = BertTokenizer()
        T = det["text_ids"].shape[1]
        expr = tok("the large red shape on the left of the picture", max_length=T)
        grd = {**det, "text_ids": torch.from_numpy(expr["input_ids"]).long()[None]
               .expand(TRAIN_BATCH, T).to(dev),
               "text_mask": torch.from_numpy(expr["attention_mask"])[None]
               .expand(TRAIN_BATCH, T).to(dev)}
        routed = iter([_numpy_batch(det, "detection"), _numpy_batch(grd, "grounding"),
                       _numpy_batch(det, "detection")])
        log2 = _LaunchLog(counters)
        tr2 = Trainer(cfg2, routed, output_dir=os.path.join(root, "stage2"), device=dev,
                      seed=1, log_period=1, extra_hooks=[log2])
        t0 = time.perf_counter()
        _, found = CheckpointManager(ckpt_dir).restore_params(tr2.model)
        restore_s = time.perf_counter() - t0
        diff = [k for k, v in tr2.model.state_dict().items() if not torch.equal(v, stage1[k])]
        if not found or diff:
            raise AssertionError(f"restore_params: found {found}, differs at {diff[:5]}")
        print(f"[recipe] b. BoxInst state saved in {save_s:.1f} s (step "
              f"{CheckpointManager(ckpt_dir).latest_step()}), restored by restore_params "
              f"into a Trainer of image_joint_r50 (other weights) in {restore_s:.1f} s: "
              f"all {len(stage1)} tensors bit-equal")
        del stage1
        for c in counters.values():
            c.launches = 0
        tr2.train()
        launches["recipe_image_joint"] = {k: c.launches for k, c in counters.items()}
        print(f"[recipe] routed detection, then grounding step: "
              f"{', '.join(f'{x:.1f}' for x in log2.ms)} ms (host clock to the end of each "
              f"step's device work); launches per step "
              f"{[_nonzero(c) for c in log2.per_step]}")
        for counts in log2.per_step:
            _check_launches("image joint step", counts, step_expect)
        image = {k: v.detach().clone() for k, v in tr2.model.state_dict().items()}
        del tr2, det, grd
        torch.cuda.empty_cache()

        # c. into video_joint_r50 with the template branch
        vcfg = video_joint_r50()
        vcfg = dataclasses.replace(vcfg, solver=dataclasses.replace(
            vcfg.solver, max_iter=2, checkpoint_period=10 ** 9))
        pair = _video_train_batch(vcfg, dev)
        routed = iter([_numpy_batch(pair, "detection"), _numpy_batch(pair, "sot"),
                       _numpy_batch(pair, "detection")])
        log3 = _LaunchLog(counters)
        tr3 = Trainer(vcfg, routed, output_dir=os.path.join(root, "stage3"), device=dev,
                      seed=2, video=True, log_period=1, extra_hooks=[log3])
        if not tr3.model.template:
            raise AssertionError("a routed video Trainer built no template branch")
        sd, rep = load_stage_weights(tr3.model.state_dict(), image)
        tr3.model.load_state_dict(sd)
        conv1 = tr3.model.state_dict()[TEMPLATE_BACKBONE + "stem.conv1.weight"]
        print(f"[recipe] c. hand-off into video_joint_r50 with the template branch: loaded "
              f"{rep['loaded']}, inflated {rep['inflated']}, template-remapped "
              f"{rep['remapped_template']}, {len(rep['missing'])} left at init, "
              f"{len(rep['mismatched'])} mismatched; template conv1 "
              f"{tuple(conv1.shape)}")
        if rep["inflated"] < 1 or rep["remapped_template"] <= 0 or rep["mismatched"]:
            raise AssertionError(f"hand-off report {rep}")
        if conv1[:, 3].any() or not torch.equal(conv1[:, :3],
                                                image[BACKBONE + "stem.conv1.weight"]):
            raise AssertionError("the template conv1 is not the image conv1 inflated")
        del image, sd
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        tr3.train()
        launches["recipe_video_joint"] = {k: c.launches for k, c in counters.items()}
        peak_c = torch.cuda.max_memory_allocated() / 2 ** 30
        n_reid = vcfg.n_layer_deformable_reid
        vt = vcfg.transformer
        n_remat_v = vt.enc_layers if vcfg.remat_encoder else 0
        vis_expect = {**dict.fromkeys(counters, 0),
                      "ms_deform_attn_fwd": 2 * (vt.enc_layers + vt.dec_layers + n_reid
                                                 + n_remat_v),
                      "ms_deform_attn_bwd": 2 * vt.enc_layers + vt.dec_layers + 2 * n_reid
                      + (0 if vcfg.detach_reid else vt.dec_layers)}
        sot_expect = {**dict.fromkeys(counters, 0),
                      "ms_deform_attn_fwd": vt.enc_layers + vt.dec_layers + n_remat_v,
                      "ms_deform_attn_bwd": vt.enc_layers + vt.dec_layers}
        print(f"[recipe] routed VIS pair, then SOT pair step: "
              f"{', '.join(f'{x:.1f}' for x in log3.ms)} ms; peak device memory "
              f"{peak_c:.2f} GiB; launches per step {[_nonzero(c) for c in log3.per_step]}")
        _check_launches("VIS pair step", log3.per_step[0], vis_expect)
        _check_launches("SOT pair step", log3.per_step[1], sot_expect)
        del tr3, pair
    unrecord_msda()
    torch.cuda.empty_cache()
    checks = _check_msda_calls(msda_calls, label="recipe")
    print(f"[recipe] done in {time.perf_counter() - t_phase:.1f} s")
    return launches, checks, {"recipe_nms_inputs": len(nms_calls)}


def _convnext_reference():
    """The small ConvNeXt model of `uninext_tpu_torch/tools/convnext_check.py`
    (`tiny_convnext_cfg`: depths 2/2/4/2, dims 32/64/96/128, drop-path 0)
    on the card against the same weights on the CPU, fp32: serving with the
    instance masks and REC/RES, one train step (`_reference_pair`). Returns
    the launches of this path."""
    import torch
    from uninext_tpu_torch.tools.convnext_check import tiny_convnext_cfg
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    _reference_pair(tiny_convnext_cfg(10), "ConvNeXt", ("detection", "masks"), (64, 96))
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def _convnext_handoff():
    """`load_stage_weights` from `image_joint_convnext_large` (seed 0) into
    `video_joint_convnext_large` with the template branch (seed 1): every
    image tensor loaded, the 4-channel template ConvNeXt taken from the
    image one with its stem (192, 3, 4, 4) inflated to (192, 4, 4, 4), a
    zero 4th channel, no shape skipped; the new tensors are the reid head's,
    the fuser's, `adjust_layer`'s. The video model loads the result."""
    import torch
    from uninext_tpu_torch.config import image_joint_convnext_large, video_joint_convnext_large
    from uninext_tpu_torch.engine.checkpoint import (BACKBONE, TEMPLATE_BACKBONE,
                                                     load_stage_weights)
    from uninext_tpu_torch.models.detr import build_model
    t0 = time.perf_counter()
    image = build_model(image_joint_convnext_large(), seed=0).state_dict()
    video = build_model(video_joint_convnext_large(), seed=1, template=True)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd, rep = load_stage_weights(video.state_dict(), image, verbose=False)
    video.load_state_dict(sd)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stem = "downsample_layers.0.0.weight"
    t_stem = video.state_dict()[TEMPLATE_BACKBONE + stem]
    template = [k for k in sd if k.startswith(TEMPLATE_BACKBONE)]
    new = sorted({k.split(".")[1] if k.startswith("detr.") else k.split(".")[0]
                  for k in rep["missing"]})
    if (rep["inflated"] != 1 or rep["mismatched"] or rep["remapped_template"] != len(template)
            or rep["loaded"] != len(image) + len(template)
            or t_stem.shape != (192, 4, 4, 4)
            or not torch.equal(t_stem[:, :3], image[BACKBONE + stem])
            or bool(t_stem[:, 3].any())
            or any(not k.startswith(("detr.reid_embed_head.", "detr.sot_fuser.",
                                     "detr.adjust_layer.")) for k in rep["missing"])):
        raise AssertionError(f"ConvNeXt hand-off: {({k: v for k, v in rep.items() if k != 'missing'})}, "
                             f"new {new}, template stem {tuple(t_stem.shape)}")
    print(f"[convnext] hand-off image_joint_convnext_large -> video_joint_convnext_large "
          f"(template branch): loaded {rep['loaded']} tensors (inflated {rep['inflated']}: the "
          f"template stem (192, 3, 4, 4) -> (192, 4, 4, 4), 4th channel zero; template-remapped "
          f"{rep['remapped_template']} from the image ConvNeXt), {len(rep['missing'])} new "
          f"(the {', '.join(new)}), {len(rep['mismatched'])} shape-skipped; models built in "
          f"{built_s:.1f} s, hand-off and load {load_s:.1f} s")
    del image, video, sd
    torch.cuda.empty_cache()


def _roberta_request():
    """One REC/RES request of `image_joint_r50` with the RoBERTa tower
    (`roberta_base_language()`: 50265 ids, 514 positions, one token type):
    20 ids from a seeded draw, the last 6 the pad id 1 (masked out; RoBERTa
    takes its positions from the ids), at IMAGE_HW, through the grounding
    forward and `postprocess_rec` (MSDA 12, NMS 0). Returns its launches."""
    import dataclasses
    import torch
    from uninext_tpu_torch.config import image_joint_r50, roberta_base_language
    from uninext_tpu_torch.models.detr import build_model
    from uninext_tpu_torch.models.postprocess import postprocess_rec
    dev = torch.device("cuda")
    cfg = dataclasses.replace(image_joint_r50(), language=roberta_base_language())
    model = build_model(cfg, seed=0).eval()
    n_lang = sum(p.numel() for p in model.bert.parameters())
    g = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(3, cfg.language.vocab_size, (1, 20), device=dev, generator=g)
    ids[:, 14:] = cfg.language.pad_token_id
    tmask = (ids != cfg.language.pad_token_id).int()
    img, pad, sizes = _serving_requests(dev)[0]
    counters = _counters()
    t = cfg.transformer
    expect = {**dict.fromkeys(counters, 0), "ms_deform_attn_fwd": t.enc_layers + t.dec_layers}
    ms = []
    with torch.inference_mode():
        for r in range(3):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            out = model(img, pad, sizes, ids, tmask, task="grounding")
            post = postprocess_rec(model, out, sizes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: c.launches for k, c in counters.items()}
            _check_outputs("rec", out, post, cfg)
            if launches != expect:
                raise AssertionError(f"RoBERTa request: launches {launches} != {expect}")
    print(f"[convnext] image_joint_r50 with RoBERTa ({n_lang / 1e6:.2f}M parameters in the "
          f"language tower, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M in all): "
          f"REC/RES requests of 20 ids (6 of them pad id 1) at {IMAGE_HW[0]}x{IMAGE_HW[1]}, "
          f"ms {', '.join(f'{x:.1f}' for x in ms)}; box {[round(x, 4) for x in post['box'][0].tolist()]}; "
          f"launches per request {_nonzero(expect)}")
    del model, out, post
    torch.cuda.empty_cache()
    return launches


def phase_convnext(profile: bool):
    """ConvNeXt-L (`image_joint_convnext_large`, `video_joint_convnext_large`:
    depths 3/3/27/3, dims 192-1536, drop-path 0.7, random weights from a
    seed) and RoBERTa, at full width: the three serving paths (detection,
    instance masks, REC/RES; phase 7's requests), the training step (bs=2 at
    800x1216, drop-path 0.7 on; 1 warm-up and 3 timed steps; the stem frozen
    and bit-equal, a stage-1 MLP moves), the small ConvNeXt model card vs
    CPU (phase 4's check), the stage hand-off into the video preset with its
    4-channel template ConvNeXt, SOT, VOS and R-VOS serving through the
    template ConvNeXt (phase 13), the SOT training step (phase 14: the
    4-channel trunk's backward), and one REC/RES request of `image_joint_r50`
    with the RoBERTa tower. Every MSDA call's shapes are recorded, and MSDA
    and MSDA-bwd are held to their plain versions there (3.2e-2, 1.6e-2 in
    bf16); the requests' NMS keep masks must equal the plain version's.
    Returns ({path: launches}, {kernel: checks})."""
    import torch
    from uninext_tpu_torch.config import image_joint_convnext_large, video_joint_convnext_large
    from uninext_tpu_torch.models import postprocess
    from uninext_tpu_torch.ops import nms
    t_phase = time.perf_counter()
    img, vid = image_joint_convnext_large(), video_joint_convnext_large()
    launches, checks = {}, {}
    calls, unrecord = _recording_msda()
    nms_calls, unrecord_nms = _recording_nms(postprocess)
    try:
        serving = phase_serving(img, "image_joint_convnext_large",
                                ("detection", "instseg", "rec"), profile)
        launches.update({f"convnext_{task}": n for task, n in serving.items()})
        unrecord_nms()
        launches["convnext_training"] = phase_training(img, "image_joint_convnext_large",
                                                       CONVNEXT_TRAIN_STEPS, profile)
        launches["convnext_reference"] = _convnext_reference()
        _convnext_handoff()
        sot_launches, sot_rec = phase_sot_serving(vid, "video_joint_convnext_large")
        launches.update({f"convnext_{path}": n for path, n in sot_launches.items()})
        launches["convnext_sot_training"], sot_checks = phase_sot_training(
            vid, SOT_TRAIN_STEPS, "video_joint_convnext_large")
        launches["roberta_rec"] = _roberta_request()
    finally:
        unrecord()
        unrecord_nms()
    checks["ms_deform_attn_fwd"] = {f"convnext_{k}": v for k, v in sot_rec.items()}
    for name, r in _check_msda_calls(calls, label="convnext").items():
        checks.setdefault(name, {}).update({f"convnext_{k}": v for k, v in r.items()})
        checks[name].update({f"convnext_sot_training_{k}": v
                             for k, v in sot_checks[name].items()})
    # the requests' NMS, as given and with the upper half of the scores valid
    kept = []
    for boxes, scores, classes, thr, valid in nms_calls:
        for v in (valid, (scores > scores.median()).contiguous()):
            got = nms.batched_nms(boxes, scores, classes, thr, valid=v)
            if not torch.equal(got, nms.batched_nms_plain(boxes, scores, classes, thr,
                                                          valid=v)):
                raise AssertionError("ConvNeXt request: NMS keep mask differs from the "
                                     "plain version")
            kept.append(int(got.sum()))
    if len(nms_calls) != 2 * N_REQUESTS:
        raise AssertionError(f"ConvNeXt requests: {len(nms_calls)} NMS calls recorded, "
                             f"not {2 * N_REQUESTS}")
    checks["nms"] = {"convnext_calls": len(nms_calls), "convnext_kept": kept}
    print(f"[convnext] NMS keep masks of the {len(nms_calls)} detection and instance-"
          f"segmentation requests identical to the plain version's (as given; with the upper "
          f"half of the scores valid), kept {kept}; MSDA at {len(calls)} recorded shapes held "
          f"to plain; phase {time.perf_counter() - t_phase:.1f} s")
    return launches, checks


def _profile(fn, label):
    """`fn` once more under torch.profiler: its host time, the device's
    busy time and idle share over the span of its kernels (union of kernel
    intervals), and the device time of its 25 largest kernels by name and
    of the port's kernels below them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    start0 = spans[0][0] if spans else 0
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (end - start0) / 1e3 if spans else 0.0
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start) / 1e3
    total = sum(by_name.values())
    print(f"[profile] {label}: host {host_ms:.1f} ms, device span {span:.1f} ms, "
          f"kernel time {total:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"(idle share {100 * (1 - busy / 1e3 / span) if span else 0:.1f}%)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in ranked[:25]:
        print(f"[profile] {ms:10.3f} ms  {name[:160]}")
    # the port's own kernels (csrc/) below the 25
    for name, ms in ranked[25:]:
        if any(f"::{k}" in name for k in PORT_KERNELS):
            print(f"[profile] {ms:10.3f} ms  {name[:160]} (the port's kernel)")


# the __global__ functions of csrc/, as the profiler names them
PORT_KERNELS = ("rel_pos_flash_attn_", "bwd_dkv_", "bwd_dq_", "ms_deform_attn_",
                "nms_fused_kernel", "msda_fold_kernel", "rowsum_", "gather_weighted_kernel",
                "dma_", "empty_kernel")
SOURCES = {
    "rel_pos_flash_attn": ("uninext_tpu_torch/csrc/rel_pos_flash_attn_mma.cu",
                           "uninext_tpu/models/vit.py:131"),
    "rel_pos_flash_attn_fp32": ("uninext_tpu_torch/csrc/rel_pos_flash_attn.cu",
                                "uninext_tpu/models/vit.py:131 (fp32 inputs)"),
    "rel_pos_flash_attn_tp": ("uninext_tpu_torch/csrc/rel_pos_flash_attn_mma.cu",
                              "uninext_tpu/models/vit.py:195 flash_rel_pos_attention_tp "
                              "(A': kernel A on each rank's heads)"),
    "rel_pos_flash_attn_bwd": (
        "uninext_tpu_torch/csrc/rel_pos_flash_attn_bwd_mma.cu",
        "uninext_tpu/models/vit.py:131 under jax.grad: jax/experimental/pallas/ops/"
        "tpu/flash_attention.py:941 _flash_attention_bwd_dkv, :1287 "
        "_flash_attention_bwd_dq"),
    "rel_pos_flash_attn_bwd_fp32": (
        "uninext_tpu_torch/csrc/rel_pos_flash_attn_bwd.cu",
        "uninext_tpu/models/vit.py:131 under jax.grad (fp32 inputs): flash_attention.py"
        ":941, :1287"),
    "ms_deform_attn_fwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:136"),
    "ms_deform_attn_bwd": ("uninext_tpu_torch/csrc/ms_deform_attn.cu",
                           "uninext_tpu/ops/msda.py:234"),
    "nms": ("uninext_tpu_torch/csrc/nms.cu", "uninext_tpu/ops/nms.py:25"),
    "msda_fold": ("uninext_tpu_torch/csrc/gather_fold.cu",
                  "tools/msda_v6_lab.py:87 _fold_pallas (_fold_kernel :68)"),
    "gather_rowsum_scalar": ("uninext_tpu_torch/csrc/gather_fold.cu",
                             "tools/pallas_gather_probe.py:57 probe_scalar_loop"),
    "gather_rowsum_vec": ("uninext_tpu_torch/csrc/gather_fold.cu",
                          "tools/pallas_gather_probe.py:88 probe_vector_gather"),
    "gather_weighted": ("uninext_tpu_torch/csrc/gather_fold.cu",
                        "tools/pallas_gather_probe.py:123 probe_onehot"),
    "dma_gather_rowsum": ("uninext_tpu_torch/csrc/dma_gather.cu",
                          "tools/pallas_dma_probe.py:101 probe_dma (dma_kernel :84)"),
    "dma_block_gather": ("uninext_tpu_torch/csrc/dma_gather.cu",
                         "tools/pallas_dma_probe.py:129 probe_index_map (imap_kernel :125)"),
}


def main():
    if not os.path.isdir(os.path.join(HERE, "uninext_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(uninext_tpu_torch/ not found beside this script)")
    sys.path.insert(0, HERE)
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    card = phase_device()
    rec = phase_kernels()
    rec.update(phase_backward_kernels())
    lab_rec, lab = phase_labs()
    rec.update(lab_rec)
    reference = phase_small_reference()
    from uninext_tpu_torch.config import image_joint_r50, image_joint_vit_huge
    vit_h, r50 = image_joint_vit_huge(), image_joint_r50()
    serving = phase_serving(vit_h, "image_joint_vit_huge", ("detection",), profile)
    training = phase_training(vit_h, "image_joint_vit_huge", TRAIN_STEPS, profile)
    r50_serving = phase_serving(r50, "image_joint_r50", ("detection", "instseg", "rec"),
                                profile)
    r50_training = phase_training(r50, "image_joint_r50", R50_TRAIN_STEPS, profile)
    r50_loop, loop_checks = phase_train_loop(profile)
    for name, r in loop_checks.items():
        rec[name].update(r)
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], r["loop_max_abs_err"])
    from uninext_tpu_torch.config import video_joint_r50
    video = video_joint_r50()
    video_serving, video_rec = phase_video_serving(video)
    video_training = phase_video_training(video, VIDEO_TRAIN_STEPS)
    video_loop, video_checks = phase_video_loop()
    rec["ms_deform_attn_fwd"].update(video_rec["msda"])
    rec["nms"].update(video_rec["nms"])
    for name, r in video_checks.items():
        rec[name].update({f"video_{k}": v for k, v in r.items()})
    sot_serving, sot_rec = phase_sot_serving(video)
    sot_training, sot_train_checks = phase_sot_training(video, SOT_TRAIN_STEPS)
    sot_vith, vith_rec = phase_sot_vith()
    sot_loop, sot_loop_checks = phase_sot_loop()
    rec["ms_deform_attn_fwd"].update(sot_rec)
    rec["rel_pos_flash_attn_tp"], parallel = phase_parallel(vit_h, r50)
    recipe, recipe_checks, recipe_nms = phase_recipe()
    rec["nms"].update(recipe_nms)
    for name, r in recipe_checks.items():
        rec[name].update({f"recipe_{k}": v for k, v in r.items()})
    convnext, convnext_checks = phase_convnext(profile)
    for name, r in convnext_checks.items():
        rec[name].update(r)
    a = rec["rel_pos_flash_attn"]
    a.update(vith_rec)
    a["max_abs_err"] = max([a["max_abs_err"]] + [v for k, v in vith_rec.items()
                                                  if k.endswith("max_abs_err")])
    for prefix, checks in (("sot_training", sot_train_checks), ("sot_loop", sot_loop_checks)):
        for name, r in checks.items():
            rec[name].update({f"{prefix}_{k}": v for k, v in r.items()})
    for r in (rec["ms_deform_attn_fwd"], rec["ms_deform_attn_bwd"]):
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            v for k, v in r.items() if k.endswith("max_abs_err") and k != "max_abs_err"])
    import torch
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        by_path = {"serving": serving["detection"][name], "training": training[name],
                   **{f"r50_{task}": n[name] for task, n in r50_serving.items()},
                   "r50_training": r50_training[name], "r50_train_loop": r50_loop[name],
                   "vis": video_serving["vis"][name], "mot": video_serving["mot"][name],
                   "video_training": video_training[name], "video_loop": video_loop[name],
                   **{path: n[name] for path, n in sot_serving.items()},
                   "sot_training": sot_training[name], "sot_vith": sot_vith[name],
                   "sot_loop": sot_loop[name],
                   **{path: n[name] for path, n in parallel.items()},
                   **{path: n[name] for path, n in recipe.items()},
                   **{path: n[name] for path, n in convnext.items()},
                   "lab": lab[name], "reference": reference[name]}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"kernel {name} was never launched by its path")
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "shape")},
                        "bound_share": r["bound_ms"] / r["ms"],
                        **{k: r[k] for k in ("max_rel_err", "kernel_ms", "window_ms",
                                             "window_kernel_ms", "window_plain_ms",
                                             "window_library_ms", "window_bound_ms",
                                             "graph_ms", "eager_ms", "model_ms", "model_graph_ms",
                                             "decoder_ms", "decoder_model_ms", "level0_graph_ms",
                                             "level3_graph_ms", "loop_max_abs_err",
                                             "loop_max_rel_err", "loop_shapes")
                           if k in r},
                        **{k: v for k, v in r.items()
                           if k.startswith(("vis_", "mot_", "video_", "sot_", "vos_",
                                            "rvos_", "recipe_", "convnext_", "k2_", "k4_",
                                            "launches_per_rank",
                                            "peak_gib_per_rank", "step_rel_err", "nccl_"))}})
        k = kernels[-1]
        if "kernel_ms" in k:
            k["kernel_bound_share"] = k["bound_ms"] / k["kernel_ms"]
        if "window_bound_ms" in k:
            k["window_bound_share"] = k["window_bound_ms"] / k["window_ms"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
