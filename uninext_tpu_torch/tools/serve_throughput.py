"""Batched-serving throughput of the detection config on one card, the port
of `tools/serve_throughput.py`.

The reference serves detection at bs=1 (its test loader hardwires
batch_size=1, detectron2 data/build.py:219-263), so its throughput is its
per-image latency. The port's serving path is batch-general (forward and
`postprocess_detection` are (B, ...) throughout, NMS is one launch for all
B images), so one card can trade latency for throughput. This tool serves
bs in `--sizes` through those entry points and writes a table.

    python -m uninext_tpu_torch.tools.serve_throughput [--sizes 1 2 4 8]
        [--hw 800 1216] [--config image_joint_r50|tiny] [--seed 0]
        [--requests 20] [--device cuda|cpu]
        [--out build/serve_throughput/THROUGHPUT.json]

`--config` is `image_joint_r50` at full width (default) or `tiny`
(`tiny_test_config`), random weights from `--seed` with N(0,
SAMPLING_NOISE) added to the MSDA offset and weight projections
(`perturb_sampling`; their init is zero). The 80-class COCO
prompt is encoded once at batch 1 and expanded to each batch size without a
copy. A step is `forward` + `postprocess_detection` of B random images at
`--hw`, timed on the host clock up to `torch.cuda.synchronize()`: after the
first step and WARMUP more, the median and range of `--requests` steps. Per batch
size the file holds the step's median, min and max ms, img/s, ms per
image, the first step's seconds (where the JAX tool has `compile_s`), the
peak device memory and the MSDA and NMS launches per step (the wrappers'
counters, which count kernel launches only: 0 on the CPU), with the card's
name and power limit. The JAX tool's `THROUGHPUT.json` in the repository
root is its TPU record and stays as it is.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..models.postprocess import postprocess_detection
from ..ops import msda, nms
from .cli_common import add_device_arg, device_of

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WARMUP = 1              # untimed steps after the first, before the timed ones
SAMPLING_NOISE = 0.01   # std of the noise on the random weights' MSDA sampling projections


def build_config(name: str):
    """`image_joint_r50()` or, for "tiny", `tiny_test_config()`."""
    from ..config import image_joint_r50, tiny_test_config
    return {"image_joint_r50": image_joint_r50, "tiny": tiny_test_config}[name]()


def coco_prompt(model, device: torch.device):
    """The 80-class COCO prompt encoded once: (lang_dict at batch 1, the
    class-token map (80, T) on `device`)."""
    from ..data.coco_categories import COCO_CATEGORIES
    from ..data.prompts import create_label_token_map
    from ..data.tokenizer import BertTokenizer
    ids, tmask, cmap = create_label_token_map(COCO_CATEGORIES, BertTokenizer(),
                                              model.cfg.language.max_len)
    with torch.inference_mode():
        lang = model.encode_text(torch.from_numpy(ids).long()[None].to(device),
                                 torch.from_numpy(tmask)[None].to(device))
    return lang, torch.from_numpy(cmap).to(device)


def expand_prompt(lang: Dict[str, torch.Tensor], B: int) -> Dict[str, torch.Tensor]:
    """A batch-1 lang_dict as a batch of B, without a copy."""
    return {k: v.expand(B, *v.shape[1:]) for k, v in lang.items()}


def random_images(B: int, H: int, W: int, seed: int, device: torch.device):
    """(images (B, H, W, 3), img_mask (B, H, W) all valid, sizes (B, 2))."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn(B, H, W, 3, device=device, generator=g)
    return (images, torch.zeros(B, H, W, dtype=torch.bool, device=device),
            torch.tensor([[H, W]] * B, dtype=torch.int32, device=device))


def perturb_sampling(model, std: float, seed: int = 0) -> None:
    """Add N(0, `std`) noise from `seed` to the weights of every MSDA
    module's offset and attention-weight projections. Their init is zero,
    which puts every query's samples at the same offsets from its
    reference point; a trained model spreads them."""
    from ..models.layers import MSDeformAttn
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                for lin in (mod.sampling_offsets, mod.attention_weights):
                    lin.weight.add_(torch.randn(lin.weight.shape, device=dev,
                                                generator=g) * std)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def request(model, inputs, lang, cmap) -> Dict:
    """One step of forward + `postprocess_detection` on `inputs` (images,
    img_mask, sizes) with the cached `lang`, on the host clock up to
    `torch.cuda.synchronize()`: its ms, its MSDA and NMS launches and the
    postprocess."""
    device = inputs[0].device
    m0, n0 = msda.ms_deform_attn.launches, nms.batched_nms.launches
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        out = model(*inputs, None, lang["masks"], lang_dict=lang)
        post = postprocess_detection(out, cmap)
        _sync(device)
    return {"ms": (time.perf_counter() - t0) * 1e3, "msda": msda.ms_deform_attn.launches - m0,
            "nms": nms.batched_nms.launches - n0, "post": post}


def summarize(first: Dict, timed: List[Dict]) -> Dict:
    """The first step's seconds, the timed steps' ms, their MSDA and NMS
    launches per step and the last step's postprocess."""
    n = max(len(timed), 1)
    return {"first_s": first["ms"] / 1e3, "ms": [r["ms"] for r in timed],
            "msda_per_request": sum(r["msda"] for r in timed) / n,
            "nms_per_request": sum(r["nms"] for r in timed) / n,
            "post": (timed[-1] if timed else first)["post"]}


def serve_steps(model, inputs, lang, cmap, requests: int) -> Dict:
    """The first step, WARMUP untimed steps and `requests` timed ones
    (`request`), summarized."""
    first = request(model, inputs, lang, cmap)
    for _ in range(WARMUP):
        request(model, inputs, lang, cmap)
    return summarize(first, [request(model, inputs, lang, cmap) for _ in range(requests)])


def run(model, sizes, hw, seed: int, requests: int) -> List[Dict]:
    """One row per batch size in `sizes`."""
    device = next(model.parameters()).device
    H, W = hw
    lang, cmap = coco_prompt(model, device)
    rows = []
    for B in sizes:
        inputs = random_images(B, H, W, seed + B, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        r = serve_steps(model, inputs, expand_prompt(lang, B), cmap, requests)
        med = float(np.median(r["ms"]))
        row = {"bs": B, "step_ms": med, "step_ms_min": min(r["ms"]),
               "step_ms_max": max(r["ms"]), "img_per_s": B * 1e3 / med,
               "ms_per_img": med / B, "first_call_s": r["first_s"],
               "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                            if device.type == "cuda" else None),
               "msda_launches_per_step": r["msda_per_request"],
               "nms_launches_per_step": r["nms_per_request"], "requests": len(r["ms"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--hw", nargs=2, type=int, default=[800, 1216])
    ap.add_argument("--config", default="image_joint_r50", choices=["image_joint_r50", "tiny"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "serve_throughput",
                                                  "THROUGHPUT.json"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from ..models.detr import build_model
    from .ap_check import card

    cfg = build_config(args.config)
    model = build_model(cfg, device, seed=args.seed)
    perturb_sampling(model, SAMPLING_NOISE, args.seed)
    rows = run(model, args.sizes, args.hw, args.seed, args.requests)
    out = {"config": args.config, "resolution": f"{args.hw[0]}x{args.hw[1]}",
           "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu"),
           "card": card(device), "seed": args.seed, "noise": SAMPLING_NOISE,
           "warmup": WARMUP,
           "timing": "host clock per step up to torch.cuda.synchronize(), after warm-up",
           "rows": rows,
           "throughput_gain_at_max_bs": rows[-1]["img_per_s"] / rows[0]["img_per_s"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[done] wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
