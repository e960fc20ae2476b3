"""UNINEXT's three-stage training recipe, chained end to end on the in-repo
fixtures: the protocol of `tools/pipeline3_check.py` on the port.

    python -m uninext_tpu_torch.tools.pipeline_check [--seeds 3]
        [--steps1 1200 --steps2 400 --steps3 600]
        [--out build/pipeline_check/tiny.json] [--device cuda]

  stage 1  BoxInst detection pretraining on a mini-COCO of other shapes
           (`make_mini_coco(seed=101)`, the obj365 stand-in): the mapper
           gives box bitmasks and the LAB colour similarity and no gt mask
           (`UniDatasetMapper(with_masks=False, boxinst=True)`), the mask
           head learns from the projection and pairwise terms alone, warm-up
           max(steps1 // 6, 20); its mask AP is scored against the
           fixture's true masks, which training never saw. The state is
           saved through `CheckpointManager`.
  stage 2  image joint: a routed mixture of detection (mini-COCO, masks)
           and grounding (mini-RefCOCO) at 0.6 / 0.4, the weights restored
           from stage 1's file (`restore_params`); det AP and REC P@0.5.
  stage 3  video joint: a routed mixture of VIS pairs and SOT pairs at
           0.65 / 0.35 (mini-YTVIS; a single-object one for SOT) on a
           `Trainer(video=True)` with the 4-channel template backbone and
           the fuser, started from stage 2's weights by
           `load_stage_weights` (the template backbone taken from the image
           backbone, its first convolution inflated 3 -> 4 channels); VIS
           mAP, SOT AUC and VOS J&F.

The configs are `tools/evidence.py:build_tiny_cfg`'s, at 224-352 for the
image stages and 192x256 (frame range 7, the reid head) for the video
stage, as in the JAX tool. Seed s seeds the three loaders (3s, 3s + 1,
3s + 2; seed 0 is the JAX tool's 0, 1, 2); the weights start from seed 0.

The JSON written to `--out` holds, per seed and stage, the steps taken of
each task, the seconds of training and evaluation, the step times, the
peak device memory, the hand-off's report and the metrics, with the
device's name and power limit; for stage 1 also `mask_logit_probe`: at
steps 1, 10, 25, 50 and 100, `loss_prj` and the mean mask logit of the
last decoder layer's valid instances, over all their pixels and inside
their boxes (`MaskLogitProbe`; ROADMAP §3.27). Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

from ..data.coco import UniDatasetMapper, load_coco_json, load_refcoco_json
from ..data.loader import MultiDatasetLoader
from ..data.mini_coco import make_mini_coco, make_mini_refcoco, make_mini_ytvis
from ..data.prompts import create_label_token_map
from ..data.tokenizer import BertTokenizer
from ..data.video import VideoPairMapper, load_ytvis_json
from ..engine.checkpoint import CheckpointManager, load_stage_weights
from ..engine.evaluator import DetectionEvaluator, evaluate_refcoco
from ..engine.hooks import HookBase
from ..engine.trainer import Trainer
from ..models import criterion
from .ap_check import LSJ, REPO, StepLog, card
from .evidence import build_tiny_cfg, finite, peak_gib, step_summary
from .sot_check import eval_sot_vos
from .vis_check import eval_vis


def counting(batches, counts: Counter):
    """The batches, each counted by its "__task__" (or "detection")."""
    for b in batches:
        counts[b.get("__task__", "detection")] += 1
        yield b


class Stage:
    """One stage's trainer over a loader: its task counts, step times,
    seconds and peak memory."""

    def __init__(self, cfg, loader, out_dir, device, **kw):
        self.batches = iter(loader)
        self.counts = Counter()
        self.timer = StepLog()
        self.device = device
        hooks = [self.timer] + kw.pop("extra_hooks", [])
        self.trainer = Trainer(cfg, counting(self.batches, self.counts), output_dir=out_dir,
                               has_masks=True, device=device, seed=0, log_period=100,
                               extra_hooks=hooks, **kw)

    def train(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        self.trainer.train()
        seconds = time.perf_counter() - t0
        self.batches.close()            # stops the loader's mapping threads
        # the loop reads one batch ahead, so the counts add to steps + 1 (as
        # the JAX tools' `steps_per_task`)
        return {"steps": self.trainer.state.step, "train_seconds": seconds,
                "batches_read_per_task": dict(self.counts),
                "step_ms": step_summary(self.timer.seconds),
                "final_total_loss": self.timer.total_loss[-1],
                "train_peak_gib": peak_gib(self.device)}


class MaskLogitProbe(HookBase):
    """At PROBE_STEPS (counted from 1), the step's `loss_prj` and the mean
    mask logit of the last decoder layer's valid instances, over all their
    pixels and inside their gt boxes, with the share of in-box pixels
    whose logit is positive. The logits are read by a pass-through in front
    of `models/criterion.py:loss_masks_boxinst` (the model calls it by that
    name, once per decoder layer, the last layer last), set while the probe
    is entered; the sums stay on the device until the step ends."""

    PROBE_STEPS = (1, 10, 25, 50, 100)

    def __init__(self):
        self.records, self.active, self.sums = [], False, None

    def __enter__(self):
        real = criterion.loss_masks_boxinst

        def recording(mask_logits, box_bitmasks, color_similarity, sel_valid, *a, **kw):
            if self.active:
                with torch.no_grad():
                    lg = mask_logits.detach().float()
                    valid = sel_valid[..., None, None].expand_as(lg).float()
                    inside = valid * (box_bitmasks > 0.5).float()
                    self.sums = torch.stack([(lg * valid).sum(), valid.sum(),
                                             (lg * inside).sum(), inside.sum(),
                                             ((lg > 0).float() * inside).sum()])
            return real(mask_logits, box_bitmasks, color_similarity, sel_valid, *a, **kw)

        criterion.loss_masks_boxinst = recording
        self._real = real
        return self

    def __exit__(self, *exc):
        criterion.loss_masks_boxinst = self._real

    def before_step(self, trainer):
        self.active = trainer.storage.iter + 1 in self.PROBE_STEPS
        self.sums = None

    def after_step(self, trainer, metrics):
        if not self.active or self.sums is None:
            return
        lg_sum, n, in_sum, n_in, pos = self.sums.tolist()
        self.records.append({"step": trainer.storage.iter + 1,
                             "loss_prj": float(metrics["loss_prj"]),
                             "mean_mask_logit": lg_sum / max(n, 1.0),
                             "mean_mask_logit_in_box": in_sum / max(n_in, 1.0),
                             "in_box_positive_share": pos / max(n_in, 1.0)})


def configs(steps1: int, steps2: int, steps3: int):
    """The three stages' configs, as the JAX tool builds them: BoxInst with
    a warm-up of max(steps1 // 6, 20) updates at 224-352; the image joint
    stage at 224-352; the video joint stage at 192x256 with frame range 7,
    the reid head, the 4-channel template backbone and the fuser."""
    cfg1 = build_tiny_cfg(steps1, 224, 352)
    cfg1 = dataclasses.replace(cfg1, loss=dataclasses.replace(
        cfg1.loss, boxinst=True, boxinst_warmup_iters=max(steps1 // 6, 20)))
    cfg3 = build_tiny_cfg(steps3, frame_range=7, use_reid=True)
    cfg3 = dataclasses.replace(cfg3, sot=dataclasses.replace(
        cfg3.sot, extra_backbone_for_template=True, feature_fusion=True))
    return cfg1, build_tiny_cfg(steps2, 224, 352), cfg3


def stage1(fx, cfg, seed, root, device):
    """BoxInst pretraining, saved; its segm AP against the true masks."""
    tok = BertTokenizer()
    mapper = UniDatasetMapper(cfg.data, fx["s1_cats"], tok, is_train=True, with_masks=False,
                              boxinst=True,
                              boxinst_bottom_pixels=cfg.loss.boxinst_bottom_pixels_removed,
                              **LSJ)
    out_dir = os.path.join(root, f"s1_seed{seed}")
    probe = MaskLogitProbe()
    st = Stage(cfg, MultiDatasetLoader([(fx["s1_train"], mapper, 2)], [1.0], seed=3 * seed,
                                       num_workers=2), out_dir, device, task="detection",
               extra_hooks=[probe])
    with probe:
        rec = st.train()
    rec["mask_logit_probe"] = probe.records
    for r in probe.records:
        print(f"[stage1] seed {seed} step {r['step']}: loss_prj {r['loss_prj']:.4f}, mean "
              f"mask logit {r['mean_mask_logit']:.4f} (in the boxes "
              f"{r['mean_mask_logit_in_box']:.4f}, positive there "
              f"{r['in_box_positive_share']:.4f})", flush=True)
    tr = st.trainer
    tr.ckpt.save(tr.state.step, tr.state)       # the hand-off's file
    eval_mapper = UniDatasetMapper(cfg.data, fx["s1_cats"], tok, is_train=False,
                                   with_masks=True)
    _, _, cmap = create_label_token_map(fx["s1_cats"], tok, cfg.data.max_text_len)
    t0 = time.perf_counter()
    segm = DetectionEvaluator(tr.model.eval(), cfg, cmap, with_masks=True).evaluate(
        fx["s1_val"], eval_mapper, score_thr=0.05)
    rec.update(eval_seconds=time.perf_counter() - t0, boxinst_warmup_iters=
               cfg.loss.boxinst_warmup_iters, mask_ap_vs_real_gt_masks=finite(segm)["AP"],
               segm=finite(segm), checkpoint=tr.ckpt.path(tr.state.step))
    return rec, os.path.join(out_dir, "checkpoints")


def stage2(fx, cfg, seed, root, ckpt_dir, device):
    """Image joint from stage 1's file; det AP and REC P@0.5. Returns the
    record and the weights."""
    tok = BertTokenizer()
    m_det = UniDatasetMapper(cfg.data, fx["d_cats"], tok, is_train=True, with_masks=True,
                             **LSJ)
    m_rec = UniDatasetMapper(cfg.data, ["object"], tok, is_train=True, with_masks=True,
                             **LSJ)
    loader = MultiDatasetLoader([(fx["d_train"], m_det, 2, "detection"),
                                 (fx["g_train"], m_rec, 2, "grounding")], [0.6, 0.4],
                                seed=3 * seed + 1, num_workers=2)
    st = Stage(cfg, loader, os.path.join(root, f"s2_seed{seed}"), device, task="detection")
    _, found = CheckpointManager(ckpt_dir).restore_params(st.trainer.model)
    if not found:
        raise RuntimeError(f"stage 1's checkpoint is not in {ckpt_dir}")
    rec = st.train()
    if not {"detection", "grounding"} <= set(st.counts):
        raise RuntimeError(f"stage 2 did not route both tasks: {dict(st.counts)}")
    model = st.trainer.model.eval()
    eval_det = UniDatasetMapper(cfg.data, fx["d_cats"], tok, is_train=False, with_masks=True)
    eval_rec = UniDatasetMapper(cfg.data, ["object"], tok, is_train=False, with_masks=False)
    _, _, cmap = create_label_token_map(fx["d_cats"], tok, cfg.data.max_text_len)
    t0 = time.perf_counter()
    det = finite(DetectionEvaluator(model, cfg, cmap, with_masks=False).evaluate(
        fx["d_val"], eval_det, score_thr=0.05))
    with torch.inference_mode():
        ref = finite(evaluate_refcoco(model, fx["g_val"], eval_rec))
    rec.update(eval_seconds=time.perf_counter() - t0, init="stage 1's checkpoint "
               "(restore_params)", det_ap=det["AP"], rec_p_at_50=ref["P@0.5"], bbox=det,
               rec=ref)
    return rec, {k: v.detach().clone() for k, v in model.state_dict().items()}


def stage3(fx, cfg, seed, root, weights, device):
    """Video joint through the hand-off; VIS mAP, SOT AUC, VOS J&F."""
    tok = BertTokenizer()
    m_vis = VideoPairMapper(cfg.data, fx["vis_cats"], tok, sampling_frame_range=5)
    m_sot = VideoPairMapper(cfg.data, fx["vis_cats"], tok, sampling_frame_range=7)
    loader = MultiDatasetLoader([(fx["vis_train"], m_vis, 2, "detection"),
                                 (fx["sot_train"], m_sot, 2, "sot")], [0.65, 0.35],
                                seed=3 * seed + 2, num_workers=2)
    st = Stage(cfg, loader, os.path.join(root, f"s3_seed{seed}"), device, task="detection",
               video=True)
    model = st.trainer.model
    sd, rep = load_stage_weights(model.state_dict(), weights)
    if rep["inflated"] < 1 or rep["remapped_template"] <= 0 or rep["mismatched"]:
        raise RuntimeError(f"stage 3's hand-off: {rep}")
    model.load_state_dict(sd)
    rec = st.train()
    if not {"detection", "sot"} <= set(st.counts):
        raise RuntimeError(f"stage 3 did not route both tasks: {dict(st.counts)}")
    t0 = time.perf_counter()
    vis, _ = eval_vis(model, cfg, fx["vis_val"], fx["vis_val_json"], fx["vis_cats"], device)
    sot, jf, _ = eval_sot_vos(model.eval(), cfg, fx["sot_val"], device)
    vis = finite(vis)
    rec.update(eval_seconds=time.perf_counter() - t0,
               init="stage 2's weights through load_stage_weights",
               handoff={"loaded": rep["loaded"], "inflated": rep["inflated"],
                        "remapped_template": rep["remapped_template"],
                        "new_tensors": len(rep["missing"]), "new": rep["missing"],
                        "mismatched": rep["mismatched"]},
               vis_map=vis["AP"], sot_auc=float(sot["AUC"]), vos_jf=jf, ytvis=vis,
               sot=finite(sot))
    return rec


def fixtures(root, n_train=None, n_val=None):
    """The stages' datasets, as the JAX tool writes them (each fixture's
    own numbers of train and val items, unless `n_train` or `n_val` say
    otherwise)."""
    n = {k: v for k, v in (("n_train", n_train), ("n_val", n_val)) if v is not None}
    s1 = make_mini_coco(os.path.join(root, "obj365"), seed=101, **n)
    s2d = make_mini_coco(os.path.join(root, "coco"), seed=0, **n)
    s2g = make_mini_refcoco(os.path.join(root, "refcoco"), **n)
    vis = make_mini_ytvis(os.path.join(root, "vis"), length=6, max_objects=2, **n)
    sot = make_mini_ytvis(os.path.join(root, "sot"), length=8, max_objects=1, seed=11, **n)
    fx = {}
    fx["s1_train"], fx["s1_cats"] = load_coco_json(s1["train_json"], s1["train_root"])
    fx["s1_val"], _ = load_coco_json(s1["val_json"], s1["val_root"])
    fx["d_train"], fx["d_cats"] = load_coco_json(s2d["train_json"], s2d["train_root"])
    fx["d_val"], _ = load_coco_json(s2d["val_json"], s2d["val_root"])
    fx["g_train"] = load_refcoco_json(s2g["train_json"], s2g["train_root"])
    fx["g_val"] = load_refcoco_json(s2g["val_json"], s2g["val_root"])
    fx["vis_train"], fx["vis_cats"] = load_ytvis_json(vis["train_json"], vis["train_root"])
    fx["vis_val"], _ = load_ytvis_json(vis["val_json"], vis["val_root"])
    fx["vis_val_json"] = vis["val_json"]
    fx["sot_train"], _ = load_ytvis_json(sot["train_json"], sot["train_root"])
    fx["sot_val"], _ = load_ytvis_json(sot["val_json"], sot["val_root"])
    return fx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps1", type=int, default=1200)
    ap.add_argument("--steps2", type=int, default=400)
    ap.add_argument("--steps3", type=int, default=600)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=None,
                    help="train items of every fixture (default: each fixture's own)")
    ap.add_argument("--n-val", type=int, default=None,
                    help="val items of every fixture (default: each fixture's own)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="default: build/pipeline_check/tiny.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pipeline_check: no CUDA device (pass --device cpu for the CPU)")
    out = Path(args.out or REPO / "build" / "pipeline_check" / "tiny.json")
    cfg1, cfg2, cfg3 = configs(args.steps1, args.steps2, args.steps3)
    per_seed = []
    with tempfile.TemporaryDirectory(prefix="pipeline_check_") as root:
        fx = fixtures(os.path.join(root, "data"), args.n_train, args.n_val)
        for seed in range(args.first_seed, args.first_seed + args.seeds):
            s1, ckpt_dir = stage1(fx, cfg1, seed, root, device)
            print(f"[stage1] seed {seed}: {args.steps1} BoxInst steps in "
                  f"{s1['train_seconds']:.1f} s; box-supervised mask AP "
                  f"{s1['mask_ap_vs_real_gt_masks']}", flush=True)
            s2, weights = stage2(fx, cfg2, seed, root, ckpt_dir, device)
            print(f"[stage2] seed {seed}: {args.steps2} routed steps "
                  f"{s2['batches_read_per_task']} in {s2['train_seconds']:.1f} s; det AP "
                  f"{s2['det_ap']}, REC P@0.5 {s2['rec_p_at_50']}", flush=True)
            s3 = stage3(fx, cfg3, seed, root, weights, device)
            h = s3["handoff"]
            print(f"[stage3] seed {seed}: hand-off loaded {h['loaded']} tensors, inflated "
                  f"{h['inflated']}, template-remapped {h['remapped_template']}, "
                  f"{h['new_tensors']} new; {args.steps3} routed steps "
                  f"{s3['batches_read_per_task']} in {s3['train_seconds']:.1f} s; VIS mAP "
                  f"{s3['vis_map']}, SOT AUC {s3['sot_auc']:.4f}, VOS J&F "
                  f"{s3['vos_jf']:.4f}", flush=True)
            per_seed.append({"seed": seed, "1_pretrain": s1, "2_image_joint": s2,
                             "3_video_joint": s3})
            del weights
    payload = {
        "config": "tiny_test_config (build_tiny_cfg) in every stage, trained from scratch",
        "device": card(device), "steps": [args.steps1, args.steps2, args.steps3],
        "pipeline": "BoxInst pretrain (mini-COCO seed 101, boxes only) -> CheckpointManager "
                    "-> restore_params -> image joint (detection + grounding routed) -> "
                    "load_stage_weights with the 3->4 channel template inflation -> video "
                    "joint (VIS + SOT routed) -> mask AP, det AP, REC P@0.5, VIS mAP, SOT "
                    "AUC, VOS J&F",
        "per_seed": per_seed}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload))
    print(f"[done] wrote {out}")
    return payload


if __name__ == "__main__":
    main()
