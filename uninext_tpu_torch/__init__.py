"""UNINEXT on PyTorch and CUDA: the port of `uninext_tpu` to one NVIDIA H100.

Module layout mirrors `uninext_tpu/` so each counterpart is easy to find.
This package imports `torch` and never `jax`, `flax` or `uninext_tpu`: it
keeps its own copies of the configuration (`config`) and of the host data
helpers (`data.tokenizer`, `data.prompts`, `data.coco_categories`).

Ported so far, with the ViT-H backbone (`config.image_joint_vit_huge()`):
the detection serving path (ViT -> input projections -> BERT prompt ->
VLFuse -> 6 deformable encoder layers -> two-stage top-k -> 6 decoder
layers -> heads -> `postprocess_detection`) and its training step (DN
queries, matching, losses, backward, clip, per-group AdamW;
`engine/train.py`). Its hand-written Hopper kernels live in `csrc/` and
are bound in `ops/` and `models/vit.py`.
"""
