"""UNINEXT on PyTorch and CUDA: the port of `uninext_tpu` to one NVIDIA H100.

Module layout mirrors `uninext_tpu/` so each counterpart is easy to find.
This package imports `torch` and never `jax` or `flax`; it reuses only the
JAX-free host modules of `uninext_tpu` (`config`, `data.tokenizer`,
`data.prompts`, `data.coco_categories`).

The slice ported so far is the detection serving path with the ViT-H
backbone (`config.image_joint_vit_huge()`): ViT -> input projections ->
BERT prompt -> VLFuse -> 6 deformable encoder layers -> two-stage top-k ->
6 decoder layers -> heads -> `postprocess_detection`. Its three hand-written
Hopper kernels live in `csrc/` and are bound in `ops/`.
"""
