"""UNINEXT on PyTorch and CUDA: the port of `uninext_tpu` to one NVIDIA H100.

Module layout mirrors `uninext_tpu/` so each counterpart is easy to find.
This package imports `torch` and never `jax`, `flax` or `uninext_tpu`: it
keeps its own copies of the configuration (`config`) and of the host data
helpers (`data.tokenizer`, `data.prompts`, `data.coco_categories`).

Ported: the R50, ConvNeXt-L and ViT-H backbones, the BERT and RoBERTa
language towers, the image tasks' serving paths (detection, instance
masks, REC/RES) and training (`engine/train.py`, `engine/trainer.py`,
BoxInst, the stage hand-off), the video and annotation-prompt families
(VIS, MOT/MOTS, SOT, VOS, R-VOS) and the lab tools (`tools/`). Its
hand-written Hopper kernels live in `csrc/` and are bound in `ops/` and
`models/vit.py`. Data and tensor parallelism on `torch.distributed` live
in `parallel/`.
"""
