"""Data and tensor parallelism on `torch.distributed`, the counterpart of
`uninext_tpu/parallel/`: the (data, model) mesh of process groups
(`mesh`), the collectives GSPMD inserts in the JAX package (`comm`), and
the Megatron-style cut of the ViT and BERT towers (`sharding`)."""
from . import comm, mesh, sharding  # noqa: F401
