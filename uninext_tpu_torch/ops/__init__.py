"""Ops with a hand-written Hopper kernel beside a plain PyTorch version.

Each wrapper dispatches on the device of its inputs: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel (the wrapper raises if the
build or the launch fails), any other device raises. Each wrapper counts
its kernel launches in the integer attribute `launches`.
"""
