"""Kernels of the port: each module holds a hand-written Hopper kernel's
wrapper (source under `csrc/`) and its plain PyTorch version."""
