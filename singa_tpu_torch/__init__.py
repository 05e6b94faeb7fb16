"""singa_tpu_torch: the PyTorch/CUDA port of `singa_tpu`, for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `singa_tpu` stays the reference; this package imports
neither it nor `jax`. Plain tensor code is PyTorch; every Pallas kernel of
the JAX package on a ported path becomes a kernel written by hand for Hopper
under `ops/csrc/`, built from source on first use, with a plain PyTorch
version beside it that the CPU takes.

This slice serves `models.transformer.TransformerLM` through
`serve.ServingEngine`, with the flash-attention forward as a CUDA kernel.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
from . import (autograd, convert, device, export_cache, initializer, layer,
               model, serve, tensor)
from .models import transformer

__all__ = ["autograd", "convert", "device", "export_cache", "initializer",
           "layer", "model", "serve", "tensor", "transformer"]
