"""singa_tpu_torch: the PyTorch/CUDA port of `singa_tpu`, for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `singa_tpu` stays the reference; this package imports
neither it nor `jax`. Plain tensor code is PyTorch; every Pallas kernel of
the JAX package on a ported path becomes a kernel written by hand for Hopper
under `ops/csrc/`, built from source on first use, with a plain PyTorch
version beside it that the CPU takes.

The port serves `models.transformer.TransformerLM` through
`serve.ServingEngine` and trains it through `Model.__call__` ->
`train_one_batch` -> `opt`, with the flash-attention forward and backward
and the fused softmax cross-entropy as CUDA kernels. Entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""
from . import (autograd, convert, device, export_cache, initializer, layer,
               loss, metric, model, opt, serve, tensor)
from .models import transformer

__all__ = ["autograd", "convert", "device", "export_cache", "initializer",
           "layer", "loss", "metric", "model", "opt", "serve", "tensor",
           "transformer"]
