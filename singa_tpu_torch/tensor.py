"""Precision and compute-dtype switches. Counterpart of
`singa_tpu.tensor.set_matmul_precision` / `set_compute_dtype` / `amp_cast`.

The JAX package pins float32 matmuls to `precision="highest"` by default;
the port does the same on the card by turning TF32 off for cuBLAS and cuDNN
when this module is imported. 'high' allows TF32, 'default' allows bf16
passes inside float32 products, mirroring the JAX names.
"""
from __future__ import annotations

from typing import Optional

import torch

_PRECISIONS = {"highest": "highest", "high": "high", "default": "medium"}
_matmul_precision = "highest"
_compute_dtype: Optional[torch.dtype] = None


def set_matmul_precision(p: str) -> None:
    """'highest' (fp32, default) | 'high' (TF32) | 'default' (bf16)."""
    global _matmul_precision
    if p not in _PRECISIONS:
        raise ValueError(f"matmul precision must be one of "
                         f"{sorted(_PRECISIONS)}, got {p!r}")
    _matmul_precision = p
    torch.set_float32_matmul_precision(_PRECISIONS[p])
    torch.backends.cuda.matmul.allow_tf32 = p != "highest"
    torch.backends.cudnn.allow_tf32 = p != "highest"


def get_matmul_precision() -> str:
    return _matmul_precision


def set_compute_dtype(dt) -> None:
    """bf16 AMP: matmul operands cast to `dt` at the op boundary; None
    turns the policy off (full float32 math)."""
    global _compute_dtype
    if isinstance(dt, str):
        dt = getattr(torch, dt)
    _compute_dtype = dt


def get_compute_dtype() -> Optional[torch.dtype]:
    return _compute_dtype


def amp_cast(*tensors):
    """Cast float32 tensors to the compute dtype when the policy is on."""
    if _compute_dtype is None:
        return tensors if len(tensors) != 1 else tensors[0]
    out = tuple(t.to(_compute_dtype)
                if t is not None and t.dtype == torch.float32 else t
                for t in tensors)
    return out if len(out) != 1 else out[0]


set_matmul_precision(_matmul_precision)
