"""Evaluation metrics. Counterpart of `singa_tpu.metric`: `Metric` with
`forward`/`evaluate`, `Accuracy(top_k)`, `Precision` and `Recall`.
Registering a metric into a trace logger (`Metric.register`) arrives with
the port's trace slice."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x) -> np.ndarray:
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class Metric:
    def forward(self, x, y) -> torch.Tensor:
        """Per-sample metric values."""
        raise NotImplementedError

    def evaluate(self, x, y) -> float:
        """Batch-averaged metric as a host float."""
        return float(torch.mean(self.forward(x, y).float()))

    def __call__(self, x, y) -> float:
        return self.evaluate(x, y)


class Accuracy(Metric):
    """Fraction of samples whose label is within the top-k predictions;
    one-hot labels are turned into indices first."""

    def __init__(self, top_k: int = 1):
        self.top_k = int(top_k)

    def forward(self, x, y) -> torch.Tensor:
        logits = _tensor(x)
        labels = _tensor(y).to(logits.device)
        if labels.dim() == logits.dim():  # one-hot -> index
            labels = torch.argmax(labels, dim=-1)
        if self.top_k == 1:
            return (torch.argmax(logits, dim=-1) == labels).float()
        topk = torch.topk(logits, self.top_k, dim=-1).indices
        return (topk == labels[..., None]).any(dim=-1).float()


class Precision(Metric):
    """Binary precision: predictions are x > threshold, truths y > 0.5."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def evaluate(self, x, y) -> float:
        pred = _host(x) > self.threshold
        true = _host(y) > 0.5
        tp = np.logical_and(pred, true).sum()
        return float(tp / np.maximum(pred.sum(), 1))


class Recall(Metric):
    """Binary recall: predictions are x > threshold, truths y > 0.5."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def evaluate(self, x, y) -> float:
        pred = _host(x) > self.threshold
        true = _host(y) > 0.5
        tp = np.logical_and(pred, true).sum()
        return float(tp / np.maximum(true.sum(), 1))
