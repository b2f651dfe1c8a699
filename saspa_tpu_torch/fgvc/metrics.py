"""Metrics (counterpart of saspa_tpu/fgvc/metrics.py): per-batch counts on
the device, accumulated in small host-side meters, so no logits leave the
card."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, ks: Sequence[int] = (1, 5)) -> torch.Tensor:
    """Per-k correct counts for one batch -> (len(ks),) int32.  Ties rank
    the lower class first, as lax.top_k does."""
    k_eff = min(max(ks), logits.shape[-1])
    # a stable descending sort: among equal logits the lower index first
    pred = torch.sort(logits.float(), dim=-1, descending=True, stable=True).indices[:, :k_eff]
    cum = torch.cumsum((pred == labels.long()[:, None]).int(), dim=-1)  # the label appears at most once
    return torch.stack([(cum[:, min(k, k_eff) - 1] > 0).sum() for k in ks]).int()


def per_class_stats(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrects, counts) per class for mean-class accuracy (fgvc/util.py:75-108)."""
    labels = labels.long()
    correct = (logits.argmax(dim=-1) == labels).int()
    corrects = torch.zeros(num_classes, dtype=torch.int32, device=logits.device).index_add_(0, labels, correct)
    counts = torch.zeros(num_classes, dtype=torch.int32, device=logits.device).index_add_(
        0, labels, torch.ones_like(correct))
    return corrects, counts


class AverageMeter:
    def __init__(self, name: str = "loss"):
        self.name = name
        self.reset()

    def reset(self):
        self.scores = 0.0
        self.total = 0.0

    def update(self, batch_score: float, n: int = 1) -> float:
        self.scores += float(batch_score)
        self.total += n
        return self.scores / max(self.total, 1)

    @property
    def value(self) -> float:
        return self.scores / max(self.total, 1)


class TopKAccuracy:
    name = "topk_accuracy"

    def __init__(self, ks: Sequence[int] = (1, 5)):
        self.ks = tuple(ks)
        self.reset()

    def reset(self):
        self.corrects = np.zeros(len(self.ks), np.int64)
        self.num_samples = 0

    def update(self, correct_counts, batch_size: int) -> np.ndarray:
        self.corrects += np.asarray(correct_counts, np.int64)
        self.num_samples += batch_size
        return self.value

    @property
    def value(self) -> np.ndarray:
        return self.corrects * 100.0 / max(self.num_samples, 1)


class MeanClassAccuracy:
    name = "mean_class_accuracy"

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.corrects = np.zeros(self.num_classes, np.int64)
        self.counts = np.zeros(self.num_classes, np.int64)

    def update(self, corrects, counts) -> float:
        self.corrects += np.asarray(corrects, np.int64)
        self.counts += np.asarray(counts, np.int64)
        return self.value

    @property
    def value(self) -> float:
        acc = self.corrects / np.maximum(self.counts, 1)
        return float(np.nan_to_num(acc).mean() * 100.0)

    def accuracy_per_class(self) -> np.ndarray:
        """Per-class accuracy in [0, 1], 0 for unseen classes (fgvc/util.py:102-105)."""
        return np.nan_to_num(self.corrects / np.maximum(self.counts, 1))

    def total_accuracy(self) -> float:
        return float(self.corrects.sum() / max(self.counts.sum(), 1))
