"""Losses (counterpart of saspa_tpu/fgvc/losses.py): cross-entropy, center
loss, soft-label CE and the CLIP-distillation soft-target CE.

Specs: CenterLoss = sum((f - c)^2) / B (fgvc/util.py:15-21);
SoftTargetCrossEntropy_T with teacher temperature T = 2
(fgvc/losses.py:66-88).  Low-precision logits are upcast to f32, never
downcast.  The composite WS-DAN loss lives in fgvc/train.py::train_step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; labels are int class ids."""
    logp = F.log_softmax(_acc(logits), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def cross_entropy_soft(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Mean CE against a soft label distribution (CutMix's labels)."""
    logp = F.log_softmax(_acc(logits), dim=-1)
    return (-(target_probs * logp).sum(dim=-1)).mean()


def center_loss(features: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """MSE-sum to per-class feature centers / batch."""
    diff = _acc(features) - _acc(centers)
    return (diff * diff).sum() / features.shape[0]


def soft_target_cross_entropy_T(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                                T: float = 2.0) -> torch.Tensor:
    soft = F.softmax(_acc(teacher_logits) / T, dim=-1)
    logp = F.log_softmax(_acc(student_logits), dim=-1)
    return (-soft * logp).sum(dim=-1).mean()
