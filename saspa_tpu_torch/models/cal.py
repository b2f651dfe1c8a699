"""WS-DAN / CAL classifier, eval forward (counterpart of saspa_tpu/models/cal.py).

Behavioural spec: fgvc/models/cal.py:44-213.  The backbone's feature map
gives M attention maps (1x1 conv, BatchNorm with eps 1e-3, ReLU); bilinear
attention pooling (BAP) runs in f32 with sign-sqrt and F.normalize
semantics; `fc` runs at the model dtype on feature_matrix * 100, so on the
card the logits are bf16-valued, as on the TPU.  The counterfactual branch
pools with uniform attention (ones), as the reference's eval does.  The
train-time half (fake attention draws, attention-map sampling) and the
Inception backbones come with the train slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import BatchNorm, Conv, Dense
from saspa_tpu_torch.models.resnet import BACKBONES, NUM_FEATURES

EPSILON = 1e-6


def bap(features: torch.Tensor, attentions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear attention pooling (fgvc/models/cal.py:44-86), eval form.

    features (B, C, H, W), attentions (B, M, H, W), both f32 ->
    (feature_matrix (B, M*C), counterfactual_feature (B, M*C))."""
    b, c, h, w = features.shape
    m = attentions.shape[1]

    def pool(att):
        fm = torch.einsum("bmhw,bchw->bmc", att, features)
        fm = (fm / float(h * w)).reshape(b, m * c)
        fm = torch.sign(fm) * torch.sqrt(fm.abs() + EPSILON)
        return fm / fm.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    return pool(attentions), pool(torch.ones_like(attentions))


def cal_num_features(net: str) -> int:
    if "inception" in net:
        raise NotImplementedError(f"{net}: the Inception backbones come with the train slice (ROADMAP Queue 1 item 11)")
    return NUM_FEATURES.get(net.replace("_cbam", ""), 2048)


class WSDAN_CAL(nn.Module):
    """forward(x (B, 3, H, W)) -> (p, p - p_counterfactual, feature_matrix,
    attention_map (B, 1, h, w)), as the JAX module's eval call."""

    def __init__(self, num_classes: int, M: int = 32, net: str = "resnet101", dtype=torch.float32, device=None):
        super().__init__()
        self.num_classes, self.M, self.net = num_classes, M, net
        self.num_features = cal_num_features(net)
        if net not in BACKBONES:
            raise ValueError(f"Unsupported net: {net}")
        self.features = BACKBONES[net](dtype=dtype, features_only=True, device=device)
        self.attentions_conv = Conv(self.num_features, M, 1, dtype=dtype, device=device, bias=False)
        self.attentions_bn = BatchNorm(M, eps=1e-3, device=device)
        self.fc = Dense(M * self.num_features, num_classes, bias=False, dtype=dtype, device=device)

    def forward(self, x, train: bool = False):
        if train:
            raise NotImplementedError("WSDAN_CAL's training forward comes with the train slice "
                                      "(ROADMAP Queue 1 item 11)")
        feature_maps = self.features(x)  # (B, C, h, w)
        attention_maps = F.relu(self.attentions_bn(self.attentions_conv(feature_maps)))
        fm32, am32 = feature_maps.float(), attention_maps.float()
        feature_matrix, feature_matrix_hat = bap(fm32, am32)
        attention_map = am32.mean(dim=1, keepdim=True)
        p = self.fc(feature_matrix * 100.0)
        p_hat = self.fc(feature_matrix_hat * 100.0)
        return p, p - p_hat, feature_matrix, attention_map
