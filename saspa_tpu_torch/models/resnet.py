"""ResNet backbones of the baseline classifier (counterpart of
saspa_tpu/models/resnet.py).

Bottleneck v1, NCHW, with the flax tree's names.  `layer4_stride` defaults to
1 as in the reference's WSDAN_CAL: layer4 does not downsample, so the
backbone is overall stride 16 and a 224^2 input gives 14x14x2048 features.
`features_only` returns that map.  forward(x) runs BatchNorm with its
running statistics (eval), forward(x, train=True) with the batch's,
updating the running ones (`layers.BatchNorm`).  `param_dtype=torch.float32`
keeps f32 master weights for training.  `use_cbam` (resnet50_cbam,
resnet101_cbam) gates each block's bn3 output with CBAM (models/blocks.py)
before the residual add, as saspa_tpu/models/resnet.py:52-55; CBAM computes
in f32 in a bf16 net, so its blocks' outputs are f32, as in the JAX net.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.blocks import CBAMLayer
from saspa_tpu_torch.models.layers import BatchNorm, Conv, Dense


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, strides: int = 1, dtype=torch.float32, device=None,
                 param_dtype=None, use_cbam: bool = False):
        super().__init__()
        out = features * self.expansion
        conv = partial(Conv, dtype=dtype, device=device, bias=False, param_dtype=param_dtype)
        self.conv1 = conv(in_ch, features, 1)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv(features, features, 3, stride=strides, padding=1)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = conv(features, out, 1)
        self.bn3 = BatchNorm(out, device=device)
        # flax compares shapes: a projection where channels or size change
        if in_ch != out or strides != 1:
            self.downsample_conv = conv(in_ch, out, 1, stride=strides)
            self.downsample_bn = BatchNorm(out, device=device)
        if use_cbam:
            self.cbam = CBAMLayer(out, device=device)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.downsample_bn(self.downsample_conv(x), train) if hasattr(self, "downsample_conv") else x
        if hasattr(self, "cbam"):
            y = self.cbam(y)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, 2048, H/16, W/16) with features_only
    at layer4_stride=1, else (B, num_classes) logits."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: Optional[int] = None, features_only: bool = True,
                 layer4_stride: int = 1, dtype=torch.float32, device=None, param_dtype=None, use_cbam: bool = False):
        super().__init__()
        self.features_only = features_only
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, dtype=dtype, device=device, bias=False,
                          param_dtype=param_dtype)
        self.bn1 = BatchNorm(64, device=device)
        self.blocks = []
        in_ch = 64
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                if i == 3 and j == 0:
                    strides = layer4_stride
                name = f"layer{i + 1}_{j}"
                setattr(self, name, Bottleneck(in_ch, 64 * 2**i, strides, dtype, device, param_dtype, use_cbam))
                self.blocks.append(name)
                in_ch = 64 * 2**i * Bottleneck.expansion
        self.num_features = in_ch
        if not features_only:
            self.fc = Dense(in_ch, num_classes, dtype=dtype, device=device, param_dtype=param_dtype)

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as flax's ((1, 1), (1, 1))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        if self.features_only:
            return x
        return self.fc(x.mean(dim=(2, 3)))


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


NUM_FEATURES = {"resnet50": 2048, "resnet101": 2048}

BACKBONES: dict[str, Callable[..., ResNet]] = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet50_cbam": partial(resnet50, use_cbam=True),
    "resnet101_cbam": partial(resnet101, use_cbam=True),
}
