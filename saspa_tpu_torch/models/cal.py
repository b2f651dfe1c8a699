"""WS-DAN / CAL classifier (counterpart of saspa_tpu/models/cal.py).

Behavioural spec: fgvc/models/cal.py:44-213.  The backbone's feature map
gives M attention maps (1x1 conv, BatchNorm with eps 1e-3, ReLU); bilinear
attention pooling (BAP) runs in f32 with sign-sqrt and F.normalize
semantics; `fc` runs at the model dtype on feature_matrix * 100, so on the
card the logits are bf16-valued, as on the TPU.  Eval pools the
counterfactual branch with uniform attention (ones) and returns the mean
attention map; the training forward pools it with a uniform [0, 2) fake
attention and samples two attention maps a sample with probability
proportional to sqrt(energy).  Its randomness comes from a numpy threefry
key split as the JAX module splits its `rngs_key`, so the fake maps and the
picks are jax's (utils/rng.py); `fake_att` and `pick_idx` inject them.
The backbone is a ResNet (models/resnet.py, with or without CBAM) or
Inception-v3 truncated at mixed_6e (768 channels) or mixed_7c (2048;
models/inception.py).  inception_mixed_7c owns no attention head: its
attention maps are the first M feature channels, in f32
(fgvc/models/cal.py:174-177), and the JAX module's head, defined in setup
but never called, holds no parameters there either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch import to_device
from saspa_tpu_torch.models.inception import NUM_FEATURES_INCEPTION, InceptionV3Features
from saspa_tpu_torch.models.layers import BatchNorm, Conv, Dense, acc_dtype
from saspa_tpu_torch.models.resnet import BACKBONES, NUM_FEATURES
from saspa_tpu_torch.utils import rng as rngs

EPSILON = 1e-6


def bap(features: torch.Tensor, attentions: torch.Tensor,
        fake_att: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear attention pooling (fgvc/models/cal.py:44-86).

    features (B, C, H, W), attentions (B, M, H, W), both f32 ->
    (feature_matrix (B, M*C), counterfactual_feature (B, M*C)); the
    counterfactual pools `fake_att` (B, M, H, W), or ones (eval)."""
    b, c, h, w = features.shape
    m = attentions.shape[1]

    def pool(att):
        fm = torch.einsum("bmhw,bchw->bmc", att, features)
        fm = (fm / float(h * w)).reshape(b, m * c)
        fm = torch.sign(fm) * torch.sqrt(fm.abs() + EPSILON)
        return fm / fm.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    return pool(attentions), pool(torch.ones_like(attentions) if fake_att is None else fake_att)


def fake_attention(key, shape_nchw, device="cpu", rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """jax.random.uniform(key, (B, H, W, M), float32, 0, 2) as (B, M, H, W)
    on `device` (the JAX module draws it in its NHWC layout); with `rows`,
    B is rows of a batch of rows.total, drawn for the whole."""
    b, m, h, w = shape_nchw
    u = rngs.uniform_f32(key, (rngs.draw_size(rows, b), h, w, m), 0.0, 2.0)
    return to_device(rngs.take_rows(u, rows), device).permute(0, 3, 1, 2)


def sample_attention_maps(attentions: torch.Tensor, key=None, pick_idx: Optional[torch.Tensor] = None,
                          return_picks: bool = False, rows: Optional[rngs.Rows] = None):
    """Training-time map selection (fgvc/models/cal.py:201-209): two maps a
    sample, with replacement, with probability proportional to sqrt(total
    energy): jax.random.categorical(split(key, B)[i], logits, shape=(2,)).
    The Gumbel noise comes from the host, the logits and the argmax stay on
    the maps' device.  `pick_idx` (B, 2) overrides the draw; `rows` as
    fake_attention's.

    attentions (B, M, H, W) -> (B, 2, H, W) [first for crop, second for drop]."""
    b, m = attentions.shape[:2]
    if pick_idx is None:
        energy = torch.sqrt(attentions.sum(dim=(2, 3)) + EPSILON)  # (B, M)
        logits = torch.log(energy / energy.sum(dim=-1, keepdim=True))
        keys = rngs.take_rows(rngs.split(key, rngs.draw_size(rows, b)), rows)
        noise = np.stack([rngs.categorical_gumbel(k, m, (2,)) for k in keys])  # (B, 2, M)
        pick_idx = (to_device(noise, logits.device) + logits[:, None, :]).argmax(dim=-1)
    pick_idx = pick_idx.to(device=attentions.device, dtype=torch.long)
    picked = torch.take_along_dim(attentions, pick_idx[:, :, None, None], dim=1)
    return (picked, pick_idx) if return_picks else picked


def cal_num_features(net: str) -> int:
    """The backbone's feature width, which also sizes the feature centers."""
    if "inception" in net:
        if net not in NUM_FEATURES_INCEPTION:
            raise ValueError(f"Unsupported net: {net}")
        return NUM_FEATURES_INCEPTION[net]
    return NUM_FEATURES.get(net.replace("_cbam", ""), 2048)


class WSDAN_CAL(nn.Module):
    """forward(x (B, 3, H, W)) -> (p, p - p_counterfactual, feature_matrix,
    attention_map), as the JAX module's call: attention_map is (B, 1, h, w)
    at eval and (B, 2, h, w) with train=True.  `param_dtype=torch.float32`
    keeps f32 master weights of the convolutions and fc for training."""

    def __init__(self, num_classes: int, M: int = 32, net: str = "resnet101", dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        self.num_classes, self.M, self.net = num_classes, M, net
        self.num_features = cal_num_features(net)
        if "inception" in net:
            self.features = InceptionV3Features(net[len("inception_"):], dtype=dtype, device=device,
                                                param_dtype=param_dtype)
        elif net in BACKBONES:
            self.features = BACKBONES[net](dtype=dtype, features_only=True, device=device, param_dtype=param_dtype)
        else:
            raise ValueError(f"Unsupported net: {net}")
        if net != "inception_mixed_7c":
            self.attentions_conv = Conv(self.num_features, M, 1, dtype=dtype, device=device, bias=False,
                                        param_dtype=param_dtype)
            self.attentions_bn = BatchNorm(M, eps=1e-3, device=device)
        self.fc = Dense(M * self.num_features, num_classes, bias=False, dtype=dtype, device=device,
                        param_dtype=param_dtype)

    def forward(self, x, train: bool = False, rngs_key=None, fake_att: Optional[torch.Tensor] = None,
                pick_idx: Optional[torch.Tensor] = None, rows: Optional[rngs.Rows] = None):
        """train=True needs `rngs_key` (a numpy threefry key) unless both
        `fake_att` (B, M, h, w) and `pick_idx` (B, 2) are given.  `rows`: x
        holds those rows of a larger batch, and the draws are that batch's."""
        feature_maps = self.features(x, train)  # (B, C, h, w)
        if self.net == "inception_mixed_7c":
            attention_maps = feature_maps[:, :self.M].float()
        else:
            attention_maps = F.relu(self.attentions_bn(self.attentions_conv(feature_maps), train))
        fm32 = acc_dtype(feature_maps)  # BAP in f32 (f64 stays f64)
        am32 = attention_maps.to(fm32.dtype)
        if train:
            if fake_att is None or pick_idx is None:
                if rngs_key is None:
                    raise ValueError("the training forward needs an rng key, or fake_att and pick_idx")
                k_fake, k_pick = rngs.split(rngs_key, 2)
            if fake_att is None:
                fake_att = fake_attention(k_fake, am32.shape, am32.device, rows)
            feature_matrix, feature_matrix_hat = bap(fm32, am32, fake_att.to(am32.device, am32.dtype))
            attention_map = sample_attention_maps(am32.detach(), None if pick_idx is not None else k_pick, pick_idx,
                                                  rows=rows)
        else:
            feature_matrix, feature_matrix_hat = bap(fm32, am32)
            attention_map = am32.mean(dim=1, keepdim=True)
        p = self.fc(feature_matrix * 100.0)
        p_hat = self.fc(feature_matrix_hat * 100.0)
        return p, p - p_hat, feature_matrix, attention_map
