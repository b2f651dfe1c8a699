"""CLIP RN50, the filter stage's zero-shot scorer (counterpart of
saspa_tpu/models/clip.py).

ModifiedResNet-50 (NCHW, flax names): a 3-conv stem with an average-pool
downsample, antialiased bottlenecks (the average pool comes before conv3 and
before the downsample conv), and an attention-pool head that prepends the
mean token, adds a positional embedding of (h*w + 1, C) and takes its query
from that token only.  Its attention is the plain path (the JAX module
passes use_pallas=False), with the scale folded as at every attention site
(`ops.attention.fold_scale`).  `CLIPModel` pairs it with the RN50 text tower;
`encode_image` / `encode_text` return features divided by (norm + 1e-8).
The ViT-B/16 image tower has one caller, the train stage's soft-CE teacher,
and comes with it (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import BatchNorm, Conv, Dense
from saspa_tpu_torch.models.text_encoder import CLIP_RN50_TEXT, CLIPTextConfig, CLIPTextEncoder
from saspa_tpu_torch.ops.attention import fold_scale, plain_attention

# OpenAI CLIP preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionRNConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)  # RN50
    width: int = 64
    output_dim: int = 1024
    heads: int = 32  # attnpool heads = width * 32 // 64
    image_size: int = 224  # sizes the attention pool's positional embedding


class _RNBottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device, bias=False)
        self.stride = stride
        self.conv1 = conv(in_ch, features, 1)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv(features, features, 3, padding=1)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = conv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4, device=device)
        if in_ch != features * 4 or stride > 1:
            self.downsample_conv = conv(in_ch, features * 4, 1)
            self.downsample_bn = BatchNorm(features * 4, device=device)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:  # antialiased: avgpool, then conv
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        if hasattr(self, "downsample_conv"):
            sc = F.avg_pool2d(x, self.stride) if self.stride > 1 else x
            x = self.downsample_bn(self.downsample_conv(sc))
        return F.relu(x + out)


class AttentionPool2d(nn.Module):
    def __init__(self, tokens: int, channels: int, output_dim: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(tokens, channels, device=device), requires_grad=False)
        dense = partial(Dense, channels, dtype=dtype, device=device)
        self.q_proj, self.k_proj, self.v_proj = dense(channels), dense(channels), dense(channels)
        self.c_proj = dense(output_dim)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        q, k, v = self.q_proj(tokens[:, :1]), self.k_proj(tokens), self.v_proj(tokens)
        d = c // self.heads
        qh, kh, vh = (t.reshape(b, t.shape[1], self.heads, d) for t in (q, k, v))
        out = plain_attention(fold_scale(qh, 1.0 / math.sqrt(d)), kh, vh, 1.0).to(q.dtype).reshape(b, 1, c)
        return self.c_proj(out[:, 0])


class CLIPVisionRN(nn.Module):
    """forward(x (B, 3, S, S)) -> (B, output_dim), S = cfg.image_size."""

    def __init__(self, cfg: CLIPVisionRNConfig = CLIPVisionRNConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        w = cfg.width
        conv = partial(Conv, dtype=dtype, device=device, bias=False)
        self.conv1 = conv(3, w // 2, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(w // 2, device=device)
        self.conv2 = conv(w // 2, w // 2, 3, padding=1)
        self.bn2 = BatchNorm(w // 2, device=device)
        self.conv3 = conv(w // 2, w, 3, padding=1)
        self.bn3 = BatchNorm(w, device=device)
        self.blocks = []
        in_ch = w
        for i, count in enumerate(cfg.layers):
            for j in range(count):
                name = f"layer{i + 1}_{j}"
                setattr(self, name, _RNBottleneck(in_ch, w * 2**i, 2 if j == 0 and i > 0 else 1, dtype, device))
                self.blocks.append(name)
                in_ch = w * 2**i * 4
        side = cfg.image_size // 32
        self.attnpool = AttentionPool2d(side * side + 1, in_ch, cfg.output_dim, w * 32 // 64, dtype, device)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.attnpool(x)


def _unit(feats):
    return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-8)


class CLIPModel(nn.Module):
    """Image and text towers of CLIP RN50 and the logit scale."""

    def __init__(self, vision_kind: str = "rn50", vision_cfg: CLIPVisionRNConfig = CLIPVisionRNConfig(),
                 text_cfg: CLIPTextConfig = CLIP_RN50_TEXT, dtype=torch.float32, device=None):
        super().__init__()
        if vision_kind != "rn50":
            raise NotImplementedError(f"CLIP {vision_kind}: the ViT image tower comes with the train slice, "
                                      "its only caller (ROADMAP Queue 1 item 11)")
        self.visual = CLIPVisionRN(vision_cfg, dtype, device)
        self.text = CLIPTextEncoder(text_cfg, dtype, device)
        self.logit_scale = nn.Parameter(torch.zeros((), device=device), requires_grad=False)

    def encode_image(self, images):
        """images (B, 3, S, S), CLIP-normalised -> unit features (B, output_dim)."""
        return _unit(self.visual(images))

    def encode_text(self, token_ids):
        """token_ids (B, 77) -> unit features (B, projection_dim)."""
        return _unit(self.text(token_ids)["proj"])

    def forward(self, images, token_ids):
        """Zero-shot logits (B_img, B_txt), scaled."""
        return torch.exp(self.logit_scale) * self.encode_image(images) @ self.encode_text(token_ids).T
