"""CLIP image towers (counterpart of saspa_tpu/models/clip.py): RN50, the
filter stage's zero-shot scorer, and the ViT, BLIP-Diffusion's vision tower.

ModifiedResNet-50 (NCHW, flax names): a 3-conv stem with an average-pool
downsample, antialiased bottlenecks (the average pool comes before conv3 and
before the downsample conv), and an attention-pool head that prepends the
mean token, adds a positional embedding of (h*w + 1, C) and takes its query
from that token only.  `CLIPVisionViT`: a conv patch embed without bias, the
class token, a positional embedding and ln_pre, pre-LN blocks with separate
q/k/v projections and a QuickGELU MLP, ln_post; its LayerNorms are flax's
(f32, fast variance, eps 1e-5).  Both towers' attention is the plain path
(the JAX modules pass use_pallas=False), the scale folded into q in q's
dtype.  `clip_preprocess` is the JAX package's, as its fused BLIP program
runs it.  `CLIPModel` pairs RN50 with its text tower (projection 1024), or
with vision_kind="vit-b-16" the ViT-B/16 (patch 16, width 768, 12 layers,
projection 512) with the 512-wide text tower of projection 512;
`encode_image` / `encode_text` return features divided by (norm + 1e-8).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch import to_device
from saspa_tpu_torch.models.layers import BatchNorm, Conv, Dense, NormParams, flax_layer_norm
from saspa_tpu_torch.models.text_encoder import CLIP_RN50_TEXT, CLIP_VITB16_TEXT, CLIPTextConfig, CLIPTextEncoder
from saspa_tpu_torch.ops.attention import attention
from saspa_tpu_torch.ops.image import jax_resize_weights

# OpenAI CLIP preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def jax_cubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """jax.image.resize(x, (B, out_h, out_w, C), "cubic") on NHWC float:
    one Keys-cubic weight matrix a spatial dimension (antialiased when it
    downscales), rows then columns; a dimension whose size stays is left
    alone, as jax skips it, so a same-size resize returns x itself."""
    f = np.float64 if x.dtype == torch.float64 else np.float32
    if x.shape[1] != out_h:
        wy = to_device(jax_resize_weights(x.shape[1], out_h, "cubic", f).copy(), x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wy)
    if x.shape[2] != out_w:
        wx = to_device(jax_resize_weights(x.shape[2], out_w, "cubic", f).copy(), x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, wx)
    return x


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> resized (shorter side to `size`,
    cubic), centre-cropped to size x size, CLIP-normalised; NHWC.  The
    normalisation multiplies by 1 / std in f32, as XLA compiles the JAX
    package's division by the constant std inside its fused program."""
    b, h, w, c = images.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = jax_cubic_resize(images, nh, nw)
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    x = x[:, y0:y0 + size, x0:x0 + size, :]
    mean = to_device(np.asarray(CLIP_MEAN, np.float32), x.device)
    inv_std = to_device(np.float32(1.0) / np.asarray(CLIP_STD, np.float32), x.device)
    return (x - mean) * inv_std


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
        if tokens.shape[1] != self.positional_embedding.shape[0]:  # flax's param shape check raises here too
            raise ValueError(f"the attention pool's positional embedding holds {self.positional_embedding.shape[0]} "
                             f"tokens; a {h}x{w} feature map gives {tokens.shape[1]} (the tower's image size only)")
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        q, k, v = self.q_proj(tokens[:, :1]), self.k_proj(tokens), self.v_proj(tokens)
        return self.c_proj(attention(q, k, v, self.heads, use_kernels=False)[:, 0])


class CLIPVisionRN(nn.Module):
    """forward(x (B, 3, S, S)) -> (B, output_dim), S = cfg.image_size."""

    def __init__(self, cfg: CLIPVisionRNConfig = CLIPVisionRNConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
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


@dataclass(frozen=True)
class CLIPVisionViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: Optional[int] = 512


class CLIPVisionViT(nn.Module):
    """forward(x (B, 3, S, S) CLIP-normalised, return_tokens=False) ->
    (B, output_dim) pooled and projected class token, or with
    return_tokens=True the (B, 1 + (S/patch)^2, width) tokens after ln_post
    (the Q-Former's cross-attention input); S = cfg.image_size."""

    def __init__(self, cfg: CLIPVisionViTConfig = CLIPVisionViTConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        w = cfg.width
        dense = partial(Dense, dtype=dtype, device=device)
        self.patch_embed = Conv(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False, dtype=dtype, device=device)
        tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(w, dtype=dtype, device=device), requires_grad=False)
        self.positional_embedding = nn.Parameter(torch.zeros(tokens, w, dtype=dtype, device=device),
                                                 requires_grad=False)
        self.ln_pre = NormParams(w, device)
        for i in range(cfg.layers):
            for name, mod in (("ln1", NormParams(w, device)), ("q", dense(w, w)), ("k", dense(w, w)),
                              ("v", dense(w, w)), ("attn_out", dense(w, w)), ("ln2", NormParams(w, device)),
                              ("mlp_fc", dense(w, 4 * w)), ("mlp_proj", dense(4 * w, w))):
                setattr(self, f"blk_{i}_{name}", mod)
        self.ln_post = NormParams(w, device)
        if cfg.output_dim is not None:
            self.proj = dense(w, cfg.output_dim, bias=False)

    def _ln(self, name, x):
        p = getattr(self, name)
        return flax_layer_norm(x, p.scale, p.bias).to(x.dtype)

    def forward(self, x, return_tokens: bool = False):
        cfg = self.cfg
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, N, width), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None].to(x.dtype)
        x = self._ln("ln_pre", x)
        for i in range(cfg.layers):
            q, k, v, out, fc, proj = (getattr(self, f"blk_{i}_{n}")
                                      for n in ("q", "k", "v", "attn_out", "mlp_fc", "mlp_proj"))
            h = self._ln(f"blk_{i}_ln1", x)
            x = x + out(attention(q(h), k(h), v(h), cfg.heads, use_kernels=False))
            h = fc(self._ln(f"blk_{i}_ln2", x))
            x = x + proj(h * torch.sigmoid(1.702 * h))  # QuickGELU
        x = self._ln("ln_post", x)
        if return_tokens:
            return x
        return self.proj(x[:, 0]) if cfg.output_dim is not None else x[:, 0]


def _unit(feats):
    return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-8)


class CLIPModel(nn.Module):
    """Image and text towers of CLIP RN50 or ViT-B/16 and the logit scale.
    vision_cfg: the tower's config (None: the kind's published one); with
    "vit-b-16", the default text_cfg (RN50's) becomes CLIP_VITB16_TEXT, as
    in the JAX module."""

    def __init__(self, vision_kind: str = "rn50", vision_cfg=None, text_cfg: CLIPTextConfig = CLIP_RN50_TEXT,
                 dtype=torch.float32, device=None):
        super().__init__()
        if vision_kind == "rn50":
            self.visual = CLIPVisionRN(vision_cfg or CLIPVisionRNConfig(), dtype, device)
        elif vision_kind == "vit-b-16":
            self.visual = CLIPVisionViT(vision_cfg or CLIPVisionViTConfig(), dtype, device)
            text_cfg = CLIP_VITB16_TEXT if text_cfg is CLIP_RN50_TEXT else text_cfg
        else:
            raise ValueError(f"CLIP vision_kind: rn50 or vit-b-16, not {vision_kind!r}")
        self.text = CLIPTextEncoder(text_cfg, dtype, device)
        self.logit_scale = nn.Parameter(torch.zeros((), device=device), requires_grad=False)

    @property
    def output_dim(self) -> int:
        """The width of the image features."""
        return self.visual.cfg.output_dim

    def encode_image(self, images):
        """images (B, 3, S, S), CLIP-normalised -> unit features (B, output_dim)."""
        return _unit(self.visual(images))

    def encode_text(self, token_ids):
        """token_ids (B, 77) -> unit features (B, projection_dim)."""
        return _unit(self.text(token_ids)["proj"])

    def forward(self, images, token_ids):
        """Zero-shot logits (B_img, B_txt), scaled."""
        return torch.exp(self.logit_scale) * self.encode_image(images) @ self.encode_text(token_ids).T
