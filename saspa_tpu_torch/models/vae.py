"""AutoencoderKL (counterpart of saspa_tpu/models/vae.py), NCHW with
channels-last memory, as the latents arrive.

`encode` (SDEdit, BLIP-Diffusion's inversion) returns the posterior's mean
and clipped logvar; `decode` the image in [-1, 1].  The encoder's stride-2
downsamples pad one row and column at the bottom and right only, flax's
((0, 1), (0, 1)).  Both mid-blocks' one-head attention (d = 512 at SD width)
takes the packed kernel when its head dim is already lane-aligned and the
packed predicate admits the token count, as the JAX package routes it; past
the packed guard (16384 tokens at 1024^2) it takes the plain path, as JAX
takes XLA there.  Every GroupNorm runs K3.  The switches
(ops/switches.py) reach the VAE as they reach the UNet: `pallas_group_norm`
gives K3 the TPU kernel's numerics where that kernel's split plan admits
the site (not the 512^2 levels, see ops/groupnorm.py::split_plan; with
`gn_fp32_norm` its f32 normalize), and `disable_pallas` sends the mid-block
attention to the plain path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv, Dense
from saspa_tpu_torch.models.unet import GroupNorm32, gn_options
from saspa_tpu_torch.ops.attention import (
    LOG2E,
    attention,
    flash_attention_packed,
    fold_scale,
    packed_flash_eligible,
    pad_head_dim,
)
from saspa_tpu_torch.ops.switches import DEFAULT, KernelSwitches


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, dtype, device, switches: KernelSwitches = DEFAULT):
        super().__init__()
        gn = gn_options(switches)
        self.norm1 = GroupNorm32(in_ch, 32, eps=1e-6, act="silu", device=device, **gn)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype, device=device)
        self.norm2 = GroupNorm32(out_ch, 32, eps=1e-6, act="silu", device=device, **gn)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype, device=device)
        self.conv_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype, device=device) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    def __init__(self, ch, dtype, device, switches: KernelSwitches = DEFAULT):
        super().__init__()
        self.kernels = not switches.disable_pallas
        self.group_norm = GroupNorm32(ch, 32, eps=1e-6, device=device, **gn_options(switches))
        self.to_q = Dense(ch, ch, dtype=dtype, device=device)
        self.to_k = Dense(ch, ch, dtype=dtype, device=device)
        self.to_v = Dense(ch, ch, dtype=dtype, device=device)
        self.to_out = Dense(ch, ch, dtype=dtype, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.kernels and c == pad_head_dim(c) and packed_flash_eligible(h * w, h * w, 1, c, x.element_size()):
            out = flash_attention_packed(fold_scale(q, (1.0 / math.sqrt(c)) * LOG2E), k, v, 1)
        else:
            out = attention(q, k, v, 1, self.kernels)
        out = self.to_out(out)
        return res + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype, device, switches: KernelSwitches = DEFAULT):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        cur = boc[0]
        self.conv_in = Conv(cfg.in_channels, cur, 3, padding=1, dtype=dtype, device=device)
        for i, ch in enumerate(boc):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_block_{j}", VAEResnetBlock(cur, ch, dtype, device, switches))
                cur = ch
            if i < len(boc) - 1:
                setattr(self, f"down_{i}_downsample", Conv(ch, ch, 3, stride=2, dtype=dtype, device=device))
        self.mid_block_1 = VAEResnetBlock(cur, cur, dtype, device, switches)
        self.mid_attn = VAEAttentionBlock(cur, dtype, device, switches)
        self.mid_block_2 = VAEResnetBlock(cur, cur, dtype, device, switches)
        self.conv_norm_out = GroupNorm32(cur, 32, eps=1e-6, act="silu", device=device, **gn_options(switches))
        self.conv_out = Conv(cur, 2 * cfg.latent_channels, 3, padding=1, dtype=dtype, device=device)
        self.quant_conv = Conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, dtype=dtype, device=device)

    def forward(self, x):
        cfg = self.cfg
        x = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_block_{j}")(x)
            if i < len(cfg.block_out_channels) - 1:
                x = getattr(self, f"down_{i}_downsample")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        return self.quant_conv(self.conv_out(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype, device, switches: KernelSwitches = DEFAULT):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1, dtype=dtype, device=device)
        cur = boc[-1]
        self.conv_in = Conv(cfg.latent_channels, cur, 3, padding=1, dtype=dtype, device=device)
        self.mid_block_1 = VAEResnetBlock(cur, cur, dtype, device, switches)
        self.mid_attn = VAEAttentionBlock(cur, dtype, device, switches)
        self.mid_block_2 = VAEResnetBlock(cur, cur, dtype, device, switches)
        for i, ch in enumerate(reversed(boc)):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_block_{j}", VAEResnetBlock(cur, ch, dtype, device, switches))
                cur = ch
            if i < len(boc) - 1:
                setattr(self, f"up_{i}_upsample", Conv(ch, ch, 3, padding=1, dtype=dtype, device=device))
        self.conv_norm_out = GroupNorm32(cur, 32, eps=1e-6, act="silu", device=device, **gn_options(switches))
        self.conv_out = Conv(cur, cfg.in_channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, z):
        cfg = self.cfg
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_block_{j}")(x)
            if i < len(cfg.block_out_channels) - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """encode(x (B, 3, H, W) in [-1, 1]) -> (mean, logvar), (B, 4, H/8, W/8)
    each in the VAE's dtype; decode(z (B, 4, h, w)) -> image (B, 3, 8h, 8w)
    in [-1, 1], f32.  Latent scaling lives in the pipeline."""

    def __init__(self, cfg: VAEConfig = SD_VAE, dtype=torch.float32, device=None,
                 switches: KernelSwitches = DEFAULT):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype, device, switches)
        self.decoder = Decoder(cfg, dtype, device, switches)

    def encode(self, x):
        moments = self.encoder(x.to(self.encoder.conv_in.kernel.dtype))
        mean, logvar = moments.chunk(2, dim=1)  # the channel axis: 4 means, then 4 logvars
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        return self.decoder(z.to(self.decoder.conv_in.kernel.dtype)).float()
