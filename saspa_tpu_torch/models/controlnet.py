"""Canny ControlNet for SD1.5 and SDXL (counterpart of saspa_tpu/models/controlnet.py).

A copy of the UNet encoder plus zero-initialised 1x1 output convs; for SDXL
(ControlNet-XL) the encoder's time embedding takes the text_time added
conditions, as the UNet's does.  The conditioning embedding (`embed_cond`)
is timestep-invariant; the sampler computes it once per batch, outside the
step loop.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv
from saspa_tpu_torch.models.unet import SD15_UNET, UNetConfig, UNetEncoder
from saspa_tpu_torch.ops.switches import DEFAULT, KernelSwitches

# parameters that flax initialises to zero
ZERO_INIT_PREFIXES = ("controlnet_cond_embedding.conv_out.", "controlnet_down_blocks_", "controlnet_mid_block.")


class ControlNetConditioningEmbedding(nn.Module):
    """(B, 3, 8h, 8w) conditioning image in [0, 1] -> (B, C0, h, w)."""

    def __init__(self, out_channels, dtype, device, block_channels=(16, 32, 96, 256)):
        super().__init__()
        self.conv_in = Conv(3, block_channels[0], 3, padding=1, dtype=dtype, device=device)
        for i in range(len(block_channels) - 1):
            setattr(self, f"blocks_{2 * i}", Conv(block_channels[i], block_channels[i], 3, padding=1,
                                                   dtype=dtype, device=device))
            setattr(self, f"blocks_{2 * i + 1}", Conv(block_channels[i], block_channels[i + 1], 3, stride=2,
                                                       padding=1, dtype=dtype, device=device))
        self.n_blocks = 2 * (len(block_channels) - 1)
        self.conv_out = Conv(block_channels[-1], out_channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for i in range(self.n_blocks):
            x = F.silu(getattr(self, f"blocks_{i}")(x))
        return self.conv_out(x)


class ControlNet(UNetEncoder):
    def __init__(self, cfg: UNetConfig = SD15_UNET, dtype=torch.float32, device=None,
                 switches: KernelSwitches = DEFAULT):
        super().__init__(cfg, dtype, device, switches)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(cfg.block_out_channels[0], dtype, device)
        for idx, ch in enumerate(self.skip_channels):
            setattr(self, f"controlnet_down_blocks_{idx}", Conv(ch, ch, 1, dtype=dtype, device=device))
        ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = Conv(ch, ch, 1, dtype=dtype, device=device)

    def embed_cond(self, cond):
        """(B, 3, 8h, 8w) cond image in [0, 1] -> (B, C0, h, w) embedding."""
        return self.controlnet_cond_embedding(cond.to(self.conv_in.kernel.dtype))

    def forward(self, sample, timesteps, encoder_hidden_states, cond_emb, conditioning_scale: float = 1.0,
                added_cond=None):
        """Returns (down residuals, mid residual), each scaled by
        conditioning_scale; added_cond as UNetEncoder.temb's (SDXL)."""
        dt = self.conv_in.kernel.dtype
        temb = self.temb(sample, timesteps, added_cond)
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.to(dt)) + cond_emb.to(dt)
        x, down_res = self.down(x, temb, context)
        x = self.mid_block(x, temb, context)
        out_res = [getattr(self, f"controlnet_down_blocks_{i}")(r) * conditioning_scale
                   for i, r in enumerate(down_res)]
        return out_res, self.controlnet_mid_block(x) * conditioning_scale
