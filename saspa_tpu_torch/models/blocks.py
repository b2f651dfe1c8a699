"""Attention blocks: CBAM and spatial pyramid pooling (counterpart of
saspa_tpu/models/blocks.py; reference fgvc/models/blocks.py:14,50).

CBAM is the gate of the CBAM ResNets (models/resnet.py `use_cbam`): a
channel gate, sigmoid(mlp(max-pooled) + mlp(avg-pooled)) with one shared
bias-free MLP (`mlp_down`, ReLU, `mlp_up`), then a spatial gate,
sigmoid(7x7 conv of the [max, mean] over channels), no bias.  The JAX
module is built without a dtype, so its f32 parameters promote its
convolutions: in a bf16 net the gates, `x * channel_att` and the block's
output are f32 (the next bf16 convolution casts back).  Here too: each
convolution computes in the promotion of its input's dtype and its f32
kernel's (f64 when the model is cast to f64).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv, acc_dtype


class PromotingConv(Conv):
    """A bias-free Conv with f32 parameters that computes in the promotion
    of the input's dtype and its kernel's (flax's nn.Conv with dtype=None)."""

    def __init__(self, in_ch, out_ch, kernel_size, padding=0, device=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=padding, device=device, bias=False)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return F.conv2d(x.to(dt), self.kernel.to(dt), None, self.stride, self.padding)


class CBAMLayer(nn.Module):
    """forward(x (B, C, H, W)) -> the gated x, in at least f32."""

    def __init__(self, channel: int, reduction: int = 16, spatial_kernel: int = 7, device=None):
        super().__init__()
        self.mlp_down = PromotingConv(channel, channel // reduction, 1, device=device)
        self.mlp_up = PromotingConv(channel // reduction, channel, 1, device=device)
        self.spatial_conv = PromotingConv(2, 1, spatial_kernel, padding=(spatial_kernel - 1) // 2, device=device)

    def forward(self, x):
        max_pool = x.amax(dim=(2, 3), keepdim=True)
        avg_pool = acc_dtype(x).mean(dim=(2, 3), keepdim=True).to(x.dtype)  # jnp.mean: wide sum, x's dtype out

        def mlp(v):
            return self.mlp_up(F.relu(self.mlp_down(v)))

        channel_att = torch.sigmoid(mlp(max_pool) + mlp(avg_pool))
        x = x.to(channel_att.dtype) * channel_att
        sp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial_conv(sp))


class SPPLayer(nn.Module):
    """forward(x (B, C, H, W)) -> (B, C * sum(level^2)): at each level a
    max pool of window and stride ceil(H / level) x ceil(W / level) (VALID),
    flattened in the JAX module's (h, w, c) order."""

    def __init__(self, num_levels: int = 3):
        super().__init__()
        self.num_levels = num_levels

    def forward(self, x):
        b, _, h, w = x.shape
        feats = []
        for level in range(1, self.num_levels + 1):
            kh, kw = -(-h // level), -(-w // level)
            pooled = F.max_pool2d(x, (kh, kw), stride=(kh, kw))
            feats.append(pooled.permute(0, 2, 3, 1).reshape(b, -1))
        return torch.cat(feats, dim=-1)
