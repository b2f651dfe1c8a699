"""LPIPS perceptual distance with the AlexNet trunk (counterpart of
saspa_tpu/models/lpips.py).

The reference's optional filter (lpips.LPIPS(net='alex'),
all_utils/utils.py:270,576-590): the lpips scaling layer, AlexNet's five
convolutions (11x11 stride 4 pad 2, 5x5 pad 2, 3x3 pad 1 x3, ReLU after
each, 3x3 stride-2 max-pools without padding after the first two), each
feature map unit-normalised over its channels (eps 1e-10), the squared
difference weighted by a 1x1 head `lin{i}` and averaged over space, summed
over the five.  Module and parameter names follow the flax tree.  The
trunk runs in the model's dtype (bf16 on the card, as the JAX filter's
LPIPS(dtype=bfloat16)); the normalisation and the heads in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv, init_weights

# the lpips package's scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_ALEX_CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        specs = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1),
                 (256, 256, 3, 1, 1))
        for i, (cin, cout, k, s, pad) in enumerate(specs, start=1):
            setattr(self, f"conv{i}", Conv(cin, cout, k, stride=s, padding=pad, dtype=dtype, device=device))

    def forward(self, x):
        feats = []
        for i in range(1, 6):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i <= 2:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """forward(x0, x1): images (B, 3, H, W) in [-1, 1] -> (B,) f32 distances."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.alex = AlexNetFeatures(dtype, device)
        for i, c in enumerate(_ALEX_CHANNELS):
            setattr(self, f"lin{i}", Conv(c, 1, 1, bias=False, dtype=torch.float32, device=device))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device).view(1, 3, 1, 1), persistent=False)

    def init_seeded(self, seed: int = 0) -> "LPIPS":
        """Seeded trunk, heads at 1/C (flax's constant init of the JAX module)."""
        init_weights(self, seed)
        with torch.no_grad():
            for i, c in enumerate(_ALEX_CHANNELS):
                getattr(self, f"lin{i}").kernel.fill_(1.0 / c)
        return self

    def forward(self, x0, x1):
        b = x0.shape[0]
        x = (torch.cat([x0, x1]).float() - self.shift) / self.scale
        total = torch.zeros(b, dtype=torch.float32, device=x0.device)
        for i, f in enumerate(self.alex(x)):
            f = f.float()
            u = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            diff = (u[:b] - u[b:]) ** 2
            total = total + getattr(self, f"lin{i}")(diff).mean(dim=(1, 2, 3))
        return total
