"""HED edge detection, the HED ControlNet's conditioner (counterpart of
saspa_tpu/models/hed.py).

controlnet_aux's ControlNetHED_Apache2: a learned per-channel offset
(`norm`) subtracted from the image in 0-255, five VGG stages of 3x3 conv +
ReLU with a 2x2 max-pool between them (floor on odd sizes, flax's VALID
pooling), a 1x1 projection to one channel after each stage, cast to f32 and
resized linearly to the input size (jax.image.resize's "linear": half-pixel
centres, the edge samples clamped, which is F.interpolate's bilinear with
align_corners=False when upsampling), then the mean of the five side
outputs and a sigmoid.  The convolutions run in the pipeline's dtype on f32
parameters (cuDNN; the JAX package runs them in XLA, not in a Pallas
kernel).  Parameter names follow the flax tree: `norm` (1, 1, 1, 3),
`block{n}_conv{m}` and `block{n}_projection`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class HED(nn.Module):
    """forward(x (B, H, W, 3) in [0, 1]) -> (B, H, W) edge probability, f32."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 1, 1, 3, device=device), requires_grad=False)
        cin = 3
        for si, (ch, n_convs) in enumerate(STAGES, start=1):
            for ci in range(1, n_convs + 1):
                setattr(self, f"block{si}_conv{ci}", Conv(cin, ch, 3, padding=1, dtype=dtype, device=device,
                                                         param_dtype=torch.float32))
                cin = ch
            setattr(self, f"block{si}_projection", Conv(ch, 1, 1, dtype=dtype, device=device,
                                                        param_dtype=torch.float32))

    def forward(self, x):
        b, h, w, _ = x.shape
        x = (x * 255.0 - self.norm.to(x.dtype)).permute(0, 3, 1, 2)
        sides = []
        for si, (_, n_convs) in enumerate(STAGES, start=1):
            for ci in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"block{si}_conv{ci}")(x))
            side = getattr(self, f"block{si}_projection")(x).float()
            sides.append(F.interpolate(side, size=(h, w), mode="bilinear", align_corners=False))
            if si < len(STAGES):
                x = F.max_pool2d(x, 2, 2)
        return torch.sigmoid(torch.cat(sides, dim=1).mean(dim=1))


def hed_control_image(model: HED, images) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, H, W, 3) in [0, 1], the ControlNet's
    conditioning image."""
    return model(images)[..., None].repeat(1, 1, 1, 3)
