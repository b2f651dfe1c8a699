"""GroupNorm(+SiLU) as the JAX main path runs it.

Counterpart of saspa_tpu/ops/groupnorm.py::_xla_group_norm (flax
nn.GroupNorm on an f32 upcast; the Pallas kernel K3 is off by default there):
f32 statistics with the fast variance max(E[x^2] - E[x]^2, 0), eps inside
rsqrt, (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, a cast to the
input dtype, then SiLU in that dtype.  Channels-first input (B, C, *spatial);
group g holds channels [g*C/G, (g+1)*C/G).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5, activation=None):
    b, c = x.shape[:2]
    groups = min(num_groups, c)
    if c % groups:
        groups = 1
    xf = x.float().reshape(b, groups, c // groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * gamma.float().reshape(1, groups, c // groups, 1)
    y = (xf - mean) * mul + beta.float().reshape(1, groups, c // groups, 1)
    out = y.reshape(x.shape).to(x.dtype)
    if activation == "silu":
        out = F.silu(out)
    return out
