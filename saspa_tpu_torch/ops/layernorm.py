"""One-pass LayerNorm (K4) and its plain version.

Counterpart of saspa_tpu/ops/layernorm.py::layer_norm_one_pass (Pallas
kernel `_ln_kernel`), which computes exactly what the JAX main path's
`models/unet.py::_ln32_forward` computes: f32 statistics with the fast
variance E[x^2] - E[x]^2 (no clamp), eps inside rsqrt, and the normalize in
x's dtype in flax's association (x - mean) * (rsqrt * scale) + bias, with
mean, rsqrt * scale and bias each cast to x's dtype first.  The transformer
blocks' norm1/norm2 run it at every site.
"""

from __future__ import annotations

import torch

from saspa_tpu_torch.ops import _build

launches = 0  # K4 launches since the last reset

LN_MAX_C = 2048  # the kernel keeps one row in a warp's registers


def layer_norm_one_pass_plain(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * scale
    if x.dtype == torch.float32:
        return (xf - mean) * mul + bias
    d = x.dtype
    return (x - mean.to(d)) * mul.to(d) + bias.to(d)


def layer_norm_one_pass(x, scale, bias, eps: float = 1e-5):
    """x: (..., C); scale, bias: (C,) f32.  CPU tensors run the plain version;
    CUDA tensors launch K4 (bf16 x, C % 8 == 0, C <= 2048) or raise."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_one_pass_plain(x, scale, bias, eps)
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"layer_norm_one_pass on CUDA takes bf16 x and f32 scale/bias, got {x.dtype}/{scale.dtype}")
    if scale.shape != (c,) or bias.shape != (c,) or c % 8 or c > LN_MAX_C:
        raise ValueError(f"layer_norm_one_pass: C {c} (multiple of 8, at most {LN_MAX_C}), scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layer_norm_one_pass needs contiguous x, scale, bias")
    if not (x.device == scale.device == bias.device):
        raise ValueError("layer_norm_one_pass inputs on different devices")
    out = torch.empty_like(x)
    fn = _build.kernel("layernorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // c, c,
                    float(eps), stream), "layernorm")
    launches += 1
    return out
