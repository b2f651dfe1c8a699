"""One-pass LayerNorm (K4) and its plain version.

Counterpart of saspa_tpu/ops/layernorm.py::layer_norm_one_pass (Pallas
kernel `_ln_kernel`), which computes exactly what the JAX main path's
`models/unet.py::_ln32_forward` computes: f32 statistics with the fast
variance E[x^2] - E[x]^2 (no clamp), eps inside rsqrt, and the normalize in
x's dtype in flax's association (x - mean) * (rsqrt * scale) + bias, with
mean, rsqrt * scale and bias each cast to x's dtype first (on f32 x, all
of it in f32: `_ln_kernel`'s f32 branch).  The transformer blocks'
norm1/norm2 run it at every site, and norm3 where the block does not take
K2 (every block of an f32 UNet).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from saspa_tpu_torch.ops import _build

launches = 0  # K4 launches on bf16 since the last reset
launches_f32 = 0  # K4 launches on f32 since the last reset

# csrc/layernorm_row.cuh: blocks of 8 warps; a lane holds at most 8 16-byte
# vectors of its row (12 for f32), so a row of a warp's 32 lanes holds at
# most 2048 bf16 or 1536 f32
LN_THREADS = 256
LN_MAXV = 8
LN_MAX_C = 32 * 8 * LN_MAXV
LN_MAXV_F32 = 12
LN_MAX_C_F32 = 32 * 4 * LN_MAXV_F32
LN_BLOCKS_PER_SM = 4  # the grid-stride grid: 32 warps an SM


class LnPlan(NamedTuple):
    """Launch plan of the row-normalize (K4, and K2's first stage): `lanes`
    lanes of a warp share a row (32 // lanes rows a warp), lane li holds the
    row's 16-byte vectors li + j * lanes for j < `vecs`, and `blocks` blocks
    of LN_THREADS walk the rows grid-stride."""
    lanes: int
    vecs: int
    blocks: int


def ln_plan(m: int, c: int, sms: int, vec: int = 8) -> LnPlan:
    """The plan for m rows of c elements in 16-byte vectors of `vec` (8
    bf16: c <= LN_MAX_C; 4 f32: c <= LN_MAX_C_F32; c % 8 == 0) on a card of
    `sms` SMs: no lane without a vector, the fewest idle vector slots a row,
    then the most lanes; at C = 320, 640, 1280 that is 5 vectors a lane on
    8, 16, 32 lanes in bf16, and 5, 5, 10 on 16, 32, 32 in f32."""
    nv = c // vec
    maxv = LN_MAXV if vec == 8 else LN_MAXV_F32
    lanes, vecs = min(((n, -(-nv // n)) for n in (32, 16, 8, 4, 2, 1) if n <= nv and -(-nv // n) <= maxv),
                      key=lambda p: (p[0] * p[1] - nv, -p[0]))
    rows_per_block = LN_THREADS // 32 * (32 // lanes)
    return LnPlan(lanes, vecs, max(1, min(-(-m // rows_per_block), sms * LN_BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned16(*ts) -> bool:
    """Whether every tensor starts on a 16-byte boundary (the kernels' vector
    loads and TMA need it)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def layer_norm_one_pass_plain(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * scale
    if x.dtype == torch.float32:
        return (xf - mean) * mul + bias
    d = x.dtype
    return (x - mean.to(d)) * mul.to(d) + bias.to(d)


def layer_norm_fp32_norm(x, scale, bias, eps: float = 1e-5):
    """`_ln32_forward` under SASPA_LN_FP32_NORM=1: the same statistics, the
    normalize in f32, ((xf - mean) * mul + bias) cast once to x's dtype.
    Plain torch on any device: the JAX package runs no kernel here."""
    return layer_norm_one_pass_plain(x.float(), scale, bias, eps).to(x.dtype)


def layer_norm_one_pass(x, scale, bias, eps: float = 1e-5):
    """x: (..., C); scale, bias: (C,) f32.  CPU tensors run the plain version;
    CUDA tensors launch K4 (bf16 x with C <= 2048, or f32 x with C <= 1536,
    counted in launches_f32; C % 8 == 0, 16-byte aligned) or raise."""
    global launches, launches_f32
    if x.device.type == "cpu":
        return layer_norm_one_pass_plain(x, scale, bias, eps)
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32) or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError(f"layer_norm_one_pass on CUDA takes bf16 or f32 x and f32 scale/bias, got "
                        f"{x.dtype}/{scale.dtype}")
    f32 = x.dtype == torch.float32
    max_c = LN_MAX_C_F32 if f32 else LN_MAX_C
    if scale.shape != (c,) or bias.shape != (c,) or c % 8 or c > max_c:
        raise ValueError(f"layer_norm_one_pass: C {c} (multiple of 8, at most {max_c} for {x.dtype}), "
                         f"scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layer_norm_one_pass needs contiguous x, scale, bias")
    if not (x.device == scale.device == bias.device):
        raise ValueError("layer_norm_one_pass inputs on different devices")
    if not aligned16(x, scale, bias):
        raise ValueError("layer_norm_one_pass needs 16-byte aligned x, scale, bias")
    out = torch.empty_like(x)
    m = x.numel() // c
    plan = ln_plan(m, c, sm_count(x.device), 4 if f32 else 8)
    fn = _build.kernel("layernorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, c, *plan, float(eps),
                    int(f32), stream), "layernorm")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out
