"""GroupNorm(+SiLU): the fused kernel K3 and its two plain versions.

Counterparts in saspa_tpu/ops/groupnorm.py:
- `group_norm_plain` is `_xla_group_norm`, what the JAX main path runs by
  default (flax nn.GroupNorm on an f32 upcast): f32 statistics with the fast
  variance max(E[x^2] - E[x]^2, 0), eps inside rsqrt, (x - mean) *
  (rsqrt(var + eps) * scale) + bias in f32, a cast to the input dtype, then
  SiLU in that dtype.
- `group_norm_tpu_plain` is the Pallas kernel `_gn_kernel` with its default
  bf16 normalize (SASPA_PALLAS_GN=1): the same statistics without the clamp,
  folded per channel into scale = gamma * rstd and shift = beta - mean *
  scale (f32, then rounded to the input dtype), o = x * scale + shift and
  o * (1 / (1 + exp(-o))), each op in the input dtype.
- `split_plan` is the port's copy of `_split_plan`: the sites the TPU kernel
  admits (it fits one sample's channel block in 44 MiB of VMEM).

`group_norm(..., tpu_numerics)` computes one of the two: on CPU tensors
through the plain version, on CUDA tensors through K3
(csrc/group_norm.cu), one kernel with both epilogues.  Input (B, C,
*spatial); group g holds channels [g*C/G, (g+1)*C/G).  On the card the
input is channels-last (NHWC in memory), the format the port's
convolutions keep from the latents on, and the output keeps it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from saspa_tpu_torch.ops import _build

launches = 0  # K3 launches since the last reset
launches_tpu = 0  # of which with the TPU kernel's numerics

VMEM_LIMIT = 44 * 1024 * 1024  # _split_plan's per-sample block budget
GN_CHUNK = 4096  # elements (whole pixel rows) one block of K3 reduces and writes


def groups_for(c: int, num_groups: int) -> int:
    """The JAX callers' rule: min(num_groups, C) groups, or 1 when C is not a multiple."""
    groups = min(num_groups, c)
    return groups if c % groups == 0 else 1


def _pick_chunk(hw: int, c: int) -> int:
    budget = max(8, (1 << 19) // max(c, 1))
    chunk = 8
    while chunk * 2 <= min(512, hw, budget):
        chunk *= 2
    return chunk


def split_plan(hw: int, c: int, groups: int, itemsize: int):
    """(n_split, chunk) of the TPU kernel for a (B, HW, C) input of the given
    element size, or None where it does not fit: the smallest power-of-two
    channel split covering whole groups (C/n_split a multiple of 128 unless
    n_split is 1) whose block, 2*HW*C_blk*itemsize plus the f32 row temps,
    fits 44 MiB."""
    if hw & (hw - 1) or hw < 8:
        return None
    n_split = 1
    while n_split <= groups:
        if groups % n_split == 0 and (n_split == 1 or (c // n_split) % 128 == 0):
            cblk = c // n_split
            chunk = _pick_chunk(hw, cblk)
            if 2 * hw * cblk * itemsize + 2 * chunk * cblk * 4 + cblk * 4 * 4 <= VMEM_LIMIT:
                return n_split, chunk
        n_split *= 2
    return None


def group_norm_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5, activation=None):
    """`_xla_group_norm` order."""
    b, c = x.shape[:2]
    groups = groups_for(c, num_groups)
    xf = x.float().reshape(b, groups, c // groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * gamma.float().reshape(1, groups, c // groups, 1)
    y = (xf - mean) * mul + beta.float().reshape(1, groups, c // groups, 1)
    out = y.reshape(x.shape).to(x.dtype)
    if activation == "silu":
        out = F.silu(out)
    return out


def group_norm_tpu_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5, activation=None):
    """`_gn_kernel` numerics (bf16 normalize for bf16 input, f32 for f32)."""
    b, c = x.shape[:2]
    groups = groups_for(c, num_groups)
    cg = c // groups
    xf = x.float().reshape(b, groups, cg, -1)
    n = float(xf.shape[2] * xf.shape[3])
    mean = xf.sum(dim=(2, 3)) / n  # (B, G)
    var = (xf * xf).sum(dim=(2, 3)) / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    scale = gamma.float().reshape(1, groups, cg) * rstd[:, :, None]  # (B, G, C/G)
    shift = beta.float().reshape(1, groups, cg) - mean[:, :, None] * scale
    shape = (b, c) + (1,) * (x.dim() - 2)
    o = x * scale.reshape(shape).to(x.dtype) + shift.reshape(shape).to(x.dtype)
    if activation == "silu":
        o = o * (1.0 / (1.0 + torch.exp(-o)))
    return o


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5, activation=None,
               tpu_numerics: bool = False):
    """x: (B, C, *spatial); gamma, beta: (C,) f32.  CPU tensors run the plain
    version; CUDA tensors launch K3 (bf16 x, channels-last) or raise."""
    global launches, launches_tpu
    if x.device.type == "cpu":
        plain = group_norm_tpu_plain if tpu_numerics else group_norm_plain
        return plain(x, gamma, beta, num_groups, eps, activation)
    b, c = x.shape[:2]
    groups = groups_for(c, num_groups)
    hw = math.prod(x.shape[2:])
    if x.dtype != torch.bfloat16 or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError(f"group_norm on CUDA takes bf16 x and f32 gamma/beta, got {x.dtype}/{gamma.dtype}/{beta.dtype}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"group_norm: gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} for {c} channels")
    if activation not in (None, "silu"):
        raise ValueError(f"group_norm: activation {activation!r}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm on CUDA needs a 4-d channels-last x")
    if (c // groups) % 2 or groups > 64 or c > 4096:
        raise ValueError(f"group_norm: needs an even C/G, G <= 64, C <= 4096; got {c}, {groups}")
    chunk = max(1, GN_CHUNK // c)  # pixel rows
    nchunk = -(-hw // chunk)
    if not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("group_norm needs contiguous gamma, beta")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("group_norm inputs on different devices")
    ws = torch.empty((b * groups * (nchunk + 1), 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)  # in x's memory format
    fn = _build.kernel("group_norm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), ws.data_ptr(), b, c, hw,
                    groups, chunk, nchunk, float(eps), int(activation == "silu"), int(tpu_numerics), stream),
                "group_norm")
    launches += 1
    launches_tpu += int(tpu_numerics)
    return out
