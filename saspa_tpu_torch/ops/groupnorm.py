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
(csrc/group_norm.cu), two launches (statistics, normalize) with both
epilogues, on a launch plan chosen here (`gn_plan`), for bf16 or f32 input
(the XL VAE under SASPA_XL_VAE_FP32=1; the TPU kernel's numerics then
normalize and apply SiLU in f32, `_gn_kernel` on f32 blocks).  Input (B, C,
*spatial); group g holds channels [g*C/G, (g+1)*C/G).  On the card the
input is channels-last (NHWC in memory), the format the port's
convolutions keep from the latents on, and the output keeps it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from saspa_tpu_torch.ops import _build
from saspa_tpu_torch.ops.layernorm import aligned16, sm_count

launches = 0  # calls of group_norm that launched K3 on bf16 since the last reset
launches_tpu = 0  # of which with the TPU kernel's numerics
launches_f32 = 0  # calls of group_norm that launched K3 on f32 since the last reset

VMEM_LIMIT = 44 * 1024 * 1024  # _split_plan's per-sample block budget
# csrc/group_norm.cu: a thread owns one 16-byte vector (8 bf16 or 4 f32
# channels) of a pixel row; blocks of whole warps, at most GN_MAX_THREADS,
# and two of the largest resident an SM (__launch_bounds__(512, 2)), so the
# grid aims at GN_THREADS_PER_SM threads an SM
GN_MAX_THREADS = 512
GN_THREADS_PER_SM = 1024
GN_MAX_GROUPS = 64
GN_MAX_C = 8 * GN_MAX_THREADS  # bf16; f32 takes 4 * GN_MAX_THREADS


class GnPlan(NamedTuple):
    """Launch plan of K3: blocks of `threads` (whole warps) hold `rows`
    pixel rows side by side, C/8 threads a row, and `blocks` blocks a sample
    (grid (blocks, B)) walk the sample's rows grid-stride."""
    threads: int
    rows: int
    blocks: int


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, hw: int, c: int, sms: int, vec: int = 8) -> GnPlan:
    """The plan for B samples of hw pixel rows of c channels in vectors of
    `vec` (8 bf16 or 4 f32: c % vec == 0, c <= vec * GN_MAX_THREADS) on a
    card of `sms` SMs: the rows a block holds side by side
    that leave the fewest idle threads in its whole warps, then the block
    nearest 256 threads (C320: 8 rows of 40 threads, 320; C960: 4 of 120;
    C1280: 2 of 160; C128: 16 of 16); then as many blocks a sample as the
    card holds at once, GN_THREADS_PER_SM an SM, shared by the B samples
    (rounded down: a block past one wave would double the kernel's time),
    but no more than the sample has row groups."""
    nv = c // vec
    best = None
    for rows in range(1, GN_MAX_THREADS // nv + 1):
        threads = -(-rows * nv // 32) * 32
        key = ((threads - rows * nv) / threads, abs(threads - 256))
        if best is None or key < best[0]:
            best = (key, threads, rows)
    _, threads, rows = best
    per_sm = max(1, GN_THREADS_PER_SM // threads)
    return GnPlan(threads, rows, max(1, min(-(-hw // rows), sms * per_sm // b)))


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
    version; CUDA tensors launch K3 (bf16 or f32 x, 4-d channels-last, C a
    whole number of 16-byte vectors, 16-byte aligned) or raise."""
    global launches, launches_tpu, launches_f32
    if x.device.type == "cpu":
        plain = group_norm_tpu_plain if tpu_numerics else group_norm_plain
        return plain(x, gamma, beta, num_groups, eps, activation)
    b, c = x.shape[:2]
    groups = groups_for(c, num_groups)
    if x.dtype not in (torch.bfloat16, torch.float32) or gamma.dtype != torch.float32 \
            or beta.dtype != torch.float32:
        raise TypeError(f"group_norm on CUDA takes bf16 or f32 x and f32 gamma/beta, got "
                        f"{x.dtype}/{gamma.dtype}/{beta.dtype}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"group_norm: gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} for {c} channels")
    if activation not in (None, "silu"):
        raise ValueError(f"group_norm: activation {activation!r}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm on CUDA needs a 4-d channels-last x")
    vec = 16 // x.element_size()
    if c % vec or c > vec * GN_MAX_THREADS or groups > GN_MAX_GROUPS:
        raise ValueError(f"group_norm: needs C % {vec} == 0, C <= {vec * GN_MAX_THREADS}, G <= {GN_MAX_GROUPS} for "
                         f"{x.dtype}; got {c}, {groups}")
    if not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("group_norm needs contiguous gamma, beta")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("group_norm inputs on different devices")
    if not aligned16(x, gamma, beta):
        raise ValueError("group_norm needs 16-byte aligned x, gamma, beta")
    hw = x.shape[2] * x.shape[3]
    plan = gn_plan(b, hw, c, sm_count(x.device), vec)
    ws = torch.empty((b * groups * plan.blocks, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)  # in x's memory format
    fn = _build.kernel("group_norm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), ws.data_ptr(), b, c, hw,
                    groups, *plan, float(eps), int(activation == "silu"), int(tpu_numerics), int(vec == 4), stream),
                 "group_norm")
    if vec == 4:
        launches_f32 += 1
    else:
        launches += 1
        launches_tpu += int(tpu_numerics)
    return out
