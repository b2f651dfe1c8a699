"""Fused LayerNorm + GEGLU feed-forward (K2) and its plain version.

Counterpart of saspa_tpu/ops/geglu.py::fused_ln_geglu:
    out = x + (h * gelu_erf(g)) W2^T + b2,   [h | g] = LN(x) W1^T + b1
LN statistics in f32 with E[x^2] - E[x]^2, the normalize pass in x's dtype,
gelu on the f32 accumulators through Eigen's erf polynomial, b1 cast to x's
dtype then added in f32, the hidden cast to x's dtype before W2, and the
epilogue (out -> x.dtype) + b2 + x.  Weights are in torch layout:
w1 (2F, C) with the value rows first, w2 (C, F).

On the card the function runs as three stages behind one call (K4's
row-normalize writing xn, xn W1^T with the GEGLU epilogue writing hid, hid
W2^T with the residual epilogue); `ln_geglu_staged_plain` is the plain
mirror of those stages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from saspa_tpu_torch.ops import _build
from saspa_tpu_torch.ops.layernorm import LN_MAX_C, LnPlan, aligned16, layer_norm_one_pass_plain, ln_plan, sm_count

launches = 0  # calls of fused_ln_geglu / ln_geglu_stages that launched K2's kernels since the last reset

_ERF_A = (2.77068142495902e-08, -2.10102402082508e-06, -5.69250639462346e-05,
          -7.34990630326855e-04, -2.95459980854025e-03, -1.60960333262415e-02)
_ERF_B = (-2.13374055278905e-04, -1.68282697438203e-03, -7.37332916720468e-03,
          -1.42647390514189e-02)


def erf_f32(x):
    """Eigen generic_fast_erf_float (saspa_tpu/ops/geglu.py::_erf_f32)."""
    x = x.clamp(-3.832506856900711, 3.832506856900711)
    x2 = x * x
    a = torch.full_like(x, -2.72614225801306e-10)
    for c in _ERF_A:
        a = a * x2 + c
    a = a * x
    b = torch.full_like(x, -1.45660718464996e-05)
    for c in _ERF_B:
        b = b * x2 + c
    return a / b


def gelu_exact_f32(x):
    return 0.5 * x * (1.0 + erf_f32(x * (1.0 / math.sqrt(2.0))))


def fused_ln_geglu_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain version of K2 on (..., C) inputs; products in f32."""
    d = x.dtype
    f = w1.shape[0] // 2
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * ln_scale.float()
    xn = (x - mean.to(d)) * mul.to(d) + ln_bias.to(d)
    w1c, b1c = w1.to(d).float(), b1.to(d).float()
    h = xn.float() @ w1c[:f].t() + b1c[:f]
    g = xn.float() @ w1c[f:].t() + b1c[f:]
    hid = (h * gelu_exact_f32(g)).to(d)
    out = hid.float() @ w2.to(d).float().t()
    return (out.to(d) + b2.to(d)) + x


def geglu_hidden_plain(xn, w1, b1):
    """The second stage's plain version: hid = (h * gelu_erf(g)) in xn's
    dtype, [h | g] = xn W1^T + b1 in f32 (b1 cast to xn's dtype first)."""
    d = xn.dtype
    f = w1.shape[0] // 2
    w1c, b1c = w1.to(d).float(), b1.to(d).float()
    h = xn.float() @ w1c[:f].t() + b1c[:f]
    g = xn.float() @ w1c[f:].t() + b1c[f:]
    return (h * gelu_exact_f32(g)).to(d)


def geglu_out_plain(hid, w2, b2, x):
    """The third stage's plain version: (hid W2^T -> x.dtype) + b2 + x."""
    d = x.dtype
    out = hid.float() @ w2.to(d).float().t()
    return (out.to(d) + b2.to(d)) + x


def ln_geglu_staged_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """The plain mirror of the card's three stages for x: (..., C): (xn, hid,
    out), xn (M, C) and hid (M, F) with M = x.numel() // C, out like x.  out
    is fused_ln_geglu_plain's, rounding for rounding."""
    c = x.shape[-1]
    xn = layer_norm_one_pass_plain(x, ln_scale, ln_bias, eps).reshape(-1, c)
    hid = geglu_hidden_plain(xn, w1, b1)
    return xn, hid, geglu_out_plain(hid, w2, b2, x.reshape(-1, c)).reshape(x.shape)


class GegluPlan(NamedTuple):
    """Launch plan of K2: the row-normalize's plan, and the second product's
    N tile (output columns a block)."""
    ln: LnPlan
    bn_down: int


def geglu_plan(m: int, c: int, sms: int) -> GegluPlan:
    """160 output columns a block where they divide C (the UNet's 320, 640,
    1280: 2, 4, 8 tiles), else 64."""
    return GegluPlan(ln_plan(m, c, sms), 160 if c % 160 == 0 else 64)


def ln_geglu_stages(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """(xn, hid, out) of K2's three stages for x: (..., C); xn and hid are
    (M, C) and (M, F), M = x.numel() // C.  CPU tensors run the plain
    stages; CUDA tensors launch the kernels (bf16 x, w1, b1, w2, b2; f32 LN
    params; C and F multiples of 64, C <= 2048; contiguous and 16-byte
    aligned) or raise."""
    global launches
    if x.device.type == "cpu":
        return ln_geglu_staged_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    c = x.shape[-1]
    f = w1.shape[0] // 2
    m = x.numel() // c
    bf = torch.bfloat16
    if any(t.dtype != bf for t in (x, w1, b1, w2, b2)) or any(t.dtype != torch.float32 for t in (ln_scale, ln_bias)):
        raise TypeError("fused_ln_geglu on CUDA takes bf16 x/w1/b1/w2/b2 and f32 LN scale/bias")
    if w1.shape != (2 * f, c) or b1.shape != (2 * f,) or w2.shape != (c, f) or b2.shape != (c,) \
            or ln_scale.shape != (c,) or ln_bias.shape != (c,):
        raise ValueError(f"fused_ln_geglu shapes: x {tuple(x.shape)} w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    if c % 64 or f % 64 or c > LN_MAX_C:
        raise ValueError(f"fused_ln_geglu kernel needs C and F multiples of 64 and C <= {LN_MAX_C}, got {c}, {f}")
    ts = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if not all(t.is_contiguous() and t.device == x.device for t in ts):
        raise ValueError("fused_ln_geglu needs contiguous inputs on one device")
    if not aligned16(*ts):
        raise ValueError("fused_ln_geglu needs 16-byte aligned inputs")
    xn = torch.empty((m, c), dtype=bf, device=x.device)
    hid = torch.empty((m, f), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    plan = geglu_plan(m, c, sm_count(x.device))
    fn = _build.kernel("ln_geglu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), xn.data_ptr(), hid.data_ptr(), out.data_ptr(), m, c, f,
                    *plan.ln, plan.bn_down, float(eps), stream), "ln_geglu")
    launches += 1
    return xn, hid, out


def _pick_block_q(l: int) -> int:
    """The q-block of the JAX kernel (the JAX function of this name without
    its environment override)."""
    for cand in (min(512, l), 256, 128, 64):
        if cand <= l and l % cand == 0:
            return cand
    return l


def ln_geglu_eligible(l: int, c: int, mult: int, dtype) -> bool:
    """Copy of the JAX predicate (without its backend check and the
    switches, which `KernelSwitches.fused_ff` holds): bf16 activations, L a
    multiple of 64, and the block's weights, accumulators and temporaries
    within 88 MiB of VMEM.  So f32 blocks, ragged token counts (a 960x1280
    bucket's 1200 and 300) and C1536 at 1024 tokens take the separate ops."""
    if dtype != torch.bfloat16 or l < 64 or l % 64:
        return False
    f = c * mult
    bq = _pick_block_q(l)
    vmem = (2 * 3 * c * f + 2 * 2 * f + 2 * 2 * c + 4 * 2 * c + 2 * 2 * 2 * bq * c + 2 * 4 * bq * f
            + 2 * bq * f + 2 * 4 * bq * c)
    return vmem <= 88 * 1024 * 1024


def fused_ln_geglu(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """x: (B, L, C).  CPU tensors run the plain version; CUDA tensors launch
    K2's kernels (see ln_geglu_stages) or raise."""
    if x.device.type == "cpu":
        return fused_ln_geglu_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return ln_geglu_stages(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)[2]
