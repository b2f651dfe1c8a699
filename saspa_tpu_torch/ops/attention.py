"""Multi-head attention: the packed-heads kernel (K1), the self-attention
block kernel (K5), the streamed flash kernel (K6) and the plain path.

Counterpart of saspa_tpu/ops/attention.py.  Self-attention over image tokens
that `packed_flash_eligible` admits (lq == lk >= 256, lq % 128 == 0, and the
packed kernel's 48 MiB guard, counted in the activations' bytes: the XL
VAE's f32 head of 512 at 4096 tokens is admitted, at 16384 it is not) runs
`flash_attention_packed` (bf16 or f32) on packed
(B, L, H*D_pad) tensors whose head dims are zero-padded in the projection
weights (64/128/192 for SD1.5's 40/80/160; the VAE's 512 as is).  Past that
guard (SD1.5's level 0 at 1024^2: 16384 tokens) the projections stay
unpadded and `attention()` routes as the JAX package does: K6
(`flash_attention`, bf16 or f32, which pads the heads in shared memory) where
`flash_attention_route` admits the shape, else `plain_attention`, the
counterpart of `_xla_attention`.  Short-kv cross-attention (77 text tokens)
and the text tower take the plain path, and so do the CLIP image towers
(`use_kernels=False`, JAX's `use_pallas=False`).  With the megakernel
option, each transformer block's self-attention that
`attention_block_eligible` admits runs `attention_block_fused` instead: the
Q/K/V projections, the attention, to_out, its bias and the residual add
behind one wrapper (bf16: csrc/attention_block.cu; f32: the f32 core's
block entry in csrc/attention_f32.cu).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from saspa_tpu_torch.ops import _build

LOG2E = math.log2(math.e)
FLASH_HEAD_DIMS = (64, 128, 192)  # the padded head dims K6 takes
PLAIN_SCORE_BYTES = 1 << 30  # f32 scores K6's plain version holds at once

launches = 0  # bf16 kernel launches of flash_attention_packed since the last reset
launches_f32 = 0  # f32 kernel launches of flash_attention_packed at d_pad 512 (csrc/attention_packed_f32.cu)
launches_f32_heads = 0  # f32 kernel launches of flash_attention_packed at d_pad 64/128/192 (csrc/attention_f32.cu)
block_launches = 0  # bf16 calls of attention_block_fused / attention_block_stages that launched K5 since the last reset
block_launches_f32 = 0  # f32 calls that launched K5 (csrc/attention_f32.cu's block entry) since the last reset
flash_launches = 0  # bf16 kernel launches of flash_attention (K6) since the last reset
flash_launches_f32 = 0  # f32 kernel launches of flash_attention (K6, csrc/attention_f32.cu) since the last reset
BLOCK_HEAD_DIMS = (64, 128, 192)


def pad_head_dim(d: int) -> int:
    """Head dim the packed kernel takes (40 -> 64, 80 -> 128, 160 -> 192)."""
    return max(64, ((d + 63) // 64) * 64)


def _packed_block_q(lq: int) -> int:
    """The q-block the JAX packed and block kernels run with (the JAX
    function of this name without its environment override)."""
    block_q = 256 if lq > 1024 else 512
    for cand in (min(block_q, lq), 256, 128):
        if cand <= lq and lq % cand == 0:
            return cand
    return lq


def packed_kernel_takes(l: int, dp: int, dtype) -> bool:
    """The packed kernels' contract on the token count L, the padded head
    dim and the dtype: bf16 at d_pad 64/128/192 with L % 128 == 0 (the
    wgmma blocks' 128 or 256 query rows); f32 there with L % 64 == 0 (the
    FFMA core's 64-row query tiles and 64-key tiles: an f32 UNet); or bf16
    and f32 at the VAE's d_pad 512 with L % 64 == 0 (both d 512 kernels'
    64-row query tiles; the f32 kernel runs an f32 VAE's head).  It takes
    every L that `packed_flash_eligible` admits at these head dims."""
    if l <= 0:
        return False
    if dp == 512 or (dtype == torch.float32 and dp in FLASH_HEAD_DIMS):
        return dtype in (torch.bfloat16, torch.float32) and l % 64 == 0
    return dtype == torch.bfloat16 and dp in FLASH_HEAD_DIMS and l % 128 == 0


def packed_flash_eligible(lq: int, lk: int, heads: int, d: int, itemsize: int = 2) -> bool:
    """Copy of the JAX predicate for the packed kernel (without its backend
    check): long self-attention whose K/V, scores and probabilities for one
    q-block fit 48 MiB of VMEM.  itemsize: activation bytes (bf16 2, f32 4).
    With 8 heads at d_pad 64 in bf16 the guard fails past 13,897 tokens."""
    if not (lq >= 256 and lk >= 256 and lq == lk and lq % 128 == 0):
        return False
    hd = heads * pad_head_dim(d)
    bq = _packed_block_q(lq)
    vmem = itemsize * (2 * lk * hd) + bq * lk * 4 + bq * lk * itemsize + 4 * bq * hd
    return vmem <= 48 * 1024 * 1024


def flash_block_q(lq: int) -> int:
    """The q-block of the JAX flash_attention (without its env override)."""
    return min(512, lq) if lq % min(512, lq) == 0 else lq


def flash_block_kv(lk: int) -> int:
    """The K/V chunk of the JAX flash_attention (without its env override)."""
    return 512 if lk % 512 == 0 else (256 if lk % 256 == 0 else lk)


def flash_kernel_ok(lq: int, lk: int, d: int) -> bool:
    """Copy of JAX's `_kernel_ok` (without its backend check): long
    attention whose resident K/V and one q-block's scores fit 12 MiB."""
    if not (lq >= 256 and lk >= 256 and lq % 128 == 0):
        return False
    d_pad = pad_head_dim(d)
    bq, bkv = flash_block_q(lq), flash_block_kv(lk)
    return 4 * (2 * lk * d_pad + 3 * bq * d_pad + bq * bkv) <= 12 * 1024 * 1024


def flash_attention_route(lq: int, lk: int, d: int) -> bool:
    """Whether `attention()` runs K6 on a shape K1 does not take.

    The JAX package takes K6 where `_kernel_ok` admits the shape and XLA
    elsewhere.  Past both guards XLA materialises the (B*H, L, L) f32
    scores: about 189 GB at a capped 960x1280 bucket (L = 19,200, where
    L % 512 != 0 makes block_q = L and `_kernel_ok` fail).  So the port also
    sends there every self-attention over >= 256 tokens that the kernel
    takes to K6: the same function, streamed.  The kernel takes L % 64 == 0
    and head dims that are multiples of 8 padding to at most 192; the VAE's
    one 512-wide head past the packed guard stays on the plain path, as in
    JAX."""
    if lq % 64 or lk % 64 or d % 8 or pad_head_dim(d) not in FLASH_HEAD_DIMS:
        return False
    return flash_kernel_ok(lq, lk, d) or (lq == lk and lq >= 256)


def fold_scale(x, scale: float):
    """x * scale with the scale rounded to x's dtype first, as JAX folds a
    Python float (weakly typed) into an array: bf16(x * bf16(scale)) in bf16.
    The scalar is a CPU tensor, so a CUDA x needs no host-to-device copy."""
    return x * torch.tensor(scale, dtype=x.dtype)


def plain_attention(q, k, v, scale: float):
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D) -> (B, Lq, H, D): f32 logits and
    softmax, probabilities cast to v's dtype, product in v's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q, k, v, num_heads: int, use_kernels: bool = True):
    """Packed (B, L, H*D) inputs -> (B, Lq, H*D), routed as the JAX
    package's `attention()`: K1 where the heads are already lane-aligned and
    the packed kernel admits the shape, K6 where `flash_attention_route`
    admits it, the plain path otherwise.  use_kernels=False is JAX's
    use_pallas=False: the plain path at every shape (the CLIP towers)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    scale = 1.0 / math.sqrt(d)
    if use_kernels and d == pad_head_dim(d) and packed_flash_eligible(lq, lk, num_heads, d, q.element_size()):
        return flash_attention_packed(fold_scale(q, scale * LOG2E), k, v, num_heads).to(q.dtype)
    qh = q.reshape(b, lq, num_heads, d)
    kh = k.reshape(b, lk, num_heads, d)
    vh = v.reshape(b, lk, num_heads, d)
    if use_kernels and flash_attention_route(lq, lk, d):
        out = flash_attention(qh, kh, vh, scale)
    else:
        out = plain_attention(fold_scale(qh, scale), kh, vh, 1.0)
    return out.to(q.dtype).reshape(b, lq, hd)


def flash_attention_plain(q, k, v, scale: float):
    """Plain version of K6, step by step the TPU kernel `_flash_kernel` as
    `flash_attention` drives it: q * scale rounded to q's dtype; heads
    padded to pad_head_dim(d); K/V in block_kv chunks with a running f32
    (max, denom, acc) and base-e exp; P cast to v's dtype before P.V;
    acc / l in q's dtype.  q: (B, Lq, H, D), k/v: (B, Lk, H, D) -> (B, Lq,
    H, D).  (batch, head) rows are independent, so they run in groups that
    keep one chunk's f32 scores within PLAIN_SCORE_BYTES."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dp = pad_head_dim(d)
    qs = fold_scale(q, scale)

    def heads(x, n):
        return F.pad(x.transpose(1, 2).reshape(b * h, n, d), (0, dp - d))

    qf, kf, vf = heads(qs, lq), heads(k, lk), heads(v, lk)
    bkv = flash_block_kv(lk)
    out = torch.empty((b * h, lq, dp), dtype=q.dtype, device=q.device)
    group = max(1, PLAIN_SCORE_BYTES // (4 * lq * bkv))
    for lo in range(0, b * h, group):
        rows = slice(lo, lo + group)
        qg = qf[rows].float()
        n = qg.shape[0]
        m = torch.full((n, lq, 1), -math.inf, device=q.device)
        den = torch.zeros((n, lq, 1), device=q.device)
        acc = torch.zeros((n, lq, dp), device=q.device)
        for i in range(lk // bkv):
            keys = slice(i * bkv, (i + 1) * bkv)
            s = qg @ kf[rows, keys].float().transpose(1, 2)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            del s
            den = den * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vf[rows, keys].float()
            m = m_new
        out[rows] = (acc / den).to(q.dtype)
    return out[..., :d].reshape(b, h, lq, d).transpose(1, 2)


def flash_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v over unpadded heads: q (B, Lq, H, D), k/v
    (B, Lk, H, D) -> (B, Lq, H, D).  CPU tensors run the plain version;
    CUDA tensors launch K6 (bf16: csrc/flash_attention.cu; f32:
    csrc/attention_f32.cu at the real head dim, counted in
    flash_launches_f32; contiguous and 16-byte aligned, Lq and Lk multiples
    of 64, D a multiple of 8 that pads to 64/128/192) or raise."""
    global flash_launches, flash_launches_f32
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dp = pad_head_dim(d)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 on CUDA, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if lq % 64 or lk % 64 or d % 8 or dp not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel takes L % 64 == 0 and a head dim (a multiple of 8) padding to one of "
                         f"{FLASH_HEAD_DIMS}; got Lq {lq}, Lk {lk}, d {d}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous, 16-byte aligned q, k, v on one device")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_q = float(torch.tensor(scale, dtype=q.dtype))  # in q's dtype, as the plain version folds it
    if q.dtype == torch.float32:
        fn = _build.kernel("attention_f32", "saspa_flash_attention_f32")
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, h, d, scale_q, stream),
                     "flash_attention_f32")
        flash_launches_f32 += 1
        return out
    fn = _build.kernel("flash_attention")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, h, d, dp, scale_q, stream),
                 "flash_attention")
    flash_launches += 1
    return out


def real_head_dim(head_dim, dp: int) -> int:
    """The real head dim a packed wrapper is told (head_dim; None: the padded
    width dp): a multiple of 4 (16 bytes in f32) within dp.  The columns past
    it are zero by contract (the padded projections' zero rows)."""
    d = dp if head_dim is None else int(head_dim)
    if not (0 < d <= dp and d % 4 == 0):
        raise ValueError(f"head_dim {head_dim}: a multiple of 4 within the padded head width {dp}")
    return d


def flash_attention_packed_plain(q, k, v, heads: int, head_dim: int | None = None):
    """Plain version of K1 (same function, f32 scores and accumulation):
    q pre-scaled by scale*log2(e); exp2 softmax; P cast to v's dtype before
    the P.V product (a no-op in f32); output in q's dtype.  Loops over heads
    to bound the (B, L, L) f32 score memory.  head_dim (the real head dim)
    changes nothing: the columns past it are zero, and it computes on all of
    them as before."""
    b, lq, hd = q.shape
    dp = hd // heads
    real_head_dim(head_dim, dp)
    out = torch.empty_like(q)
    for h in range(heads):
        sl = slice(h * dp, (h + 1) * dp)
        s = q[:, :, sl].float() @ k[:, :, sl].float().transpose(1, 2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        acc = p.to(v.dtype).float() @ v[:, :, sl].float()
        out[:, :, sl] = (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return out


def flash_attention_packed(q, k, v, heads: int, head_dim: int | None = None):
    """q: (B, L, H*D_pad) with softmax_scale*log2(e) folded in; k, v: (B, L,
    H*D_pad).  Returns (B, L, H*D_pad); padded output columns are exactly 0.
    head_dim: the real head dim d <= D_pad (default D_pad), the columns past
    it zero in q, k and v.  CPU tensors run the plain version; CUDA tensors
    launch a kernel or raise: q, k, v contiguous and 16-byte aligned, of the
    L, head dim and dtype `packed_kernel_takes` admits (bf16:
    csrc/attention_packed.cu; f32 at d_pad 512: csrc/attention_packed_f32.cu,
    counted in launches_f32; f32 at 64/128/192: csrc/attention_f32.cu, which
    computes on the real d columns, counted in launches_f32_heads)."""
    global launches, launches_f32, launches_f32_heads
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, heads, head_dim)
    b, l, hd = q.shape
    dp = hd // heads
    d = real_head_dim(head_dim, dp)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_packed takes bf16 or f32 on CUDA, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or hd != heads * dp:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} heads {heads}")
    if not (all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)) and q.device == k.device == v.device):
        raise ValueError("flash_attention_packed needs contiguous, 16-byte aligned q, k, v on one device")
    if not packed_kernel_takes(l, dp, q.dtype):
        raise ValueError(f"the packed kernels take bf16 at head dim 64/128/192 with L % 128 == 0, or f32 there and "
                         f"bf16 and f32 at 512 with L % 64 == 0; got {q.dtype}, head dim {dp}, L {l}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32 and dp != 512:
        fn = _build.kernel("attention_f32")
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, heads, dp, d, stream),
                     "attention_f32")
        launches_f32_heads += 1
        return out
    if q.dtype == torch.float32:
        fn = _build.kernel("attention_packed_f32")
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, heads, stream),
                     "attention_packed_f32")
        launches_f32 += 1
        return out
    fn = _build.kernel("attention_packed")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, heads, dp, stream),
                 "attention_packed")
    launches += 1
    return out


def attention_block_eligible(lq: int, lk: int, heads: int, d: int, c: int, itemsize: int = 2) -> bool:
    """Copy of the JAX megakernel predicate (`attention_block_eligible`):
    packed-eligible self-attention whose full-row activations, K/V scratch
    and weights fit 80 MiB of VMEM.  itemsize: activation bytes."""
    if not packed_flash_eligible(lq, lk, heads, d, itemsize):
        return False
    a = itemsize
    hd = heads * pad_head_dim(d)
    bq = _packed_block_q(lq)
    vmem = (a * lq * c + 2 * a * lq * hd + a * 4 * c * hd + 2 * a * bq * c
            + bq * lq * 4 + bq * lq * a + 4 * bq * hd + 4 * bq * c)
    return vmem <= 80 * 1024 * 1024


def attention_block_takes(l: int, c: int, heads: int, dp: int, dtype) -> bool:
    """K5's contract on the token count L, the width C, the heads, the
    padded head dim and the dtype: d_pad 64/128/192 and C % 64 == 0 (the
    products' 64-column tiles; H*D_pad is then a multiple of 64, which both
    products take: SD2.1's 5 heads of 64 give 320); bf16 with L % 128 == 0
    (K1's wgmma attention blocks) or f32 with L % 64 == 0 (the FFMA core's
    64-row tiles).  It takes every self-attention site that
    `attention_block_eligible` admits in the UNet configs."""
    if l <= 0 or c <= 0 or heads <= 0 or dp not in BLOCK_HEAD_DIMS or c % 64:
        return False
    return (dtype == torch.bfloat16 and l % 128 == 0) or (dtype == torch.float32 and l % 64 == 0)


def attention_block_fused_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int, head_dim: int | None = None):
    """Plain version of K5 (products in f32): Q/K/V rounded to x_ln's dtype,
    K1's plain attention, then packed . wo^T + bo + residual in f32, rounded
    to x_ln's dtype.  head_dim as in flash_attention_packed_plain: it
    changes nothing."""
    real_head_dim(head_dim, wq_scaled.shape[0] // heads)
    d = x_ln.dtype
    xf = x_ln.float()
    q, k, v = ((xf @ w.float().t()).to(d) for w in (wq_scaled, wk, wv))
    packed = flash_attention_packed_plain(q, k, v, heads)
    return (packed.float() @ wo.float().t() + bo.float() + residual.float()).to(d)


def attention_block_stages_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int,
                                 head_dim: int | None = None):
    """The plain mirror of K5's three kernels on the card: (q, k, v, packed,
    out).  The QKV projection rounds each f32 product to x_ln's dtype; the
    attention is K1's (`flash_attention_packed_plain`); the out projection
    adds bo and the residual to the f32 product and rounds once.  head_dim:
    as in attention_block_fused_plain."""
    real_head_dim(head_dim, wq_scaled.shape[0] // heads)
    d = x_ln.dtype
    xf = x_ln.float()
    q = (xf @ wq_scaled.float().t()).to(d)
    k = (xf @ wk.float().t()).to(d)
    v = (xf @ wv.float().t()).to(d)
    packed = flash_attention_packed_plain(q, k, v, heads)
    out = packed.float() @ wo.float().t()
    return q, k, v, packed, (out + bo.float() + residual.float()).to(d)


def attention_block_stages(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int, head_dim: int | None = None):
    """(q, k, v, packed, out) of K5's three kernels: q, k, v and packed are
    (B, L, H*D_pad), out like x_ln; head_dim: the real head dim (default
    D_pad), the weights' rows past it zero in each head.  CPU tensors run
    the plain stages; CUDA tensors launch the kernels or raise: bf16
    activations and weights (csrc/attention_block.cu) or f32 ones
    (csrc/attention_f32.cu's block entry, whose attention computes on the
    real d columns, counted in block_launches_f32), an f32 bo, of the L, C,
    head dim and dtype `attention_block_takes` admits, contiguous and
    16-byte aligned (TMA, 16-byte loads)."""
    global block_launches, block_launches_f32
    if x_ln.device.type == "cpu":
        return attention_block_stages_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads, head_dim)
    b, l, c = x_ln.shape
    hd = wq_scaled.shape[0]
    dp = hd // heads
    d = real_head_dim(head_dim, dp)
    dt = x_ln.dtype
    if dt not in (torch.bfloat16, torch.float32) or any(t.dtype != dt for t in (residual, wq_scaled, wk, wv, wo)) \
            or bo.dtype != torch.float32:
        raise TypeError("attention_block_fused on CUDA takes bf16 or f32 activations and weights of one dtype and "
                        "an f32 bo")
    if residual.shape != x_ln.shape or any(w.shape != (hd, c) for w in (wq_scaled, wk, wv)) \
            or wo.shape != (c, hd) or bo.shape != (c,) or hd != heads * dp:
        raise ValueError(f"attention_block_fused shapes: x {tuple(x_ln.shape)} wq {tuple(wq_scaled.shape)} "
                         f"wo {tuple(wo.shape)} heads {heads}")
    if not attention_block_takes(l, c, heads, dp, dt):
        raise ValueError(f"block kernel takes head dim in {BLOCK_HEAD_DIMS}, C % 64 == 0 and L % 128 == 0 in bf16 "
                         f"or L % 64 == 0 in f32; got {dp}, {c}, {l}, {dt}")
    ts = (x_ln, residual, wq_scaled, wk, wv, wo, bo)
    if not all(t.is_contiguous() and t.device == x_ln.device and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("attention_block_fused needs contiguous, 16-byte aligned inputs on one device")
    ws = torch.empty((4, b, l, hd), dtype=dt, device=x_ln.device)  # Q, K, V, packed
    out = torch.empty_like(x_ln)
    stream = torch.cuda.current_stream(x_ln.device).cuda_stream
    ptrs = (x_ln.data_ptr(), residual.data_ptr(), wq_scaled.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), ws.data_ptr(), out.data_ptr())
    if dt == torch.float32:
        fn = _build.kernel("attention_f32", "saspa_attention_block_f32")
        _build.check(fn(*ptrs, b, l, c, heads, dp, d, stream), "attention_block_f32")
        block_launches_f32 += 1
    else:
        _build.check(_build.kernel("attention_block")(*ptrs, b, l, c, heads, dp, stream), "attention_block")
        block_launches += 1
    return ws[0], ws[1], ws[2], ws[3], out


def attention_block_fused(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int, head_dim: int | None = None):
    """residual + to_out(self_attention(x_ln)).  x_ln, residual: (B, L, C);
    wq_scaled, wk, wv: (H*D_pad, C) head-padded, softmax_scale*log2(e) folded
    into wq; wo: (C, H*D_pad); bo: (C,) f32; head_dim: the real head dim
    (default D_pad).  CPU tensors run the plain version; CUDA tensors launch
    K5 (see attention_block_stages) or raise."""
    if x_ln.device.type == "cpu":
        return attention_block_fused_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads, head_dim)
    return attention_block_stages(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads, head_dim)[4]
