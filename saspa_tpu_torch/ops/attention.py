"""Multi-head attention: the packed-heads kernel (K1), the self-attention
block kernel (K5) and the plain path.

Counterpart of saspa_tpu/ops/attention.py.  Self-attention over image tokens
(lq == lk >= 256, lq % 128 == 0) runs `flash_attention_packed` on packed
(B, L, H*D_pad) tensors whose head dims are zero-padded in the projection
weights (64/128/192 for SD1.5's 40/80/160; the VAE's 512 as is).  Short-kv
cross-attention (77 text tokens) and the text tower take `plain_attention`,
the counterpart of the JAX package's `_xla_attention`.  With the
megakernel option, each transformer block's self-attention that
`attention_block_eligible` admits runs `attention_block_fused` instead: the
Q/K/V projections, the attention, to_out, its bias and the residual add
behind one wrapper.
"""

from __future__ import annotations

import math

import torch

from saspa_tpu_torch.ops import _build

LOG2E = math.log2(math.e)
PACKED_HEAD_DIMS = (64, 128, 192, 512)

launches = 0  # kernel launches of flash_attention_packed since the last reset
block_launches = 0  # calls of attention_block_fused that launched K5 since the last reset
BLOCK_HEAD_DIMS = (64, 128, 192)


def pad_head_dim(d: int) -> int:
    """Head dim the packed kernel takes (40 -> 64, 80 -> 128, 160 -> 192)."""
    return max(64, ((d + 63) // 64) * 64)


def packed_flash_eligible(lq: int, lk: int) -> bool:
    """Shape-only predicate for the packed kernel: long self-attention."""
    return lq == lk and lq >= 256 and lq % 128 == 0


def plain_attention(q, k, v, scale: float):
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D) -> (B, Lq, H, D): f32 logits and
    softmax, probabilities cast to v's dtype, product in v's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q, k, v, num_heads: int):
    """Packed (B, L, H*D) inputs -> (B, Lq, H*D) through the plain path."""
    b, lq, hd = q.shape
    d = hd // num_heads
    qh = q.reshape(b, lq, num_heads, d)
    kh = k.reshape(b, k.shape[1], num_heads, d)
    vh = v.reshape(b, v.shape[1], num_heads, d)
    out = plain_attention(qh * (1.0 / math.sqrt(d)), kh, vh, 1.0)
    return out.to(q.dtype).reshape(b, lq, hd)


def flash_attention_packed_plain(q, k, v, heads: int):
    """Plain version of K1 (same function, f32 scores and accumulation):
    q pre-scaled by scale*log2(e); exp2 softmax; P cast to v's dtype before
    the P.V product; output in q's dtype.  Loops over heads to bound the
    (B, L, L) f32 score memory."""
    b, lq, hd = q.shape
    dp = hd // heads
    out = torch.empty_like(q)
    for h in range(heads):
        sl = slice(h * dp, (h + 1) * dp)
        s = q[:, :, sl].float() @ k[:, :, sl].float().transpose(1, 2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        acc = p.to(v.dtype).float() @ v[:, :, sl].float()
        out[:, :, sl] = (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return out


def flash_attention_packed(q, k, v, heads: int):
    """q: (B, L, H*D_pad) with softmax_scale*log2(e) folded in; k, v: (B, L,
    H*D_pad).  Returns (B, L, H*D_pad); padded output columns are exactly 0.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, heads)
    b, l, hd = q.shape
    dp = hd // heads
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_packed takes bf16 on CUDA, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or hd != heads * dp:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} heads {heads}")
    if dp not in PACKED_HEAD_DIMS or l % 64:
        raise ValueError(f"packed kernel takes head dim in {PACKED_HEAD_DIMS} and L % 64 == 0, got {dp}, {l}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_packed needs contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    out = torch.empty_like(q)
    fn = _build.kernel("attention_packed")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, heads, dp, stream),
                 "attention_packed")
    launches += 1
    return out


def _packed_block_q(lq: int) -> int:
    """The q-block the JAX packed and block kernels run with (the JAX
    function of this name without its environment override)."""
    block_q = 256 if lq > 1024 else 512
    for cand in (min(block_q, lq), 256, 128):
        if cand <= lq and lq % cand == 0:
            return cand
    return lq


def attention_block_eligible(lq: int, lk: int, heads: int, d: int, c: int, itemsize: int = 2) -> bool:
    """Copy of the JAX megakernel predicate (`attention_block_eligible`,
    whose `packed_flash_eligible` call adds the packed kernel's 48 MiB VMEM
    guard): packed-eligible self-attention whose full-row activations, K/V
    scratch and weights fit 80 MiB of VMEM.  itemsize: activation bytes."""
    if not packed_flash_eligible(lq, lk):
        return False
    a = itemsize
    hd = heads * pad_head_dim(d)
    bq = _packed_block_q(lq)
    if a * 2 * lk * hd + bq * lk * 4 + bq * lk * a + 4 * bq * hd > 48 * 1024 * 1024:
        return False
    vmem = (a * lq * c + 2 * a * lq * hd + a * 4 * c * hd + 2 * a * bq * c
            + bq * lq * 4 + bq * lq * a + 4 * bq * hd + 4 * bq * c)
    return vmem <= 80 * 1024 * 1024


def attention_block_fused_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int):
    """Plain version of K5 (products in f32): Q/K/V rounded to x_ln's dtype,
    K1's plain attention, then packed . wo^T + bo + residual in f32, rounded
    to x_ln's dtype."""
    d = x_ln.dtype
    xf = x_ln.float()
    q, k, v = ((xf @ w.float().t()).to(d) for w in (wq_scaled, wk, wv))
    packed = flash_attention_packed_plain(q, k, v, heads)
    return (packed.float() @ wo.float().t() + bo.float() + residual.float()).to(d)


def attention_block_fused(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads: int):
    """residual + to_out(self_attention(x_ln)).  x_ln, residual: (B, L, C);
    wq_scaled, wk, wv: (H*D_pad, C) head-padded, softmax_scale*log2(e) folded
    into wq; wo: (C, H*D_pad); bo: (C,) f32.  CPU tensors run the plain
    version; CUDA tensors launch K5 (bf16, D_pad in {64, 128, 192}, L and C
    multiples of 64) or raise."""
    global block_launches
    if x_ln.device.type == "cpu":
        return attention_block_fused_plain(x_ln, residual, wq_scaled, wk, wv, wo, bo, heads)
    b, l, c = x_ln.shape
    hd = wq_scaled.shape[0]
    dp = hd // heads
    bf = torch.bfloat16
    if any(t.dtype != bf for t in (x_ln, residual, wq_scaled, wk, wv, wo)) or bo.dtype != torch.float32:
        raise TypeError("attention_block_fused on CUDA takes bf16 activations and weights and an f32 bo")
    if residual.shape != x_ln.shape or any(w.shape != (hd, c) for w in (wq_scaled, wk, wv)) \
            or wo.shape != (c, hd) or bo.shape != (c,) or hd != heads * dp:
        raise ValueError(f"attention_block_fused shapes: x {tuple(x_ln.shape)} wq {tuple(wq_scaled.shape)} "
                         f"wo {tuple(wo.shape)} heads {heads}")
    if dp not in BLOCK_HEAD_DIMS or l % 64 or c % 64:
        raise ValueError(f"block kernel takes head dim in {BLOCK_HEAD_DIMS}, L and C multiples of 64; "
                         f"got {dp}, {l}, {c}")
    ts = (x_ln, residual, wq_scaled, wk, wv, wo, bo)
    if not all(t.is_contiguous() and t.device == x_ln.device for t in ts):
        raise ValueError("attention_block_fused needs contiguous inputs on one device")
    kbuf, vbuf, packed = (torch.empty((b, l, hd), dtype=bf, device=x_ln.device) for _ in range(3))
    out = torch.empty_like(x_ln)
    fn = _build.kernel("attention_block")
    stream = torch.cuda.current_stream(x_ln.device).cuda_stream
    _build.check(fn(x_ln.data_ptr(), residual.data_ptr(), wq_scaled.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                    wo.data_ptr(), bo.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), packed.data_ptr(),
                    out.data_ptr(), b, l, c, heads, dp, stream), "attention_block")
    block_launches += 1
    return out
