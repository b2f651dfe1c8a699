"""The real head dim through the f32 attention core's wrappers, on the CPU.

The f32 core (csrc/attention_f32.cu) computes a head on its real width d
when the wrapper is told it: `flash_attention_packed(..., head_dim=d)` (K1)
and `attention_block_fused` / `attention_block_stages(..., head_dim=d)` (K5)
on head-padded (B, L, H*D_pad) activations whose columns d .. D_pad are zero.
The UNet tells it (`CrossAttention.forward`).  The plain versions take the
keyword and compute as before, so on the CPU the output is bit-equal with
and without it; the f32 UNet's agreement with the JAX package stays held by
tests/test_torch_f32_unet.py (`run_generation` through both packages, in the
default configuration and under SASPA_ATTN_MEGAKERNEL=1).
"""

import math

import numpy as np
import pytest
import torch

from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops.switches import KernelSwitches

# a tiny SD1.5-shaped UNet: level 0 at 16x16 latents is 256 tokens of 32
# channels in 2 heads of d 16 (padded to 64), which the packed route admits
TINY = t_unet.UNetConfig(block_out_channels=(32, 64), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                         up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                         transformer_layers_per_block=(1, 1), num_attention_heads=(2, 2), cross_attention_dim=16)


def _seeded_unet(megakernel: bool):
    unet = t_unet.UNet2DCondition(TINY, dtype=torch.float32, device="cpu",
                                  switches=KernelSwitches(attention_megakernel=megakernel))
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return unet


@pytest.mark.parametrize("megakernel", [False, True])
def test_f32_unet_passes_the_real_head_dim(megakernel, monkeypatch):
    """Every packed self-attention of an f32 UNet tells K1 (default route)
    or K5 (SASPA_ATTN_MEGAKERNEL=1) the real head dim 16 of its heads padded
    to 64; the UNet's output is bit-equal to a run whose wrappers are told
    nothing (the padded width), since the plain versions compute the same."""
    unet = _seeded_unet(megakernel)
    rng = np.random.RandomState(3)
    sample = torch.from_numpy(rng.randn(2, 4, 16, 16).astype(np.float32))
    context = torch.from_numpy(rng.randn(2, 77, 16).astype(np.float32))
    name = "attention_block_fused" if megakernel else "flash_attention_packed"
    real = getattr(t_unet, name)
    told = []

    def recorded(*args, **kwargs):
        told.append(kwargs.get("head_dim"))
        return real(*args, **kwargs)

    monkeypatch.setattr(t_unet, name, recorded)
    with torch.no_grad():
        got = unet(sample, torch.tensor([500, 500]), context)
    # level 0: the down block's one transformer and the up block's two (the mid block's 64 tokens run plain)
    assert told == [16, 16, 16], told

    def untold(*args, head_dim=None):
        return real(*args)

    monkeypatch.setattr(t_unet, name, untold)
    with torch.no_grad():
        want = unet(sample, torch.tensor([500, 500]), context)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want)


def _packed(rng, b, l, h, d, dp, std=1.0):
    x = np.pad(std * rng.randn(b, l, h, d), ((0, 0), (0, 0), (0, 0), (0, dp - d)))
    return torch.from_numpy(x.reshape(b, l, h * dp).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 80, 160, 64, 120, 24])
def test_plain_k1_bit_equal_with_the_real_head_dim(d, dtype):
    """K1's plain version (the wrapper on CPU tensors, and the plain function
    itself) with head_dim=d against without it, at the core's real widths
    (40, 80, 160, 64) and two that run at the next width up (120, 24): the
    same tensor bit for bit, padded columns exactly 0."""
    b, l, h = 1, 256, 2
    dp = tatt.pad_head_dim(d)
    rng = np.random.RandomState(d)
    q = (_packed(rng, b, l, h, d, dp, 3.0) * (tatt.LOG2E / math.sqrt(d))).to(dtype)
    k, v = (_packed(rng, b, l, h, d, dp).to(dtype) for _ in range(2))
    want = tatt.flash_attention_packed(q, k, v, h)
    for got in (tatt.flash_attention_packed(q, k, v, h, head_dim=d),
                tatt.flash_attention_packed_plain(q, k, v, h, head_dim=d)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert (want.reshape(b, l, h, dp)[..., d:] == 0).all()


def _block_args(rng, b, l, c, h, dtype):
    d = c // h
    dp = tatt.pad_head_dim(d)

    def rn(*shape, std=1.0):
        return torch.from_numpy((std * rng.randn(*shape)).astype(np.float32))

    def rows(w):
        return torch.nn.functional.pad(w.reshape(h, d, c), (0, 0, 0, dp - d)).reshape(h * dp, c)

    wq = rows(rn(c, c, std=3.0 * c ** -0.5)) * (tatt.LOG2E / math.sqrt(d))
    wk, wv = rows(rn(c, c, std=c ** -0.5)), rows(rn(c, c, std=c ** -0.5))
    wo = torch.nn.functional.pad(rn(c, c, std=c ** -0.5).reshape(c, h, d), (0, dp - d)).reshape(c, h * dp)
    ws = [t.to(dtype).contiguous() for t in (rn(b, l, c), rn(b, l, c, std=0.05), wq, wk, wv, wo)]
    return (*ws, rn(c, std=0.05), h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", [(320, 8), (640, 8), (1280, 8), (320, 5)])
def test_plain_k5_bit_equal_with_the_real_head_dim(c, h, dtype):
    """K5's plain versions (attention_block_fused and attention_block_stages
    on CPU tensors, and their plain functions) with head_dim = C/H (SD1.5's
    40, 80, 160; SD2.1's 64) against without it: every stage bit for bit."""
    args = _block_args(np.random.RandomState(c + h), 1, 256, c, h, dtype)
    d = c // h
    want = tatt.attention_block_stages(*args)
    for got in (tatt.attention_block_stages(*args, head_dim=d), tatt.attention_block_stages_plain(*args, head_dim=d)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for out in (tatt.attention_block_fused(*args, head_dim=d), tatt.attention_block_fused_plain(*args, head_dim=d)):
        assert torch.equal(out, tatt.attention_block_fused(*args))


@pytest.mark.parametrize("head_dim", [0, 66, 72, -8])
def test_head_dim_outside_the_padded_width_is_refused(head_dim):
    """The real head dim is a multiple of 4 within the padded width (64
    here): the wrappers refuse anything else, on the CPU as on the card."""
    rng = np.random.RandomState(0)
    q, k, v = (_packed(rng, 1, 256, 2, 40, 64) for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_attention_packed(q, k, v, 2, head_dim=head_dim)
    args = _block_args(rng, 1, 256, 128, 2, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.attention_block_fused(*args, head_dim=head_dim)
