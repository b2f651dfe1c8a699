"""The port's streamed flash attention (K6) and its attention routing against
the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX
kernel runs in interpret mode (`pltpu.force_tpu_interpret_mode()`, as
tests/test_attention.py runs it); the port's wrapper runs its plain version
on CPU tensors.  The JAX routing predicates answer only on a TPU backend, so
the routing tests answer `jax.default_backend()` with "tpu".
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.models import unet as junet
from saspa_tpu.ops import attention as jatt
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.ops import attention as tatt


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = (3.0 * rng.randn(b, lq, h, d)).astype(np.float32)  # peaked softmax rows
    return q, rng.randn(b, lk, h, d).astype(np.float32), rng.randn(b, lk, h, d).astype(np.float32)


@pytest.mark.parametrize("b,lq,lk,h,d", [
    (2, 256, 256, 2, 40),    # d 40 -> 64, one K/V chunk
    (1, 256, 1024, 2, 40),   # two block_kv = 512 chunks
    (1, 384, 768, 2, 80),    # lk % 512 != 0: three 256-key chunks; d 80 -> 128
    (1, 320, 320, 1, 16),    # lk % 256 != 0: one chunk of lk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_interpret(b, lq, lk, h, d, dtype):
    """f32: to 1e-5 absolute (f32 product order).  bf16: q * scale, P and the
    output are rounded at the same points; to 1% of the largest output."""
    q, k, v = _qkv(b, lq, lk, h, d, seed=lq + lk + d)
    scale = 1.0 / math.sqrt(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jatt.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale).astype(jnp.float32))
    got = tatt.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale)
    assert got.dtype == tdt and got.shape == (b, lq, h, d)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# (what, L, heads, d): SD1.5's UNet/ControlNet levels at 512^2, 1024^2 and a
# capped 960x1280 bucket, and the VAE's one 512-wide head
SITES = [
    ("512 level 0", 4096, 8, 40), ("512 level 1", 1024, 8, 80), ("512 level 2", 256, 8, 160),
    ("512 mid", 64, 8, 160),
    ("1024 level 0", 16384, 8, 40), ("1024 level 1", 4096, 8, 80), ("1024 level 2", 1024, 8, 160),
    ("1024 mid", 256, 8, 160),
    ("960x1280 level 0", 19200, 8, 40), ("960x1280 level 1", 4800, 8, 80), ("960x1280 level 2", 1200, 8, 160),
    ("960x1280 mid", 300, 8, 160),
    ("vae 512", 4096, 1, 512), ("vae 1024", 16384, 1, 512), ("vae 960x1280", 19200, 1, 512),
]


def _jax_route(lq, lk, heads, d, jdt):
    """Where the JAX package runs a self-attention: the UNet's CrossAttention
    takes the packed kernel when packed_flash_eligible admits the shape,
    then attention() routes (the VAE calls attention() directly)."""
    if jatt.packed_flash_eligible(lq, lk, heads, d, jdt):
        return "packed"
    s = jax.ShapeDtypeStruct((1, lq, heads, d), jdt)
    return "flash" if jatt._kernel_ok(s, jax.ShapeDtypeStruct((1, lk, heads, d), jdt)) else "plain"


def _port_route(lq, lk, heads, d, itemsize):
    if tatt.packed_flash_eligible(lq, lk, heads, d, itemsize):
        return "packed"
    return "flash" if tatt.flash_attention_route(lq, lk, d) else "plain"


def test_routing_predicates_match_jax(monkeypatch):
    """The port's copies of packed_flash_eligible and _kernel_ok equal JAX's
    at every site, bf16 and f32, and the routes agree except where the port
    decided otherwise (ROADMAP Queue 3 (f)): the capped bucket's level 0 and
    level 1 self-attentions, past both JAX guards, take K6 where JAX takes
    XLA's full-score path.  SD1.5's level 0 at 1024^2 takes K6 in both."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for k in ("SASPA_DISABLE_PALLAS", "SASPA_PACKED_BLOCK_Q", "SASPA_ATTN_BLOCK_Q", "SASPA_ATTN_BLOCK_KV"):
        monkeypatch.delenv(k, raising=False)
    deviations = []
    for itemsize, jdt in ((2, jnp.bfloat16), (4, jnp.float32)):
        for what, l, heads, d in SITES:
            for lk in (l, 77):
                assert tatt.packed_flash_eligible(l, lk, heads, d, itemsize) == \
                    jatt.packed_flash_eligible(l, lk, heads, d, jdt), (what, lk, itemsize)
                s = jax.ShapeDtypeStruct((1, l, heads, d), jdt)
                assert tatt.flash_kernel_ok(l, lk, d) == jatt._kernel_ok(s, jax.ShapeDtypeStruct((1, lk, heads, d), jdt))
                want, got = _jax_route(l, lk, heads, d, jdt), _port_route(l, lk, heads, d, itemsize)
                if got != want:
                    deviations.append((what, lk, itemsize, want, got))
    assert deviations == [(w, l, i, "plain", "flash") for i in (2, 4) for w, l in
                          (("960x1280 level 0", 19200), ("960x1280 level 1", 4800))]
    assert _port_route(16384, 16384, 8, 40, 2) == _jax_route(16384, 16384, 8, 40, jnp.bfloat16) == "flash"
    assert _port_route(4096, 4096, 8, 40, 2) == "packed" and _port_route(16384, 16384, 1, 512, 2) == "plain"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_on_the_k6_route_matches_jax(dtype, monkeypatch):
    """A UNet self-attention (B2 L256 C64, 2 heads of 32, with a residual) on
    the K6 route in both packages: their packed predicates answer False
    (as past the 48 MiB guard), JAX's _kernel_ok True; JAX's kernel runs in
    interpret mode.  Unpadded projections, then K6, then to_out.  f32 to
    1e-5 of the largest output; bf16 to 1% of it."""
    b, l, c, heads = 2, 256, 64, 2
    rng = np.random.RandomState(5)
    x = rng.randn(b, l, c).astype(np.float32)
    res = rng.randn(b, l, c).astype(np.float32)
    w = {n: (rng.randn(c, c) * (3.0 if n == "to_q" else 1.0) / math.sqrt(c)).astype(np.float32)
         for n in ("to_q", "to_k", "to_v", "to_out")}
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    flax_params = {n: {"kernel": jnp.asarray(w[n])} for n in w}
    flax_params["to_out"]["bias"] = jnp.asarray(bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    monkeypatch.setattr(jatt, "packed_flash_eligible", lambda *a, **k: False)
    monkeypatch.setattr(jatt, "_kernel_ok", lambda *a, **k: True)
    with pltpu.force_tpu_interpret_mode():
        want = junet.CrossAttention(num_heads=heads, dtype=jdt).apply(
            {"params": flax_params}, jnp.asarray(x, jdt), residual=jnp.asarray(res, jdt))
    want = np.asarray(want.astype(jnp.float32))

    calls = []
    monkeypatch.setattr(t_unet, "packed_flash_eligible", lambda *a, **k: False)
    monkeypatch.setattr(tatt, "flash_attention", lambda *a: calls.append(a[0].shape) or tatt.flash_attention_plain(*a))
    attn = t_unet.CrossAttention(c, c, heads, tdt, "cpu")
    with torch.no_grad():
        for n in ("to_q", "to_k", "to_v", "to_out"):
            getattr(attn, n).kernel.copy_(torch.from_numpy(w[n].T.copy()))
        attn.to_out.bias.copy_(torch.from_numpy(bias))
        got = attn(torch.from_numpy(x).to(tdt), residual=torch.from_numpy(res).to(tdt))
    assert calls == [(b, l, heads, c // heads)]
    got = got.float().numpy()
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)
