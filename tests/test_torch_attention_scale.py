"""The attention scale folded into bf16 queries, on every attention route,
against the JAX package on the CPU.

JAX multiplies a bf16 array by the scale as a Python float, which is weakly
typed: the scale is rounded to bf16 before the multiply.  The port folds it
with a bf16 scalar (`ops.attention.fold_scale`).  Each test runs one module
in bf16 through both packages from the same numpy weights and inputs,
captures the scaled q (K5: the scaled wq) where it reaches the attention
function, and requires it bit-equal; then holds the module outputs together.
The JAX routing predicates answer only on a TPU backend, so the tests answer
`jax.default_backend()` with "tpu" and run the Pallas kernels in interpret
mode; the port's wrappers run their plain versions on CPU tensors.

The inputs make the projections exact: activations in {-1, 0, 1}, weights
in {-1, 0, 1} times a power of two (the VAE's GroupNorm sees groups of
balanced +-1, so its bf16 output is +-gamma), so every partial sum is exact
in f32 and both packages round the same exact sum to bf16.  The q reaching
the scale is then the same array in both, and the scaled q must be too.
K5 scales the q weights themselves, so there they are random bf16 values:
on ternary weights bf16(w * s) would equal w * bf16(s).

Output tolerance, in bf16: past the scaled q the two packages round P, each
head's output, the output projection and the residual add at the same
points, but sum inexact f32 terms in another order (the softmax, P.V, and
the output projection, which the port runs with its bias fused), which
flips bf16 roundings by an ulp.  So >= 60% of the output elements are
bit-equal (69-100% at these inputs) and every one is within 2^-7 (0.78%)
of the largest output, about an ulp of the largest magnitude (0.73% at
most at these inputs): tighter than the 1% of the other bf16 parity tests.
(Before the fold was fixed, 18-52% of the scaled q elements differed from
JAX's.)
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.models import unet as junet
from saspa_tpu.models import vae as jvae
from saspa_tpu.ops import attention as jatt
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.ops import attention as tatt

OUT_EQUAL = 0.6
OUT_TOL = 2.0 ** -7


def _recorder(fn, arg, into):
    """fn with its positional argument `arg` recorded (as f32 numpy) into `into`."""
    def wrapped(*args, **kwargs):
        x = args[arg]
        into.append(np.asarray(x.float()) if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32)))
        return fn(*args, **kwargs)
    return wrapped


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _check_outputs(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    diff, top = np.abs(got - want).max(), np.abs(want).max()
    assert np.mean(got == want) >= OUT_EQUAL, np.mean(got == want)
    assert diff <= OUT_TOL * top, (diff, top)


def _ternary(rng, *shape, scale=1.0):
    """Entries in {-1, 0, 1} * scale (scale a power of two)."""
    return (rng.randint(-1, 2, shape) * scale).astype(np.float32)


def _weight(rng, n_in, n_out, gain=1.0):
    """(n_in, n_out) ternary weights times the power of two nearest
    gain / sqrt(n_in): exact products and f32 sums on ternary inputs."""
    return _ternary(rng, n_in, n_out, scale=2.0 ** round(math.log2(gain / math.sqrt(n_in))))


def _attn_weights(c, ctx, seed):
    rng = np.random.RandomState(seed)
    # q four times the unit scale peaks the softmax rows on a few keys, so
    # the scale's rounding moves the output
    w = {"to_q": _weight(rng, c, c, 4.0), "to_k": _weight(rng, ctx, c), "to_v": _weight(rng, ctx, c),
         "to_out": _weight(rng, c, c)}
    return w, (0.1 * rng.randn(c)).astype(np.float32), rng


def _unet_attention(monkeypatch, route, heads, d, l, lk):
    """One UNet CrossAttention (B2, C = heads * d, a residual on self-attention)
    through both packages on `route`; returns (port out, JAX out, port q, JAX q)."""
    b, c = 2, heads * d
    ctx = c if lk == l else 48
    w, bias, rng = _attn_weights(c, ctx, seed=l + d)
    if route == "k5":  # K5 scales the weights: ternary ones would make bf16(w * s) == w * bf16(s)
        w["to_q"] = _bf16(rng.randn(c, c) * (4.0 / math.sqrt(c)))
    x = _ternary(rng, b, l, c)
    context = None if lk == l else _ternary(rng, b, lk, ctx)
    res = rng.randn(b, l, c).astype(np.float32) if lk == l else None
    flax_params = {n: {"kernel": jnp.asarray(w[n])} for n in w}
    flax_params["to_out"]["bias"] = jnp.asarray(bias)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for k in ("SASPA_DISABLE_PALLAS", "SASPA_PACKED_BLOCK_Q", "SASPA_ATTN_BLOCK_Q", "SASPA_ATTN_BLOCK_KV"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SASPA_ATTN_MEGAKERNEL", "1" if route == "k5" else "0")
    jq, tq = [], []
    if route == "k1":
        monkeypatch.setattr(jatt, "flash_attention_packed", _recorder(jatt.flash_attention_packed, 0, jq))
        monkeypatch.setattr(t_unet, "flash_attention_packed", _recorder(t_unet.flash_attention_packed, 0, tq))
    elif route == "k5":
        monkeypatch.setattr(jatt, "attention_block_fused", _recorder(jatt.attention_block_fused, 2, jq))
        monkeypatch.setattr(t_unet, "attention_block_fused", _recorder(t_unet.attention_block_fused, 2, tq))
    elif route == "k6":  # both packed predicates refuse (as past the 48 MiB guard), _kernel_ok admits
        monkeypatch.setattr(jatt, "packed_flash_eligible", lambda *a, **k: False)
        monkeypatch.setattr(jatt, "_kernel_ok", lambda *a, **k: True)
        monkeypatch.setattr(t_unet, "packed_flash_eligible", lambda *a, **k: False)
        monkeypatch.setattr(jatt, "_flash_attention_padded", _recorder(jatt._flash_attention_padded, 0, jq))
        fold = tatt.fold_scale  # the port's K6 scales q inside its wrapper: record what the fold returns
        monkeypatch.setattr(tatt, "fold_scale", lambda x, s: tq.append(fold(x, s).float().numpy()) or fold(x, s))
    else:  # the plain path: cross-attention over a short context
        monkeypatch.setattr(jatt, "_xla_attention", _recorder(jatt._xla_attention, 0, jq))
        monkeypatch.setattr(tatt, "plain_attention", _recorder(tatt.plain_attention, 0, tq))

    jdt = jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    kwargs = {"residual": jnp.asarray(res, jdt)} if res is not None else {"context": jnp.asarray(context, jdt)}
    with pltpu.force_tpu_interpret_mode():
        want = junet.CrossAttention(num_heads=heads, dtype=jdt).apply({"params": flax_params}, jx, **kwargs)
    attn = t_unet.CrossAttention(c, ctx, heads, torch.bfloat16, "cpu", megakernel=route == "k5")
    with torch.no_grad():
        for n in ("to_q", "to_k", "to_v", "to_out"):
            getattr(attn, n).kernel.copy_(torch.from_numpy(w[n].T.copy()))
        attn.to_out.bias.copy_(torch.from_numpy(bias))
        tx = torch.from_numpy(x).to(torch.bfloat16)
        if res is not None:
            got = attn(tx, residual=torch.from_numpy(res).to(torch.bfloat16))
        else:
            got = attn(tx, torch.from_numpy(context).to(torch.bfloat16))
    assert len(jq) == 1 and len(tq) == 1, (route, len(jq), len(tq))
    return got, want, tq[0], jq[0]


@pytest.mark.parametrize("heads,d", [(2, 40), (1, 80), (1, 160)])
@pytest.mark.parametrize("route", ["k1", "k5"])
def test_packed_routes_fold_the_scale_as_jax(route, heads, d, monkeypatch):
    """K1 (the scaled q) and K5 (the scaled wq, head-padded) at SD1.5's head
    dims 40/80/160 (padded 64/128/192), L = 256, both predicates admitting."""
    got, want, tq, jq = _unet_attention(monkeypatch, route, heads, d, 256, 256)
    if route == "k5":
        tq = tq.T  # the port keeps wq as (H * D_pad, C), JAX as (C, H * D_pad)
    assert tq.shape == jq.shape
    np.testing.assert_array_equal(tq, jq)
    _check_outputs(got, want)


def test_k6_route_folds_the_scale_as_jax(monkeypatch):
    """K6 (the unpadded heads, the route of SD1.5's level 0 at 1024^2): the
    scaled q against the one JAX pads and hands to its Pallas kernel."""
    b, l, heads, d = 2, 256, 2, 40
    got, want, tq, jq = _unet_attention(monkeypatch, "k6", heads, d, l, l)
    jq = jq.reshape(b, heads, l, -1)[..., :d].transpose(0, 2, 1, 3)  # (B*H, L, D_pad) -> (B, L, H, D)
    assert tq.shape == jq.shape
    np.testing.assert_array_equal(tq, jq)
    _check_outputs(got, want)


@pytest.mark.parametrize("d", [40, 160])
def test_cross_attention_plain_path_folds_the_scale_as_jax(d, monkeypatch):
    """attn2: 256 queries over 77 context tokens take the plain path (XLA's
    `_xla_attention` in JAX) in both packages."""
    got, want, tq, jq = _unet_attention(monkeypatch, "plain", 8 if d == 40 else 2, d, 256, 77)
    assert tq.shape == jq.shape
    np.testing.assert_array_equal(tq, jq)
    _check_outputs(got, want)


@pytest.mark.parametrize("c,side", [(64, 16), (96, 8)])
def test_vae_attention_block_folds_the_scale_as_jax(c, side, monkeypatch):
    """The VAE's one-head attention block (GroupNorm, q/k/v, attention,
    to_out, residual): at 16x16 its 256 tokens take K1 (C = 64), at 8x8
    the plain path (C = 96: the scale 1/8 of C = 64 would be exact in
    bf16).  The input is NHWC in JAX, NCHW in the port."""
    rng = np.random.RandomState(c + side)
    # each of the 32 groups holds as many +1 as -1: mean 0, variance 1, so
    # the normalized values are +-rstd, and +-gamma once rounded to bf16
    per_group = side * side * (c // 32)
    groups = [rng.permutation(np.repeat([1.0, -1.0], per_group // 2)) for _ in range(32)]
    x = np.stack(groups).reshape(32, side, side, c // 32).transpose(1, 2, 0, 3).reshape(1, side, side, c)
    x = x.astype(np.float32)
    w = {"to_q": _weight(rng, c, c, 4.0), "to_k": _weight(rng, c, c), "to_v": _weight(rng, c, c),
         "to_out": _weight(rng, c, c)}
    bias = {n: (0.5 * rng.randint(-1, 2, c)).astype(np.float32) for n in w}
    gn = {"scale": (0.5 * rng.randint(1, 5, c)).astype(np.float32), "bias": np.zeros(c, np.float32)}
    flax_params = {n: {"kernel": jnp.asarray(w[n]), "bias": jnp.asarray(bias[n])} for n in w}
    flax_params["group_norm"] = {"GroupNorm_0": {k: jnp.asarray(v) for k, v in gn.items()}}

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for k in ("SASPA_DISABLE_PALLAS", "SASPA_PACKED_BLOCK_Q", "SASPA_PALLAS_GN"):
        monkeypatch.delenv(k, raising=False)
    jq, tq = [], []
    if side * side >= 256:
        monkeypatch.setattr(jatt, "flash_attention_packed", _recorder(jatt.flash_attention_packed, 0, jq))
        monkeypatch.setattr(t_vae, "flash_attention_packed", _recorder(t_vae.flash_attention_packed, 0, tq))
    else:
        monkeypatch.setattr(jatt, "_xla_attention", _recorder(jatt._xla_attention, 0, jq))
        monkeypatch.setattr(tatt, "plain_attention", _recorder(tatt.plain_attention, 0, tq))
    jdt = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = jvae.VAEAttentionBlock(dtype=jdt).apply({"params": flax_params}, jnp.asarray(x, jdt))
    blk = t_vae.VAEAttentionBlock(c, torch.bfloat16, "cpu")
    with torch.no_grad():
        for n in w:
            getattr(blk, n).kernel.copy_(torch.from_numpy(w[n].T.copy()))
            getattr(blk, n).bias.copy_(torch.from_numpy(bias[n]))
        blk.group_norm.GroupNorm_0.scale.copy_(torch.from_numpy(gn["scale"]))
        blk.group_norm.GroupNorm_0.bias.copy_(torch.from_numpy(gn["bias"]))
        got = blk(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert len(jq) == 1 and len(tq) == 1
    assert tq[0].shape == jq[0].shape
    np.testing.assert_array_equal(tq[0], jq[0])
    _check_outputs(got.permute(0, 2, 3, 1), want)


def test_fold_scale_rounds_the_scale_to_the_dtype():
    """bf16: the product of x and bf16(scale), rounded once; f32: x * f32(scale)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32)
    for d in (40, 80, 160, 512):
        s = tatt.LOG2E / math.sqrt(d)
        want = np.asarray((jnp.asarray(x, jnp.bfloat16) * s).astype(jnp.float32))
        got = tatt.fold_scale(torch.from_numpy(x).to(torch.bfloat16), s)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(tatt.fold_scale(torch.from_numpy(x), s).numpy(), x * np.float32(s))
        assert _bf16(s) != s  # the rounding of the scale is visible at these head dims
