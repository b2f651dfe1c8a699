"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
port's kernel wrappers run their plain versions here (CPU tensors); the JAX
kernels run in Pallas interpret mode where they have one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.diffusion import schedulers as jsched
from saspa_tpu.models.unet import _ln32_forward as j_ln32
from saspa_tpu.ops import attention as jatt
from saspa_tpu.ops import geglu as jgeglu
from saspa_tpu.ops.canny import canny_batch as j_canny_batch
from saspa_tpu.ops.canny import canny_control_image as j_canny_control_image
from saspa_tpu.ops.groupnorm import _xla_group_norm
from saspa_tpu_torch.diffusion import schedulers as tsched
from saspa_tpu_torch.models.unet import _ln32_forward as t_ln32
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops import canny as tcanny
from saspa_tpu_torch.ops import geglu as tgeglu
from saspa_tpu_torch.ops.groupnorm import group_norm


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# ---- K1: packed-heads attention ---------------------------------------------

def _packed_inputs(b, l, heads, d, dp, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, l, heads, d).astype(np.float32) for _ in range(3))
    pad = lambda x: np.pad(x, ((0, 0), (0, 0), (0, 0), (0, dp - d))).reshape(b, l, heads * dp)
    scale = 1.0 / math.sqrt(d)
    return q, k, v, pad(q * (scale * tatt.LOG2E)), pad(k), pad(v), scale


@pytest.mark.parametrize("b,l,heads,d,dp", [(2, 256, 4, 40, 64), (1, 256, 1, 64, 64)])
def test_packed_attention_plain_matches_pallas_interpret(b, l, heads, d, dp):
    """f32: plain K1 vs flash_attention_packed (interpret) to 1e-5, and vs
    the JAX package's _xla_attention on the unpadded heads to 2e-5; padded
    output columns exactly zero."""
    q, k, v, qp, kp, vp, scale = _packed_inputs(b, l, heads, d, dp, seed=l + d)
    got = tatt.flash_attention_packed(torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(vp), heads)
    with pltpu.force_tpu_interpret_mode():
        want = jatt.flash_attention_packed(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), heads)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    got4 = _np(got).reshape(b, l, heads, dp)
    assert np.all(got4[..., d:] == 0)
    ref = _np(jatt._xla_attention(jnp.asarray(q) * scale, jnp.asarray(k), jnp.asarray(v), 1.0))
    np.testing.assert_allclose(got4[..., :d], ref, atol=2e-5, rtol=2e-5)


def test_plain_attention_matches_xla_attention():
    """Cross-attention path (77-token kv), f32, to 1e-5."""
    rng = np.random.RandomState(3)
    q, k, v = rng.randn(2, 64, 4, 16), rng.randn(2, 77, 4, 16), rng.randn(2, 77, 4, 16)
    q, k, v = (x.astype(np.float32) for x in (q, k, v))
    got = tatt.plain_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.25)
    want = jatt._xla_attention(*(jnp.asarray(x) for x in (q, k, v)), 0.25)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_packed_eligibility_is_shape_only():
    """The packed predicate reads shapes and the activation itemsize only
    (its guard against JAX's at every shape: test_torch_flash_attention.py)."""
    assert tatt.packed_flash_eligible(4096, 4096, 8, 40) and tatt.packed_flash_eligible(256, 256, 8, 160)
    assert not tatt.packed_flash_eligible(64, 64, 8, 160)  # SD1.5 mid block at 512^2
    assert not tatt.packed_flash_eligible(4096, 77, 8, 40)  # cross-attention
    assert not tatt.packed_flash_eligible(320, 320, 8, 40)  # not a multiple of 128
    assert not tatt.packed_flash_eligible(16384, 16384, 8, 40)  # SD1.5 level 0 at 1024^2: past the guard
    assert [tatt.pad_head_dim(d) for d in (40, 80, 160, 512, 64)] == [64, 128, 192, 512, 64]
    assert all(jatt.pad_head_dim(d) == tatt.pad_head_dim(d) for d in (16, 40, 80, 160, 512))


def test_packed_attention_bf16_d512_plain_matches_pallas_interpret():
    """bf16 at the VAE's one head of 512, (B, L, H, d) = (1, 256, 1, 512):
    the port's plain K1 against flash_attention_packed in interpret mode on
    the same bf16 inputs (q pre-scaled by scale * log2(e) and rounded to
    bf16, 3x the unit scale, which peaks each softmax on a few keys).  Both
    take f32 scores and sums, round P to bf16 before the P.V product and the
    output to bf16; the f32 sums run in other orders, which can move an
    output across a bf16 rounding boundary: within 2^-7 of the largest
    output (one bf16 ulp or less at its magnitude)."""
    rng = np.random.RandomState(512)
    b, l, d = 1, 256, 512
    q = (3.0 * rng.randn(b, l, d) * (tatt.LOG2E / math.sqrt(d))).astype(np.float32)
    k, v = (rng.randn(b, l, d).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = tatt.flash_attention_packed(tq, tk, tv, 1)
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.flash_attention_packed(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
                                               1))
    assert np.abs(want).max() >= 2.0  # peaked: a few keys carry each output
    np.testing.assert_allclose(_np(got), want, atol=2.0 ** -7 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("d,dtype", [(512, torch.bfloat16), (512, torch.float32), (64, torch.bfloat16),
                                     (128, torch.bfloat16), (192, torch.bfloat16)])
def test_packed_kernel_takes_every_admitted_shape(d, dtype):
    """Every L (a multiple of 128 up to 20,000) that the packed route admits
    at one head of d_pad (and at 8 heads) is one the kernels' contract takes,
    so the route never hands a CUDA tensor to a wrapper that raises."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    for heads in (1, 8):
        admitted = [l for l in range(128, 20001, 128) if tatt.packed_flash_eligible(l, l, heads, d, itemsize)]
        assert admitted and all(tatt.packed_kernel_takes(l, d, dtype) for l in admitted), (heads, admitted)
    if d == 512:  # the guard's counts at one head: 122 values in bf16 (up to 17,536), 68 in f32 (up to 9,600)
        admitted = [l for l in range(128, 20001, 128) if tatt.packed_flash_eligible(l, l, 1, d, itemsize)]
        assert (len(admitted), admitted[-1]) == ((122, 17536) if dtype == torch.bfloat16 else (68, 9600))
    assert not tatt.packed_kernel_takes(96, d, dtype) and not tatt.packed_kernel_takes(0, d, dtype)
    assert not tatt.packed_kernel_takes(256, d, torch.float16)


# ---- K2: fused LN + GEGLU ----------------------------------------------------

def _geglu_inputs(b, l, c, seed):
    rng = np.random.RandomState(seed)
    f = 4 * c
    return dict(
        x=rng.randn(b, l, c).astype(np.float32),
        lns=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
        lnb=(0.1 * rng.randn(c)).astype(np.float32),
        w1=(rng.randn(c, 2 * f) / np.sqrt(c)).astype(np.float32),  # flax (in, out)
        b1=(0.1 * rng.randn(2 * f)).astype(np.float32),
        w2=(rng.randn(f, c) / np.sqrt(f)).astype(np.float32),
        b2=(0.1 * rng.randn(c)).astype(np.float32),
    )


def _port_geglu(p, dtype):
    t = lambda a: torch.from_numpy(a)
    return tgeglu.fused_ln_geglu(t(p["x"]).to(dtype), t(p["lns"]), t(p["lnb"]), t(p["w1"].T.copy()).to(dtype),
                                 t(p["b1"]).to(dtype), t(p["w2"].T.copy()).to(dtype), t(p["b2"]).to(dtype))


@pytest.mark.parametrize("b,l,c", [(2, 128, 64), (1, 64, 128)])
def test_ln_geglu_plain_matches_pallas_interpret_bf16(b, l, c):
    """bf16: same rounding points as the TPU kernel; only the f32 summation
    order of the two products differs, which can flip a bf16 rounding of the
    hidden or the output: max |diff| <= 2 bf16 ulps of the output's range
    (0.0625 at |out| < 8) and mean |diff| < 2e-3."""
    p = _geglu_inputs(b, l, c, seed=c)
    got = _np(_port_geglu(p, torch.bfloat16))
    j = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = _np(jgeglu.fused_ln_geglu(j["x"].astype(jnp.bfloat16), j["lns"], j["lnb"], j["w1"], j["b1"],
                                         j["w2"], j["b2"]))
    assert np.abs(want).max() < 8
    assert np.abs(got - want).max() <= 0.0625
    assert np.abs(got - want).mean() < 2e-3


def test_ln_geglu_plain_matches_separate_ops_f32():
    """f32: the plain K2 vs the JAX separate-op path (LayerNorm32 + Dense
    GEGLU with exact erf gelu + residual), to 2e-5."""
    import flax.linen as nn

    p = _geglu_inputs(2, 64, 32, seed=7)
    got = _np(_port_geglu(p, torch.float32))
    x = jnp.asarray(p["x"])
    xn = j_ln32(x, jnp.asarray(p["lns"]), jnp.asarray(p["lnb"]), 1e-5)
    h = xn @ p["w1"] + p["b1"]
    h, gate = jnp.split(h, 2, axis=-1)
    want = _np(x + ((h * nn.gelu(gate, approximate=False)) @ p["w2"] + p["b2"]))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_erf_polynomial_matches_jax():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    got = _np(tgeglu.erf_f32(torch.from_numpy(x)))
    np.testing.assert_allclose(got, _np(jgeglu._erf_f32(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_allclose(got, _np(jax.lax.erf(jnp.asarray(x))), atol=1e-6)


# ---- GroupNorm, LayerNorm32 --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,groups,act,eps", [(64, 32, "silu", 1e-5), (48, 32, None, 1e-6), (6, 32, "silu", 1e-5)])
def test_group_norm_matches_xla_group_norm(dtype, c, groups, act, eps):
    """f32 to 1e-5.  bf16: the f32 normalize cast to bf16 matches bit for bit
    on >= 99.9% of elements (1 ulp at most); SiLU then runs in bf16, where
    XLA rounds sigmoid(x) to bf16 before the product and torch rounds once,
    so the activated outputs agree to 2 bf16 ulps."""
    rng = np.random.RandomState(c)
    x = (2.0 + 3.0 * rng.randn(2, 8, 8, c)).astype(np.float32)
    gamma, beta = (1 + 0.2 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    g = min(groups, c) if c % min(groups, c) == 0 else 1  # the JAX caller's c % groups -> 1 rule
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)

    def both(a):
        want = _np(_xla_group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta), g, eps, a))
        got = group_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, eps, a)
        return _np(got.permute(0, 2, 3, 1)), want

    got, want = both(act)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    ulp = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= 2 * ulp)
    got, want = both(None)
    assert np.all(np.abs(got - want) <= ulp) and np.mean(got == want) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln32_forward_matches(dtype):
    """f32 to 1e-5; bf16 normalize pass: within 1 bf16 ulp, >= 98% equal."""
    rng = np.random.RandomState(5)
    x = (1.0 + 2.0 * rng.randn(2, 16, 64)).astype(np.float32)
    s, b = (1 + 0.1 * rng.randn(64)).astype(np.float32), (0.1 * rng.randn(64)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _np(j_ln32(jnp.asarray(x).astype(jdt), jnp.asarray(s), jnp.asarray(b), 1e-5))
    got = _np(t_ln32(torch.from_numpy(x).to(dtype), torch.from_numpy(s), torch.from_numpy(b), 1e-5))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-30)
        assert np.mean(got == want) > 0.98


# ---- Canny, DDIM -------------------------------------------------------------

def _canny_images(seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:48, 0:64]
    imgs = []
    for i in range(3):
        img = np.full((48, 64, 3), rng.randint(0, 256, 3), np.float32)
        for _ in range(4):
            cy, cx, r = rng.randint(0, 48), rng.randint(0, 64), rng.randint(4, 16)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
        img += rng.randn(48, 64, 3) * 20 * (i == 2)  # one noisy image: long hysteresis chains
        imgs.append(img)
    return np.clip(np.stack(imgs), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("low,high,max_iters", [(120.0, 200.0, 0), (20.0, 60.0, 0), (20.0, 60.0, 3)])
def test_canny_bit_exact_on_uint8(low, high, max_iters):
    imgs = _canny_images(int(low))
    want = np.asarray(j_canny_batch(jnp.asarray(imgs), low, high, max_iters))
    got = tcanny.canny_batch(torch.from_numpy(imgs), low, high, max_iters, check_every=4).numpy()
    assert got.dtype == np.uint8 and want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert (got > 0).any()
    ctrl = tcanny.canny_control_image(torch.from_numpy(imgs), low, high)
    assert ctrl.shape == (3, 48, 64, 3) and ctrl.dtype == torch.float32
    assert np.array_equal(ctrl.numpy(), np.asarray(j_canny_control_image(jnp.asarray(imgs), low, high)))


@pytest.mark.parametrize("n", [1, 2, 30, 50, 999])
def test_ddim_timesteps_exact(n):
    want = jsched.make_timesteps(jsched.SchedulerConfig(), n)
    got = tsched.make_timesteps(tsched.SchedulerConfig(), n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tsched._alphas_cumprod(tsched.SchedulerConfig()),
                          jsched._alphas_cumprod(jsched.SchedulerConfig()))


def test_ddim_step_matches():
    """One DDIM step per (t, prev_t) pair, f32, to f32 rounding."""
    rng = np.random.RandomState(0)
    x, eps = rng.randn(2, 8, 8, 4).astype(np.float32), rng.randn(2, 8, 8, 4).astype(np.float32)
    js, ts = jsched.DDIMScheduler(), tsched.DDIMScheduler()
    steps = list(js.timesteps(5))
    for t, prev in zip(steps, steps[1:] + [-1]):
        _, want = js.step((), jnp.asarray(eps), int(t), int(prev), jnp.asarray(x))
        state, got = ts.step(ts.init_state(5, x.shape), torch.from_numpy(eps), int(t), int(prev),
                             torch.from_numpy(x))
        assert state == ()
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
