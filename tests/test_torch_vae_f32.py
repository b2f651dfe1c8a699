"""The XL VAE in f32 (SASPA_XL_VAE_FP32=1) and the f32 variants of K1 and K3
that it runs, against the JAX package, on the CPU.

K3's plain versions in f32 (the default path's `_xla_group_norm` order and
the TPU kernel's numerics, `_gn_pallas` in Pallas interpret mode on an f32
block: f32 normalize and SiLU) at VAE-like sites, within 2e-5 of the
largest output (f32 statistics summed in other orders); K3's launch plan for
f32 rows (16-byte vectors of 4 floats) at the VAE's widths.  K1's plain
version in f32 at the VAE's one head of 512 against `flash_attention_packed`
in interpret mode, within 1e-5 of the largest output, and the packed route
for 4-byte items against JAX's predicate (4096 tokens admitted, 16384 not).
Then the switch: read at construction, it gives the XL families' VAE f32
and leaves the towers, UNet and ControlNet in the pipeline's dtype (bf16
here), and SD1.5's VAE as it is; the tiny XL pipeline's decode and encode
(tests/test_torch_xl.py's params) against JAX's `_vae_env()` and `vae`
under the same switch, within 2e-5 of the largest output; the sampler
hands the decoder f32 latents.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.models.vae import AutoencoderKL as JaxVAE
from saspa_tpu.ops import attention as jatt
from saspa_tpu.ops import groupnorm as jgn
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops import groupnorm as tgn
from tests.test_golden_families import GX_TEXT, GX_VAE
from tests.test_torch_blip import _close
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline
from tests.test_torch_xl import LX_UNET, P_GX_TEXT, P_GX_VAE, P_LX_UNET, xl_params

H100_SMS = 132


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several worker processes share a few cores (tests/test_torch_sdedit.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# ---- K3 in f32 -------------------------------------------------------------------

@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,hw", [(128, 256), (256, 64), (64, 1024)])
def test_group_norm_f32_plain_versions_match_jax(act, c, hw):
    """f32 at eps 1e-6 (the VAE's), 32 groups: group_norm_plain against
    `_xla_group_norm` and group_norm_tpu_plain against `_gn_pallas`
    (interpret mode; an f32 block normalizes and activates in f32 whatever
    its bf16_norm flag), both through `group_norm` on CPU tensors."""
    b, groups, eps = 2, 32, 1e-6
    rng = np.random.RandomState(c + hw)
    x = (0.5 + 3.0 * rng.randn(b, hw, c)).astype(np.float32)
    gamma, beta = (1.0 + 0.2 * rng.randn(c)).astype(np.float32), (0.2 * rng.randn(c)).astype(np.float32)
    side = int(math.isqrt(hw))
    xt = torch.from_numpy(x).permute(0, 2, 1).reshape(b, c, side, side)
    onehot = jnp.asarray(np.repeat(np.eye(groups, dtype=np.float32), c // groups, axis=0))
    with pltpu.force_tpu_interpret_mode():
        want_tpu = _np(jgn._gn_pallas(jnp.asarray(x), jnp.asarray(gamma).reshape(1, c),
                                      jnp.asarray(beta).reshape(1, c), onehot, groups, eps, act,
                                      jgn._pick_chunk(hw, c), 1, True))
    want_xla = _np(jgn._xla_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, eps, act))
    for tpu, want in ((False, want_xla), (True, want_tpu)):
        got = tgn.group_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, eps, act, tpu_numerics=tpu)
        assert got.dtype == torch.float32
        got = _np(got.reshape(b, c, hw).permute(0, 2, 1))
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_gn_plan_f32_covers_every_channel_once():
    """gn_plan for f32 rows (vec 4) at every width up to 4 * GN_MAX_THREADS:
    whole warps, rows * C/4 threads each owning one 16-byte vector of 4
    channels, every channel of every row offset covered once, the
    statistics' shared memory (rows * C float2) within 16 KB; at the VAE's
    widths (128, 256, 512) no thread idles."""
    for c in range(4, 4 * tgn.GN_MAX_THREADS + 1, 4):
        nv = c // 4
        threads, rows, blocks = tgn.gn_plan(8, 512 * 512, c, H100_SMS, 4)
        assert threads % 32 == 0 and threads <= tgn.GN_MAX_THREADS and rows * nv <= threads and blocks >= 1
        assert rows * c * 8 <= 16 * 1024
        tid = np.arange(rows * nv)
        chan = (tid % nv)[:, None] * 4 + np.arange(4)[None, :]
        cover = np.zeros((rows, c), np.int64)
        np.add.at(cover, (np.repeat(tid // nv, 4), chan.ravel()), 1)
        assert (cover == 1).all(), c
        if c in (128, 256, 512):
            assert threads == rows * nv, (c, threads, rows)


# ---- K1 in f32 at d 512 ----------------------------------------------------------

@pytest.mark.parametrize("b,l", [(1, 256), (2, 128)])
def test_packed_attention_f32_d512_plain_matches_pallas_interpret(b, l):
    """f32 at the VAE's one head of 512, q pre-scaled by scale * log2(e) in
    f32: the port's plain K1 against flash_attention_packed in interpret
    mode (f32 scores, probabilities and P.V), within 1e-5 of the largest
    output; q of 3x the unit scale peaks each softmax on a few keys."""
    rng = np.random.RandomState(l + b)
    d = 512
    q = (3.0 * rng.randn(b, l, d) * (tatt.LOG2E / math.sqrt(d))).astype(np.float32)
    k, v = (rng.randn(b, l, d).astype(np.float32) for _ in range(2))
    got = tatt.flash_attention_packed(*(torch.from_numpy(t) for t in (q, k, v)), 1)
    assert got.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, 128))
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_f32_route_copies_jax_predicate(monkeypatch):
    """The packed route counts 4-byte items as JAX's predicate does (read
    here with its backend check answered "tpu"): the XL VAE's head of 512 at
    4096 tokens (512^2) takes K1 in f32, at 16384 (1024^2) the plain path;
    bf16 at both."""
    monkeypatch.setattr(jatt.jax, "default_backend", lambda: "tpu")
    for l in (256, 1024, 4096, 9216, 16384):
        for itemsize, jdt in ((4, jnp.float32), (2, jnp.bfloat16)):
            assert tatt.packed_flash_eligible(l, l, 1, 512, itemsize) == jatt.packed_flash_eligible(l, l, 1, 512, jdt)
    assert tatt.packed_flash_eligible(4096, 4096, 1, 512, 4)
    assert not tatt.packed_flash_eligible(16384, 16384, 1, 512, 4)
    assert not tatt.flash_attention_route(16384, 16384, 512)  # no K6 for a head of 512: plain, as JAX's XLA


# ---- SASPA_XL_VAE_FP32 -----------------------------------------------------------

def _port_xl(params=None, dtype=torch.bfloat16):
    tp = DiffusionPipeline("sd_xl-turbo", None, device="cpu", dtype=dtype, init_seed=None, unet_cfg=P_LX_UNET,
                           vae_cfg=P_GX_VAE, text_cfgs=P_GX_TEXT)
    if params is not None:
        tp.load_flax_params(params)
    return tp


@pytest.fixture(scope="module")
def params():
    return {k: v for k, v in xl_params().items() if k != "controlnet"}


def test_switch_is_read_at_construction(monkeypatch):
    """With SASPA_XL_VAE_FP32=1 an XL pipeline's VAE is f32, its towers and
    UNet bf16; SD1.5's VAE stays bf16; without the switch the XL VAE is
    bf16, and an f32 pipeline's f32.  The switch is read when the pipeline
    is built, not when it runs."""
    monkeypatch.setenv("SASPA_XL_VAE_FP32", "1")
    tp = _port_xl()
    assert tp.vae_dtype == torch.float32 and tp.params["vae"].decoder.conv_in.kernel.dtype == torch.float32
    assert tp.params["unet"].conv_in.kernel.dtype == torch.bfloat16
    assert all(te.token_embedding.embedding.dtype == torch.bfloat16 for te in tp.params["text"])
    sd = DiffusionPipeline("sd_v1.5", None, device="cpu", dtype=torch.bfloat16, init_seed=None, unet_cfg=P_UNET,
                           vae_cfg=P_VAE, text_cfgs=P_TEXT)
    assert sd.vae_dtype == torch.bfloat16
    monkeypatch.delenv("SASPA_XL_VAE_FP32")
    assert tp.params["vae"].decoder.conv_in.kernel.dtype == torch.float32  # built under the switch
    assert _port_xl().vae_dtype == torch.bfloat16
    assert _port_xl(dtype=torch.float32).vae_dtype == torch.float32


def test_xl_vae_f32_decode_and_encode_match_jax(params, monkeypatch):
    """Under SASPA_XL_VAE_FP32=1 both bf16 pipelines decode and encode in
    f32: the port's decode of f32 latents against JAX's `_vae_env()`, its
    encoder's posterior mean of [0, 1] images against JAX's `vae` (built f32
    at construction), within 2e-5 of the largest output."""
    monkeypatch.setenv("SASPA_XL_VAE_FP32", "1")
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_xl-turbo", controlnet=None, sampler="ddim", dtype=jnp.bfloat16,
                            unet_cfg=LX_UNET, vae_cfg=GX_VAE, text_cfgs=GX_TEXT)
    tp = _port_xl(params)
    assert jp._vae_env().dtype == jnp.float32 and jp.vae.dtype == jnp.float32
    rng = np.random.RandomState(19)
    z = rng.randn(2, 16, 16, 4).astype(np.float32)
    want = jp._vae_env().apply({"params": jp.params["vae"]}, jnp.asarray(z), method=JaxVAE.decode)
    got = tp.params["vae"].decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1), want, 2e-5)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jmean, _ = jp.vae.apply({"params": jp.params["vae"]}, jnp.asarray(x) * 2.0 - 1.0, method=JaxVAE.encode)
    mean = tp.encode_mean(x)
    assert mean.dtype == torch.float32
    _close(mean.permute(0, 2, 3, 1), jmean, 2e-5)


def test_sampler_hands_the_f32_vae_f32_latents(params, monkeypatch):
    """generate under the switch: the bf16 UNet's loop ends in f32 latents,
    which reach the f32 decoder as they are (the sampler divides them by
    the scaling factor in f32, as JAX's)."""
    monkeypatch.setenv("SASPA_XL_VAE_FP32", "1")
    tp = _port_xl(params)
    seen = []
    hook = tp.params["vae"].decoder.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    rng = np.random.RandomState(20)
    ids = tp.tokenizer(["a painted bunting on a branch", "a small grey bird"], pad="eot")
    out = tp.generate(["a", "b"], rng.randn(2, 16, 16, 4).astype(np.float32), 32, 32, 2, 0.0, negative_prompt=None,
                      token_ids=ids)
    hook.remove()
    assert seen == [torch.float32] and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
