"""Parity of the port's self-attention block (K5) and of the opt-in kernel
configuration with the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX
Pallas kernels run in interpret mode (`pltpu.force_tpu_interpret_mode()`);
the port's wrappers run their plain versions on CPU tensors.  The JAX
package picks its opt-in kernels through SASPA_PALLAS_GN=1,
SASPA_PALLAS_LN=1 and SASPA_ATTN_MEGAKERNEL=1 and only on a TPU backend, so
the pipeline test sets those variables and answers `jax.default_backend()`
with "tpu" while the kernels run in interpret mode; the port takes
`pallas_group_norm=True, attention_megakernel=True`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.ops import attention as jatt
from saspa_tpu.ops import groupnorm as jgn
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops import groupnorm as tgn
from tests.test_golden_generation import G_UNET, G_VAE, G_TEXT
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, _ids, _inputs, tiny_params


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _block_inputs(b, l, heads, d, seed):
    """Head-padded weights in the JAX layout ((C, H*dp), (H*dp, C)) and the
    activations; C = heads * d, dp = pad_head_dim(d)."""
    rng = np.random.RandomState(seed)
    c, dp = heads * d, tatt.pad_head_dim(d)

    def cols(w):  # (C, C) -> (C, H*dp): zero columns pad each head
        return np.pad(w.reshape(c, heads, d), ((0, 0), (0, 0), (0, dp - d))).reshape(c, heads * dp)

    wq, wk, wv, wo = (rng.randn(c, c).astype(np.float32) / np.sqrt(c) for _ in range(4))
    wo = np.pad(wo.reshape(heads, d, c), ((0, 0), (0, dp - d), (0, 0))).reshape(heads * dp, c)
    return dict(
        x_ln=rng.randn(b, l, c).astype(np.float32), res=rng.randn(b, l, c).astype(np.float32),
        wq=cols(wq) * np.float32(tatt.LOG2E / math.sqrt(d)), wk=cols(wk), wv=cols(wv), wo=wo,
        bo=(0.1 * rng.randn(c)).astype(np.float32))


@pytest.mark.parametrize("l", [256, 768])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_plain_matches_pallas_interpret(l, dtype):
    """attention_block_fused (plain on the CPU) vs the JAX block kernel, d 40
    padded to 64, 2 heads, a nonzero f32 bo.  f32: to 1e-5 of the largest
    output (f32 product order).  bf16: Q, K, V, P, each head's output and the
    result are rounded at the same points; the online-vs-one-pass softmax
    and product order can flip one of those roundings, which moves an output
    by an ulp of a term: >= 99.5% of elements equal, max |diff| <= 1% of the
    largest output (0.4% at these inputs)."""
    p = _block_inputs(2, l, 2, 40, seed=l)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.attention_block_fused(j["x_ln"].astype(jdt), j["res"].astype(jdt), j["wq"].astype(jdt),
                                              j["wk"].astype(jdt), j["wv"].astype(jdt), j["wo"].astype(jdt),
                                              j["bo"], 2))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    out = tatt.attention_block_fused(t["x_ln"].to(tdt), t["res"].to(tdt), t["wq"].t().to(tdt), t["wk"].t().to(tdt),
                                     t["wv"].t().to(tdt), t["wo"].t().to(tdt), t["bo"], 2)
    assert out.dtype == tdt
    got, scale = _np(out), np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    else:
        assert np.mean(got == want) >= 0.995
        assert np.abs(got - want).max() <= 1e-2 * scale


@pytest.mark.parametrize("heads,dtype", [
    pytest.param(2, "float32", id="float32"), pytest.param(2, "bfloat16", id="bfloat16"),
    pytest.param(5, "float32", id="h5-float32"), pytest.param(5, "bfloat16", id="h5-bfloat16")])
def test_attention_block_stages_plain_matches_pallas_interpret(heads, dtype):
    """The plain mirror of K5's three kernels on the card (QKV product
    rounded to the input dtype, K1's plain attention, the f32 out epilogue)
    at L 256 with heads of 64: 2 (C 128), and 5 (C 320, H*D_pad 320, SD2.1's
    level 0, which the card's Q/K/V product takes in 64-column tiles): its
    output is attention_block_fused_plain's bit for bit, its Q/K/V/packed
    are the inputs and output of K1's plain version, and it agrees with the
    JAX block kernel in interpret mode as attention_block_fused does (f32:
    1e-5 of the largest output; bf16: max |diff| <= 1% of the largest
    output, and >= 99.5% equal at C 128, >= 98% at C 320, whose products sum
    2.5x the terms before each bf16 rounding, so that other sum orders flip
    more of them: 98.6-99.8% over seeds 7-9, max |diff| 0.34%)."""
    c = heads * 64
    p = _block_inputs(1, 256, heads, 64, seed=7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.attention_block_fused(j["x_ln"].astype(jdt), j["res"].astype(jdt), j["wq"].astype(jdt),
                                              j["wk"].astype(jdt), j["wv"].astype(jdt), j["wo"].astype(jdt),
                                              j["bo"], heads))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    args = (t["x_ln"].to(tdt), t["res"].to(tdt), t["wq"].t().to(tdt), t["wk"].t().to(tdt), t["wv"].t().to(tdt),
            t["wo"].t().to(tdt), t["bo"], heads)
    assert tatt.attention_block_takes(256, c, heads, 64, tdt)
    q, k, v, packed, out = tatt.attention_block_stages_plain(*args)
    assert all(x.dtype == tdt and x.shape == (1, 256, c) for x in (q, k, v, packed, out))
    assert torch.equal(out, tatt.attention_block_fused_plain(*args))
    assert torch.equal(packed, tatt.flash_attention_packed_plain(q, k, v, heads))
    assert torch.equal(tatt.attention_block_stages(*args)[4], out)  # the CPU wrapper runs the plain stages
    got, scale = _np(out), np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    else:
        assert np.mean(got == want) >= (0.995 if heads == 2 else 0.98)
        assert np.abs(got - want).max() <= 1e-2 * scale


def qkv_bn(hd: int) -> int:
    """csrc/attention_block.cu: columns a tile of the bf16 Q/K/V product
    (attention_block_qkv_kernel<128> where H*D_pad % 128 == 0, else <64>);
    the f32 product (gemm_f32.cuh) takes 64 at every H*D_pad."""
    return 128 if hd % 128 == 0 else 64


@pytest.mark.parametrize("hd", [512, 1024, 1536, 320])
def test_qkv_tile_map_covers_each_projection_once(hd):
    """Replays attention_block_qkv_kernel's N-tile map for SD1.5's H*D_pad
    (8 heads of 64, 128, 192: 128-column tiles) and SD2.1's level 0 (5 heads
    of 64: 320, 64-column tiles), and the f32 product's (64 columns at
    each): tile n loads rows (n % per) * BN .. + BN - 1 of wq, wk or wv (n //
    per = 0, 1, 2; per = HD / BN) and its epilogue writes the same columns
    of Q, K or V, whose buffers follow one another in the workspace ((M,
    HD) each).  Every weight row and every workspace column of the three is
    covered exactly once, and no tile crosses a projection."""
    for bn in {qkv_bn(hd), 64}:
        per = hd // bn
        assert per * bn == hd
        m = 256  # rows of the workspace (two 128-row blocks)
        hits = np.zeros(3 * m * hd, np.int64)
        rows_hit = np.zeros((3, hd), np.int64)
        for n in range(3 * per):
            which, col0 = n // per, (n % per) * bn
            assert col0 + bn <= hd
            rows_hit[which, col0:col0 + bn] += 1
            cols = col0 + np.arange(bn)
            offs = which * m * hd + np.arange(m)[:, None] * hd + cols[None, :]
            np.add.at(hits, offs.ravel(), 1)
        assert (rows_hit == 1).all() and (hits == 1).all()
    # the out product's N tiles: 160 columns where they divide C (SD1.5's
    # 320, 640, 1280; SD2.1's 320), else 64; its K walk takes HD in 64-wide
    # stages (five at SD2.1's 320)
    c = {512: 320, 1024: 640, 1536: 1280, 320: 320}[hd]
    bn = 160 if c % 160 == 0 else 64
    assert c % bn == 0 and hd % 64 == 0 and c // bn in (2, 4, 8)


def test_attention_block_eligible_copy_matches_jax(monkeypatch):
    """The port's predicate equals JAX's (with SASPA_ATTN_MEGAKERNEL=1 on a
    TPU backend) at SD1.5's self-attention sites, at 1024^2 and beyond, bf16
    and f32; at 512^2 it admits levels 0-2 and refuses the 64-token mid block."""
    monkeypatch.setenv("SASPA_ATTN_MEGAKERNEL", "1")
    monkeypatch.delenv("SASPA_PACKED_BLOCK_Q", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    sites = [(4096, 40, 320), (1024, 80, 640), (256, 160, 1280), (64, 160, 1280), (16384, 40, 320),
             (65536, 40, 320), (4096, 80, 640), (3456, 40, 320), (320, 40, 320)]
    for l, d, c in sites:
        for itemsize, jdt in ((2, jnp.bfloat16), (4, jnp.float32)):
            want = jatt.attention_block_eligible(l, l, 8, d, c, jdt)
            assert tatt.attention_block_eligible(l, l, 8, d, c, itemsize) == want, (l, d, c, itemsize)
        assert not tatt.attention_block_eligible(l, 77, 8, d, c)  # cross-attention
    assert [tatt.attention_block_eligible(l, l, 8, d, c) for l, d, c in sites[:4]] == [True, True, True, False]


RESOLUTIONS = ((512, 512), (1024, 1024), (960, 1280))  # the capped bucket's latents: 120 x 160


def _self_attention_sites(cfg, h, w):
    """(L, C, heads) of every transformer level of a UNet config (and its
    ControlNet, which mirrors the down blocks) at an h x w image: the down
    levels with cross-attention and the mid block at the last level."""
    lh, lw = h // 8, w // 8
    n = len(cfg.block_out_channels)
    levels = [i for i, t in enumerate(cfg.down_block_types) if "CrossAttn" in t] + [n - 1]
    return {((lh >> i) * (lw >> i), cfg.block_out_channels[i], cfg.num_attention_heads[i]) for i in levels}


def test_every_admitted_block_site_takes_the_kernel(monkeypatch):
    """The contract of K5's kernels (`attention_block_takes`) against the
    router's predicate: for every UNet config, at 512^2, 1024^2 and the
    capped 960x1280 bucket, in bf16 and f32, every self-attention site that
    `attention_block_eligible` admits (the port's copy, equal to JAX's with
    SASPA_ATTN_MEGAKERNEL=1 on a TPU backend) satisfies it.  Among them are
    SD2.1's 5 heads of 64 at C 320 (H*D_pad 320, not a multiple of 128) at
    4096 tokens in both dtypes and at 16384 in bf16."""
    monkeypatch.setenv("SASPA_ATTN_MEGAKERNEL", "1")
    monkeypatch.delenv("SASPA_PACKED_BLOCK_Q", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    admitted = set()
    for name, cfg in t_unet.UNET_CONFIGS.items():
        for h, w in RESOLUTIONS:
            for l, c, heads in _self_attention_sites(cfg, h, w):
                d = c // heads
                for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                    item = torch.tensor([], dtype=tdt).element_size()
                    ok = tatt.attention_block_eligible(l, l, heads, d, c, item)
                    assert ok == jatt.attention_block_eligible(l, l, heads, d, c, jdt), (name, l, c, tdt)
                    if ok:
                        assert tatt.attention_block_takes(l, c, heads, tatt.pad_head_dim(d), tdt), (name, l, c, tdt)
                        admitted.add((name, l, c, heads, tdt))
    for tdt in (torch.bfloat16, torch.float32):
        assert ("sd_v2.1", 4096, 320, 5, tdt) in admitted
        assert ("sd_v1.5", 4096, 320, 8, tdt) in admitted and ("sd_v1.5", 256, 1280, 8, tdt) in admitted
    assert ("sd_v2.1", 16384, 320, 5, torch.bfloat16) in admitted
    assert not tatt.attention_block_takes(4096, 320, 5, 40, torch.bfloat16)  # head dims come padded
    assert not tatt.attention_block_takes(192, 320, 5, 64, torch.bfloat16)  # bf16: K1's 128-row blocks
    assert tatt.attention_block_takes(192, 320, 5, 64, torch.float32)  # f32: the FFMA core's 64-row tiles
    assert not tatt.attention_block_takes(256, 320, 5, 64, torch.float16)


def test_to_out_bias_is_an_f32_master():
    """The f32 master of to_out.bias reaches K5 as f32 and the other paths as
    the compute dtype (as flax casts it per call)."""
    attn = t_unet.CrossAttention(64, 64, 2, torch.bfloat16, "cpu")
    assert attn.to_out.bias.dtype == torch.float32 and attn.to_out.kernel.dtype == torch.bfloat16
    x = torch.randn(1, 16, 64).to(torch.bfloat16)
    assert attn(x).dtype == torch.bfloat16


def _config_b_pipes(monkeypatch):
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    for k in ("SASPA_PALLAS_GN", "SASPA_PALLAS_LN", "SASPA_ATTN_MEGAKERNEL"):
        monkeypatch.setenv(k, "1")
    for k in ("SASPA_GN_FP32_NORM", "SASPA_LN_FP32_NORM", "SASPA_GN_MIN_SPLIT", "SASPA_PACKED_BLOCK_Q"):
        monkeypatch.delenv(k, raising=False)
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT,
                           pallas_group_norm=True, attention_megakernel=True)
    tp.load_flax_params(params)
    return jp, tp


def test_fused_generate_opt_in_kernels_match_jax(monkeypatch):
    """Configuration (b) on the tiny canny config, f32, 2 DDIM steps, CFG 7.5
    (tests/test_torch_pipeline.py's inputs): the JAX pipeline with the three
    switches and its Pallas kernels in interpret mode against the port with
    the two options, whose wrappers count the sites they take.  uint8
    outputs agree to 1 level, >= 99% exactly, as in configuration (a)."""
    jp, tp = _config_b_pipes(monkeypatch)
    src, lat = _inputs(5)
    ids, neg = _ids()
    counted = {}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            counted[name] = counted.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    # the JAX side really takes its kernels (counted while it traces)
    monkeypatch.setattr(jatt, "attention_block_fused", count("jax_k5", jatt.attention_block_fused))
    monkeypatch.setattr(jgn, "_gn_pallas", count("jax_k3", jgn._gn_pallas))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.make_fused_generate(32, 32, 2, 7.5)(
            jp.params, jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(src), jnp.asarray(lat)))
    assert counted["jax_k5"] > 0 and counted["jax_k3"] > 0
    monkeypatch.setattr(t_unet, "attention_block_fused", count("k5", t_unet.attention_block_fused))
    monkeypatch.setattr(tgn, "group_norm_tpu_plain", count("k3_tpu", tgn.group_norm_tpu_plain))
    got = tp.make_fused_generate(32, 32, 2, 7.5)(tp.params, ids, neg, src, lat).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 32, 32, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.99
    # per step, the self-attentions over 256 tokens take K5: the UNet's down
    # and two up blocks, the ControlNet's down block (the mid block's 64
    # tokens do not qualify)
    assert counted["k5"] == 4 * 2
    assert counted["k3_tpu"] > 0
