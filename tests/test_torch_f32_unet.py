"""SD1.5 + canny in f32 (`init_pipeline(..., dtype=torch.float32)`): the f32
variants of K1 (head dims 64/128/192), K6 and K4, and the K2 route, against
the JAX package on the CPU.

The JAX package reaches its Pallas kernels in f32 wherever its predicates
admit a shape; they answer only on a TPU backend, so the tests answer
`jax.default_backend()` with "tpu" and run the kernels in interpret mode
(`pltpu.force_tpu_interpret_mode()`).  Inputs are numpy arrays from a seed,
handed to both packages; the port's wrappers run their plain versions on
CPU tensors.

- K1's plain version in f32 at d_pad 64/128/192 against
  `flash_attention_packed`, K6's at d 40 and 80 against `flash_attention`:
  within 1e-5 of the largest output (f32 throughout; other sum orders).
- K4's plain version against `_ln_pallas` on f32 rows at C 320 and 1280:
  within 2 f32 ulps of the largest output; K4's launch plan on f32 rows and
  K3's on f32 rows past 2048 channels (two 16-byte vectors a thread).
- The routes: the port's `packed_flash_eligible` (4- and 2-byte items),
  `flash_kernel_ok` and `ln_geglu_eligible` equal JAX's over the token
  counts of 512^2, 1024^2 and a capped 960x1280 bucket, at the UNet's (and
  the refiner's) widths, in both dtypes; where JAX streams K6 the port does.
- The block takes K2 exactly where JAX's predicate admits it: never in f32,
  never at a ragged 1200 tokens, always at configuration (a)'s bf16 shapes
  (full-width blocks on the meta device, the kernels' wrappers replaced by
  shape-only stand-ins).
- A tiny f32 SD1.5 + canny pipeline at 64^2 (the tiny VAE's 32^2 latents:
  K1 at 1024 and 256 tokens, K6 in the VAE) through both packages'
  `run_generation(cfg, pipe=...)`: the same files, PNGs within 1 uint8
  level and >= 99% equal, as tests/test_torch_driver.py holds the f32
  pipelines; and the same under SASPA_PALLAS_GN=1 SASPA_ATTN_MEGAKERNEL=1
  (configuration (b) in f32: K5 at every block's self-attention, K3 with the
  TPU numerics), both packages' K5 sites counted.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import saspa_tpu.data.registry as JR
import saspa_tpu_torch.data.registry as TR
from saspa_tpu.gen.driver import run_generation as jax_run_generation
from saspa_tpu.ops import attention as jatt
from saspa_tpu.ops import geglu as jgeglu
from saspa_tpu.ops import layernorm as jln
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops import geglu as tgeglu
from saspa_tpu_torch.ops import groupnorm as tgn
from saspa_tpu_torch.ops import layernorm as tln
from tests.test_generation_driver import StubPlanesUtils
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_driver import _cfg, _jax_cfg, _pngs
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, tiny_params

ENV = ("SASPA_PALLAS_GEGLU", "SASPA_LN_FP32_NORM", "SASPA_DISABLE_PALLAS", "SASPA_PACKED_BLOCK_Q",
       "SASPA_ATTN_BLOCK_Q", "SASPA_ATTN_BLOCK_KV", "SASPA_GEGLU_BLOCK_Q", "SASPA_LN_BLOCK_Q", "SASPA_PALLAS_LN",
       "SASPA_PALLAS_GN", "SASPA_ATTN_MEGAKERNEL")


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    """No route variable set; two torch threads (the suite's workers share a few cores)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# ---- the kernels' plain versions in f32 -------------------------------------------

@pytest.mark.parametrize("d", [40, 80, 160])
def test_packed_attention_f32_plain_matches_pallas_interpret(d):
    """K1 in f32 at SD1.5's heads padded to 64/128/192 (zero pad columns, as
    the padded projections give), q pre-scaled by scale * log2(e) in f32 and
    of 3x the unit scale (peaked softmax rows): within 1e-5 of the largest
    output; the padded output columns exactly 0."""
    b, l, h = 1, 256, 2
    dp = tatt.pad_head_dim(d)
    rng = np.random.RandomState(d)

    def packed(x):
        return np.pad(x, ((0, 0), (0, 0), (0, 0), (0, dp - d))).reshape(b, l, h * dp).astype(np.float32)

    q = packed(3.0 * rng.randn(b, l, h, d) * (tatt.LOG2E / math.sqrt(d)))
    k, v = packed(rng.randn(b, l, h, d)), packed(rng.randn(b, l, h, d))
    got = tatt.flash_attention_packed(*(torch.from_numpy(t) for t in (q, k, v)), h)
    assert got.dtype == torch.float32 and tatt.packed_kernel_takes(l, dp, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, 128))
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    assert (_np(got).reshape(b, l, h, dp)[..., d:] == 0).all()


@pytest.mark.parametrize("d", [40, 80])
def test_flash_attention_f32_plain_matches_pallas_interpret(d):
    """K6 in f32 at SD1.5's level-0 and level-1 heads (unpadded; q * scale
    folded in f32), two 256-key chunks of K/V: within 1e-5 of the largest
    output."""
    b, lq, lk, h = 1, 256, 512, 2
    rng = np.random.RandomState(d + 1)
    q = (3.0 * rng.randn(b, lq, h, d)).astype(np.float32)
    k, v = (rng.randn(b, lk, h, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    got = tatt.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    assert got.dtype == torch.float32 and got.shape == (b, lq, h, d)
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("c", [320, 1280])
def test_layer_norm_f32_plain_matches_pallas_interpret(c):
    """K4 on f32 rows (`_ln_kernel`'s f32 branch: statistics and normalize
    in f32): within 2 f32 ulps of the largest output."""
    rng = np.random.RandomState(c)
    x = (0.5 + 3.0 * rng.randn(2, 128, c)).astype(np.float32)
    s, b = (1.0 + 0.2 * rng.randn(c)).astype(np.float32), (0.2 * rng.randn(c)).astype(np.float32)
    got = _np(tln.layer_norm_one_pass(*(torch.from_numpy(t) for t in (x, s, b))))
    with pltpu.force_tpu_interpret_mode():
        want = _np(jln._ln_pallas(jnp.asarray(x), jnp.asarray(s).reshape(1, c), jnp.asarray(b).reshape(1, c), 1e-5,
                                  64))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2 * ulp, (np.abs(got - want).max(), ulp)


H100_SMS = 132


def test_ln_plan_f32_covers_every_column_once():
    """K4's plan on f32 rows (16-byte vectors of 4 floats, up to
    LN_MAXV_F32 a lane), every C % 8 == 0 up to LN_MAX_C_F32: each vector of
    a row held by exactly one lane, no lane without one; at the UNet's 320,
    640, 1280: 5, 5, 10 vectors on 16, 32, 32 lanes."""
    for c in range(8, tln.LN_MAX_C_F32 + 1, 8):
        nv = c // 4
        plan = tln.ln_plan(1000, c, H100_SMS, 4)
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and 1 <= plan.vecs <= tln.LN_MAXV_F32, (c, plan)
        idx = np.arange(plan.lanes)[:, None] + plan.lanes * np.arange(plan.vecs)[None, :]
        assert np.array_equal(np.sort(idx[idx < nv]), np.arange(nv)), (c, plan)
        assert (idx[:, 0] < nv).all(), (c, plan)
    for c, lanes, vecs in ((320, 16, 5), (640, 32, 5), (1280, 32, 10)):
        assert tln.ln_plan(1000, c, H100_SMS, 4)[:2] == (lanes, vecs)


def test_gn_plan_f32_past_2048_channels_covers_every_channel_once():
    """K3 on f32 rows wider than 512 threads of 4 channels, up to 4096: two
    16-byte vectors (8 channels) a thread, whole warps, every channel of
    every row offset covered once; SD1.5's 2560-channel concatenations take
    one row of 320 threads a block."""
    for c in range(2056, 4 * 1024 + 1, 8):
        vec = tgn.gn_vec(c, 4)
        nv = c // vec
        threads, rows, blocks = tgn.gn_plan(16, 64, c, H100_SMS, vec)
        assert vec == 8 and threads % 32 == 0 and threads <= tgn.GN_MAX_THREADS and rows * nv <= threads
        tid = np.arange(rows * nv)
        chan = (tid % nv)[:, None] * vec + np.arange(vec)[None, :]
        cover = np.zeros((rows, c), np.int64)
        np.add.at(cover, (np.repeat(tid // nv, vec), chan.ravel()), 1)
        assert (cover == 1).all(), c
    assert tgn.gn_vec(2048, 4) == 4 and tgn.gn_vec(2560, 2) == 8
    assert tgn.gn_plan(16, 64, 2560, H100_SMS, 8)[:2] == (320, 1)


# ---- the routes -------------------------------------------------------------------

TOKENS = (64, 256, 300, 1024, 1200, 4096, 4800, 16384, 19200)
WIDTHS = ((320, 8), (640, 8), (1280, 8), (768, 12), (1536, 24))  # (C, heads): SD1.5's levels, the refiner's


def test_f32_routes_equal_jax(monkeypatch):
    """At every (L, C) and both dtypes: the packed route (4- and 2-byte
    items) and K6's VMEM guard equal JAX's predicates; where JAX streams K6
    the port does too (past both guards it also sends the capped bucket's
    levels to K6, tests/test_torch_flash_attention.py); and the K2
    predicate equals `ln_geglu_eligible`."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for l in TOKENS:
        for c, heads in WIDTHS:
            d = c // heads
            for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
                item = torch.tensor([], dtype=tdt).element_size()
                packed = tatt.packed_flash_eligible(l, l, heads, d, item)
                assert packed == jatt.packed_flash_eligible(l, l, heads, d, jdt), (l, c, tdt)
                s = jax.ShapeDtypeStruct((1, l, heads, d), jdt)
                ok = jatt._kernel_ok(s, s)
                assert tatt.flash_kernel_ok(l, l, d) == ok, (l, c, tdt)
                if not packed and ok:
                    assert tatt.flash_attention_route(l, l, d), (l, c, tdt)
                if packed:
                    assert tatt.packed_kernel_takes(l, tatt.pad_head_dim(d), tdt), (l, c, tdt)
                assert tgeglu.ln_geglu_eligible(l, c, 4, tdt) == jgeglu.ln_geglu_eligible(l, c, 4, jdt), (l, c, tdt)
    # the f32 UNet at 1024^2: level 0 streams K6, levels 1-2 and the mid block take K1
    assert not tatt.packed_flash_eligible(16384, 16384, 8, 40, 4) and tatt.flash_attention_route(16384, 16384, 40)
    assert all(tatt.packed_flash_eligible(l, l, 8, d, 4) for l, d in ((4096, 80), (1024, 160), (256, 160)))


def _stand_in(calls, name):
    def run(x, *args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return torch.empty_like(x)

    return run


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_takes_k2_where_jax_does(dtype, monkeypatch):
    """One full-width transformer block a site (meta device; the kernels'
    wrappers replaced by shape-only stand-ins that count their calls): the
    block calls fused_ln_geglu exactly where JAX's ln_geglu_eligible admits
    (L, C, dtype), and otherwise runs norm3 (K4) and the feed-forward apart.
    So never in f32, never at the capped bucket's 1200 or 300 tokens, and at
    every configuration (a) block in bf16."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    calls = {}
    for name in ("fused_ln_geglu", "layer_norm_one_pass", "flash_attention_packed"):
        monkeypatch.setattr(t_unet, name, _stand_in(calls, name))
    monkeypatch.setattr(tatt, "flash_attention", lambda q, k, v, scale: torch.empty_like(q))
    took = {}
    for l in TOKENS:
        for c, heads in WIDTHS:
            blk = t_unet.BasicTransformerBlock(c, 768, heads, dtype, "meta")
            calls.clear()
            out = blk(torch.empty(2, l, c, dtype=dtype, device="meta"), torch.empty(2, 77, 768, dtype=dtype,
                                                                                     device="meta"))
            assert out.shape == (2, l, c) and out.dtype == dtype
            took[(l, c)] = calls.get("fused_ln_geglu", 0)
            want = jgeglu.ln_geglu_eligible(l, c, 4, jdt)
            assert took[(l, c)] == int(want), (l, c, dtype, calls)
            assert calls["layer_norm_one_pass"] == (2 if want else 3), (l, c, dtype, calls)
    if dtype == torch.float32:
        assert not any(took.values())
    else:
        assert all(took[s] == 1 for s in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)))
        assert not any(took[(l, c)] for l in (1200, 300) for c, _ in WIDTHS)


# ---- the f32 pipeline through both drivers -------------------------------------

@pytest.fixture()
def square_tree(tmp_path, monkeypatch):
    """Two 64x64 PIL-written JPEG sources: one 64^2 bucket."""
    images = tmp_path / "ds" / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(images / f"{2000000 + i}.jpg")

    def stub(print_func=print):
        return StubPlanesUtils(tmp_path / "ds", print_func)

    monkeypatch.setitem(JR.DS_UTILS_DICT, "planes", stub)
    monkeypatch.setitem(TR.DS_UTILS_DICT, "planes", stub)
    return tmp_path


def _same_pngs(got, want):
    """The same files; generated PNGs within 1 uint8 level and >= 99% equal,
    the _source and _control PNGs equal."""
    assert sorted(got) == sorted(want) and len(got) == 2 + 2 + 2
    for name in got:
        a, b = got[name].astype(np.int32), want[name].astype(np.int32)
        assert a.shape == b.shape, name
        if "_prompt_" in name:
            d = np.abs(a - b)
            assert a.shape == (64, 64, 3) and d.max() <= 1 and np.mean(d == 0) >= 0.99, (name, d.max())
        else:
            assert np.array_equal(a, b), name


def test_f32_run_generation_matches_jax(square_tree, monkeypatch):
    """The tiny canny configuration (tests/test_torch_pipeline.py's params)
    in f32 at 64^2, 2 sources x 1 prompt, batch 2, 2 DDIM steps, CFG 7.5,
    through both `run_generation(cfg, pipe=...)`, JAX with its kernels in
    interpret mode: its packed kernel at every self-attention (level 0's
    1024 tokens, the mid blocks' 256), its K6 at the VAE's 16-wide head, no
    K2.  The port's pipeline takes the same routes (counted through its
    wrappers): K1 in f32 at the 6 blocks a step (UNet 4, ControlNet 2), K6
    once a decode, K4 at each block's norm1/norm2/norm3 and no K2.  The same files; the generated PNGs within
    1 uint8 level and >= 99% equal, the _source and _control PNGs equal."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(params)
    cfg = _cfg(resolution=64, num_per_image=1, batch_size=2)
    with pltpu.force_tpu_interpret_mode():
        want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()

    counts = {}
    for module, name in ((t_unet, "flash_attention_packed"), (t_unet, "fused_ln_geglu"),
                         (t_unet, "layer_norm_one_pass"), (tatt, "flash_attention")):
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, counted)
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir
    _same_pngs(_pngs(got_dir), want)
    # per step 6 blocks (UNet: down 1, up 2, mid; ControlNet: down 1, mid), one decode
    assert counts.get("fused_ln_geglu", 0) == 0, counts
    assert counts["flash_attention_packed"] == 6 * 2 and counts["layer_norm_one_pass"] == 3 * 6 * 2, counts
    assert counts["flash_attention"] == 1, counts


def test_f32_opt_in_run_generation_matches_jax(square_tree, monkeypatch):
    """test_f32_run_generation_matches_jax under SASPA_PALLAS_GN=1
    SASPA_ATTN_MEGAKERNEL=1 (configuration (b) on the f32 pipeline): JAX
    traces its block kernel (K5) at the self-attentions its predicate admits
    at 4-byte items and runs it in interpret mode, with its GroupNorm kernel;
    the port, whose pipeline reads the same variables where it is built,
    runs K5's plain version at each of the 6 blocks a step (and so K1 at
    none), K3 with the TPU numerics, K6 once a decode, no K2.  The same
    files and bounds."""
    for k in ("SASPA_PALLAS_GN", "SASPA_ATTN_MEGAKERNEL"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    assert tp.switches.attention_megakernel and tp.switches.pallas_group_norm
    tp.load_flax_params(params)
    counts = {}

    def count(module, name):
        fn = getattr(module, name)

        def counted(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)

    count(jatt, "attention_block_fused")  # JAX's sites, counted while it traces its step once
    cfg = _cfg(resolution=64, num_per_image=1, batch_size=2)
    with pltpu.force_tpu_interpret_mode():
        want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    assert counts.pop("attention_block_fused") == 6  # one traced step: the port's 6 sites a step
    for module, name in ((t_unet, "attention_block_fused"), (t_unet, "flash_attention_packed"),
                         (t_unet, "fused_ln_geglu"), (tatt, "flash_attention"), (tgn, "group_norm_tpu_plain")):
        count(module, name)
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir
    _same_pngs(_pngs(got_dir), want)
    assert counts["attention_block_fused"] == 6 * 2 and counts.get("flash_attention_packed", 0) == 0, counts
    assert counts.get("fused_ln_geglu", 0) == 0 and counts["flash_attention"] == 1, counts
    assert counts["group_norm_tpu_plain"] > 0, counts
