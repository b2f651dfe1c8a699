"""Parity of the port's UniPC sampler (`--sampler unipcmultistep`) with the
JAX package, on the CPU.

The scheduler step by step over seeded trajectories (the same start sample
and model outputs handed to both packages), in f64 (the JAX scheduler's
alphas_cumprod set to f64 under jax.enable_x64, the port's host copy
`_ac` likewise: within 1e-12 of the largest |want|) and in f32 as
both packages run it (within 1e-5 of the largest |want|: the host's f32
log/expm1 and XLA's differ by an ulp, and the multistep history carries
that along 50 steps; measured 2.7e-6).  The trajectories cover the
order-1 first step, the order-2 steps, the lower-order last step and an
SDEdit-truncated start.  The multistep grid equal to JAX's for leading and
trailing spacing.  Then the SD1.5 + canny fused path and SDEdit's
`generate` at tests/test_golden_generation.py's tiny config, and
BLIP-Diffusion's fused path at tests/test_torch_blip.py's (f32, params
through the bridge), against JAX's: uint8 within 1 level on >= 99% of the
pixels (tests/test_torch_blip.py::_images_close).  DDIM stays as it was:
tests/test_torch_pipeline.py and the golden replays run it unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.diffusion import schedulers as jsched
from saspa_tpu_torch.diffusion import schedulers as tsched
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_blip import _images_close
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, _ids, _inputs, tiny_params


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several worker processes share a few cores (tests/test_torch_sdedit.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("n", [1, 2, 4, 25, 30, 50, 100])
def test_multistep_timesteps_match_jax(spacing, n):
    want = jsched.make_timesteps(jsched.SchedulerConfig(timestep_spacing=spacing), n, multistep=True)
    got = tsched.make_timesteps(tsched.SchedulerConfig(timestep_spacing=spacing), n, multistep=True)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tsched.UniPCScheduler(tsched.SchedulerConfig(timestep_spacing=spacing)).timesteps(n), want)
    # DDIM's grid stays DDIM's
    assert np.array_equal(tsched.DDIMScheduler().timesteps(n),
                          jsched.make_timesteps(jsched.SchedulerConfig(), n))


def _trajectories(n, start, dtype):
    """Both packages' samples after each step of n multistep timesteps from
    index `start` on, fed the same seeded start sample and model outputs."""
    cfg = jsched.SchedulerConfig()
    ts = jsched.make_timesteps(cfg, n, multistep=True)[start:]
    prev = [int(t) for t in ts[1:]] + [-1]
    rng = np.random.RandomState(n * 100 + start)
    x = rng.randn(2, 8, 8, 4).astype(dtype)
    eps = [rng.randn(2, 8, 8, 4).astype(dtype) for _ in ts]
    f64 = dtype == np.float64
    with jax.enable_x64(f64):
        js = jsched.UniPCScheduler(cfg)
        if f64:
            js.alphas_cumprod = jnp.asarray(jsched._alphas_cumprod(cfg), jnp.float64)
        state, lat, want = js.init_state(len(ts), x.shape), jnp.asarray(x), []
        for t, p, e in zip(ts, prev, eps):
            state, lat = js.step(state, jnp.asarray(e), int(t), p, lat)
            want.append(np.asarray(lat))
    ts_ = tsched.UniPCScheduler(tsched.SchedulerConfig())
    if f64:
        ts_._ac = torch.as_tensor(tsched._alphas_cumprod(tsched.SchedulerConfig()), dtype=torch.float64)
    state, lat, got = ts_.init_state(len(ts), x.shape), torch.from_numpy(x), []
    for t, p, e in zip(ts, prev, eps):
        state, lat = ts_.step(state, torch.from_numpy(e), int(t), p, lat)
        got.append(lat.numpy())
    assert state["step"] == len(ts)
    return got, want


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("n,start", [(30, 0), (50, 0), (30, 26), (50, 43), (3, 0), (1, 0)])
def test_unipc_steps_match_jax(n, start, dtype, rel):
    """Every step's sample: 30 and 50 steps whole (order 1, then 2, then 1
    at the end), SDEdit's truncation at strength 0.15 (start 26 of 30, 43 of
    50: the history starts empty mid-grid), and the short schedules where
    the warm-up and the final order meet."""
    got, want = _trajectories(n, start, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == dtype
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rel * scale, (i, err, scale)


def test_order_schedule_matches_jax():
    """The predictor's order at each step, for n of 1 to 6 (warm-up and
    lower_order_final)."""
    js, ts = jsched.UniPCScheduler(), tsched.UniPCScheduler()
    for n in range(1, 7):
        assert [ts._order_at(i, n) for i in range(n)] == [int(js._order_at(i, n)) for i in range(n)]


@pytest.fixture(scope="module")
def unipc_pipes():
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="unipcmultistep", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", sampler="unipcmultistep", device="cpu", dtype=torch.float32,
                           init_seed=None, unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(params)
    return jp, tp


def test_fused_unipc_matches_jax(unipc_pipes):
    """SD1.5 + canny at 32^2, CFG 7.5, 4 UniPC steps (orders 1, 2, 2, 1):
    the port's fused function against JAX's make_fused_generate, and the
    port's unfused generate against its own fused function."""
    jp, tp = unipc_pipes
    assert isinstance(tp.scheduler, tsched.UniPCScheduler) and isinstance(jp.scheduler, jsched.UniPCScheduler)
    src, lat = _inputs(7)
    ids, nids = _ids()
    want = jp.make_fused_generate(32, 32, 4, 7.5)(jp.params, *map(jnp.asarray, (ids, nids, src, lat)))
    got = tp.make_fused_generate(32, 32, 4, 7.5)(tp.params, ids, nids, src, lat)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 32, 32, 3)
    _images_close(got.numpy(), want)
    control = tp.control_from_src(src, 32, 32)
    unfused = tp.generate(["x"] * 2, lat, 32, 32, 4, 7.5, control_image=control, token_ids=ids,
                          negative_token_ids=nids)
    _images_close(torch.clamp(torch.round(unfused * 255), 0, 255).to(torch.uint8).numpy(), got.numpy())


def test_sdedit_unipc_matches_jax(unipc_pipes):
    """SDEdit + canny on the multistep grid: 10 steps at strength 0.5 run
    the last 5, the first of them from add_noise of the source's latents;
    against JAX's generate on the same source, noise and ids."""
    jp, tp = unipc_pipes
    jp.sdedit = True
    src, lat = _inputs(8)
    ids, nids = _ids()
    init = src.astype(np.float32) / 255.0
    control = tp.control_from_src(src, 32, 32)
    want = jp.generate(["x"] * 2, jax.random.PRNGKey(0), 32, 32, 10, 7.5,
                       control_image=jnp.asarray(control.numpy()), init_image=jnp.asarray(init),
                       sdedit_strength=0.5, latents=jnp.asarray(lat),
                       token_ids=jnp.asarray(ids), negative_token_ids=jnp.asarray(nids))
    got = tp.generate(["x"] * 2, lat, 32, 32, 10, 7.5, control_image=control, init_image=torch.from_numpy(init),
                      sdedit_strength=0.5, token_ids=ids, negative_token_ids=nids)
    q = lambda a: np.clip(np.round(np.asarray(a) * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    _images_close(q(got.numpy()), q(want))


def test_blip_fused_unipc_matches_jax():
    """BLIP-Diffusion (no ControlNet) takes the sampler too: its fused path
    at 64^2, 4 UniPC steps, CFG 7.5, against JAX's BlipDiffusionPipeline
    built with sampler="unipcmultistep", at tests/test_torch_blip.py's tiny
    configs and golden params."""
    from saspa_tpu.diffusion.pipelines import DiffusionPipeline as JaxDiffusionPipeline
    from saspa_tpu.models.blip_caption import WordPieceTokenizer as JaxWordPiece
    from saspa_tpu.models.blip_diffusion import QFormer as JaxQFormer
    from saspa_tpu.models.clip import CLIPVisionViT as JaxViT
    from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline
    from tests.test_diffusion_pipeline import TINY_TEXT, TINY_UNET, TINY_VAE
    from tests.test_torch_blip import (J_VISION, META, T_QFORMER, T_TEXT, T_UNET, T_VAE, T_VISION, _PresetJaxBlip,
                                       _refs, blip_params)

    params = blip_params()[None]
    tp = BlipDiffusionPipeline(controlnet=None, sampler="unipcmultistep", device="cpu", dtype=torch.float32,
                               init_seed=None, unet_cfg=T_UNET, vae_cfg=T_VAE, text_cfgs=T_TEXT, vision_cfg=T_VISION,
                               qformer_cfg=T_QFORMER)
    tp.load_flax_params(params)
    _PresetJaxBlip.preset = params
    jp = _PresetJaxBlip.__new__(_PresetJaxBlip)
    JaxDiffusionPipeline.__init__(jp, base_model="blip_diffusion", controlnet=None, sampler="unipcmultistep",
                                  dtype=jnp.float32, unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, text_cfgs=TINY_TEXT)
    jp.vision = JaxViT(cfg=J_VISION, dtype=jnp.float32)
    jp.qformer = JaxQFormer(width=32, layers=1, heads=2, out_dim=32, dtype=jnp.float32)
    for k in ("blip_vision", "blip_qformer"):
        jp.params[k] = jax.tree_util.tree_map(jnp.asarray, params[k])
    jp._bert_tok = JaxWordPiece(None)
    assert isinstance(tp.scheduler, tsched.UniPCScheduler) and isinstance(jp.scheduler, jsched.UniPCScheduler)
    rng = np.random.RandomState(9)
    b, res = 2, 64
    refs = _refs(10)
    src = (rng.rand(b, res, res, 3) * 255).astype(np.uint8)
    lat = rng.randn(b, res // tp.latent_factor, res // tp.latent_factor, 4).astype(np.float32)
    ids = tp.build_subject_prompt_ids(["flying over mountains", "parked at night"], META)
    nids = tp.tokenizer([""] * b, pad="eot")
    cat_ids, cat_mask = tp.bert_category_ids(META, b)
    want = jp.make_fused_generate(res, res, 4, 7.5)(
        jp.params, *map(jnp.asarray, (ids, nids, cat_ids, cat_mask, refs, src, lat)))
    got = tp.make_fused_generate(res, res, 4, 7.5)(tp.params, ids, nids, cat_ids, cat_mask, refs, src, lat)
    _images_close(got.numpy(), want)
