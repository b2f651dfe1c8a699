"""Parity of the port's SDEdit path with the JAX package, on the CPU.

The VAE encoder, DDIM's add_noise and the strength-truncated schedule, the
pipeline's SDEdit `generate` (tests/fixtures/golden_gen_sdedit.npz replayed,
and SDEdit + canny against the JAX pipeline), the Real-Guidance and ALIA
presets, `cli gen --preset`, and `run_generation` with SDEdit.  Tiny
configs in f32: tests/test_golden_families.py::build_sdedit_pipe's (the
tiny SD1.5 of tests/test_diffusion_pipeline.py) for the golden replay,
tests/test_torch_pipeline.py's canny pipelines elsewhere, params carried
into the port through the bridge.  Inputs are numpy arrays from a seed,
handed to both packages.  Tolerances: the encoder's moments within 2e-5 of
the largest |want| (f32 summation order differs between XLA and torch on
the CPU), as tests/test_torch_clip_cal.py's; the schedule and add_noise
exactly; float images within 1e-4 of the largest, uint8 images within 1
level on >= 99% of the pixels (tests/test_torch_blip.py::_images_close).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from saspa_tpu.diffusion.schedulers import SchedulerConfig as JaxSchedulerConfig
from saspa_tpu.diffusion.schedulers import sdedit_start_step as jax_start_step
from saspa_tpu.models.vae import AutoencoderKL as JaxVAE
from saspa_tpu.utils.config import GenerationConfig as JaxGenerationConfig
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, quantize
from saspa_tpu_torch.diffusion.schedulers import DDIMScheduler, SchedulerConfig, sdedit_start_step
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.utils.config import DATASETS_SUPPORTED, GenerationConfig
from tests.test_diffusion_pipeline import TINY_VAE
from tests.test_golden_families import GOLDEN_SDEDIT_PATH
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE, GOLDEN_PATH, _unflatten_params
from tests.test_torch_blip import T_TEXT, T_UNET, T_VAE, _images_close
from tests.test_torch_driver import _cfg, _jax_cfg, _pngs, stub_tree  # noqa: F401 (a fixture)
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, _close, _inputs, _ids, tiny_params


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _moments_close(got, want):
    """2e-5 of the largest |want|, elementwise."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 2e-5 * scale, (err, scale)


# ---- the VAE encoder ---------------------------------------------------------

@pytest.mark.parametrize("fixture,hw", [("sdedit", (64, 64)), ("sdedit", (48, 80)), ("golden", (32, 32))])
def test_encoder_matches_flax(fixture, hw):
    """AutoencoderKL.encode's (mean, logvar) against flax's on the same
    params (golden_gen_sdedit's tiny VAE, also off-square, where the
    bottom/right-only downsample padding shows; golden_gen's), an input in
    [-1, 1] from a seed."""
    path, jcfg = (GOLDEN_SDEDIT_PATH, TINY_VAE) if fixture == "sdedit" else (GOLDEN_PATH, G_VAE)
    tree = _unflatten_params(np.load(path))["vae"]
    x = np.random.RandomState(sum(hw)).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = JaxVAE(cfg=jcfg, dtype=jnp.float32).apply({"params": tree}, jnp.asarray(x), method=JaxVAE.encode)
    vae = t_vae.AutoencoderKL(t_vae.VAEConfig(block_out_channels=jcfg.block_out_channels,
                                              layers_per_block=jcfg.layers_per_block))
    vae.load_state_dict(state_dict_from_flax(tree), strict=True)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    f = 2 ** (len(jcfg.block_out_channels) - 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 4, hw[0] // f, hw[1] // f)
        _moments_close(g.permute(0, 2, 3, 1), w)
    assert float(got[1].max()) <= 20.0 and float(got[1].min()) >= -30.0


# ---- the schedule ------------------------------------------------------------

@pytest.mark.parametrize("steps,strength,spacing,runs", [
    (50, 0.15, "leading", 7), (30, 0.5, "leading", 15), (30, 0.85, "leading", 25), (2, 0.5, "trailing", 1),
    (2, 0.85, "trailing", 1)])
def test_start_step_and_add_noise_match_jax(steps, strength, spacing, runs):
    """sdedit_start_step truncates steps * strength as Python does (50 x
    0.15 runs 7 steps); the kept timesteps and the f32 alphas_cumprod equal
    JAX's; add_noise at the first kept timestep within 2 f32 ulps of its
    terms' magnitude of JAX's (XLA may fuse the multiply-add), for f32
    inputs and a bf16 z0, which both promote against the f32 a_t."""
    start = sdedit_start_step(steps, strength)
    assert start == jax_start_step(steps, strength) and steps - start == runs
    sched, jsched = DDIMScheduler(SchedulerConfig(timestep_spacing=spacing)), \
        JaxDDIM(JaxSchedulerConfig(timestep_spacing=spacing))
    ts = sched.timesteps(steps)[start:]
    assert np.array_equal(ts, np.asarray(jsched.timesteps(steps))[start:])
    assert np.array_equal(sched.alphas_cumprod.numpy(), np.asarray(jsched.alphas_cumprod))
    a = float(sched.alphas_cumprod[int(ts[0])])
    rng = np.random.RandomState(steps + int(100 * strength))
    z0, noise = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    for z in (torch.from_numpy(z0), torch.from_numpy(z0).bfloat16()):
        jz = jnp.asarray(z.float().numpy(), jnp.bfloat16 if z.dtype == torch.bfloat16 else jnp.float32)
        want = np.asarray(jsched.add_noise(jz, jnp.asarray(noise), jnp.asarray(ts)[0]))
        got = sched.add_noise(z, torch.from_numpy(noise), ts[0])
        assert want.dtype == np.float32 and got.dtype == torch.float32
        mag = np.sqrt(a) * np.abs(z.float().numpy()) + np.sqrt(1 - a) * np.abs(noise)
        assert (np.abs(got.numpy() - want) <= 2 * np.finfo(np.float32).eps * mag).all()


# ---- the pipeline -------------------------------------------------------------

def test_golden_sdedit_replay():
    """tests/fixtures/golden_gen_sdedit.npz: 6 steps at strength 0.5 (3 run),
    CFG 7.5, no ControlNet, its params, image, noise and token ids through
    the port's generate: within 1e-4 of the range, and as uint8 within 1
    level on >= 99% of the pixels."""
    npz = np.load(GOLDEN_SDEDIT_PATH)
    tp = DiffusionPipeline(controlnet=None, device="cpu", dtype=torch.float32, init_seed=None, unet_cfg=T_UNET,
                           vae_cfg=T_VAE, text_cfgs=T_TEXT)
    tp.load_flax_params(_unflatten_params(npz))
    got = tp.generate(["golden sdedit regression"], height=64, width=64, num_inference_steps=6, guidance_scale=7.5,
                      init_image=npz["img"], sdedit_strength=0.5, latents=npz["latents"],
                      token_ids=npz["token_ids"], negative_token_ids=npz["neg_token_ids"])
    _close(got, npz["expected"], rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(npz["expected"] * 255.0), 0, 255).astype(np.uint8))


_PIPES = {}


def sdedit_pipes(controlnet="canny"):
    """The JAX and port SDEdit pipelines (with the canny ControlNet, or
    none) on tests/test_torch_pipeline.py's params, built once."""
    if controlnet not in _PIPES:
        params = tiny_params()
        _PresetJaxPipeline.preset = params
        jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet=controlnet, sdedit=True, sampler="ddim",
                                dtype=jnp.float32, unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
        tp = DiffusionPipeline(controlnet=controlnet, device="cpu", dtype=torch.float32, init_seed=None,
                               unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
        tp.load_flax_params({k: v for k, v in params.items() if controlnet or k != "controlnet"})
        _PIPES[controlnet] = jp, tp
    return _PIPES[controlnet]


def test_sdedit_canny_matches_jax():
    """SDEdit + canny (the JAX driver's unfused path): the control image of
    the uint8 sources (JAX's _control_from_src against control_from_src,
    equal), then generate at strength 0.5 of 4 steps, CFG 7.5, scale 0.75,
    the sources / 255 as the image to edit."""
    jp, tp = sdedit_pipes("canny")
    src, lat = _inputs(8)
    ids, neg = _ids()
    jcontrol = jp._control_from_src(jp.params, jnp.asarray(src, jnp.float32), 32, 32, 120.0, 200.0)
    control = tp.control_from_src(src, 32, 32)
    assert np.array_equal(control.numpy(), np.asarray(jcontrol))
    kw = dict(height=32, width=32, num_inference_steps=4, guidance_scale=7.5, controlnet_scale=0.75,
              sdedit_strength=0.5, token_ids=ids, negative_token_ids=neg)
    want = jp.generate(["a", "b"], jax.random.PRNGKey(0), control_image=jcontrol,
                       init_image=jnp.asarray(src, jnp.float32) / 255.0, latents=jnp.asarray(lat), **kw)
    got = tp.generate(["a", "b"], control_image=control, init_image=torch.from_numpy(src).float() / 255.0,
                      latents=lat, **kw)
    _close(got, want, rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(np.asarray(want) * 255.0), 0, 255).astype(np.uint8))


def test_xl_turbo_sdedit_matches_jax():
    """ALIA on cub resolves to SDXL-Turbo + SDEdit without a ControlNet: 2
    trailing steps at strength 0.5 (one runs, from t = 499), guidance 0 (no
    negative tower), the time ids and the XL VAE's scaling 0.13025; the tiny
    XL pipelines of tests/test_torch_xl.py on their params."""
    from tests.test_torch_xl import jax_pipe, port_pipe, xl_params

    params = {k: v for k, v in xl_params().items() if k != "controlnet"}
    jp, tp = jax_pipe(params, "sd_xl-turbo", None), port_pipe(params, "sd_xl-turbo", None)
    jp.sdedit = True
    rng = np.random.RandomState(12)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    lat = rng.randn(2, 32, 32, 4).astype(np.float32)
    ids = tp.tokenizer(["a painted bunting on a branch", "a small grey bird"], pad="eot")
    kw = dict(height=64, width=64, num_inference_steps=2, guidance_scale=0.0, negative_prompt=None,
              sdedit_strength=0.5, token_ids=ids)
    want = jp.generate(["a", "b"], jax.random.PRNGKey(0), init_image=jnp.asarray(img), latents=jnp.asarray(lat), **kw)
    got = tp.generate(["a", "b"], init_image=img, latents=lat, **kw)
    _close(got, want, rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(np.asarray(want) * 255.0), 0, 255).astype(np.uint8))


# ---- the presets and the CLI ------------------------------------------------------

@pytest.mark.parametrize("preset", ["real_guidance", "alia"])
@pytest.mark.parametrize("dataset", DATASETS_SUPPORTED)
def test_presets_match_jax(preset, dataset):
    """GenerationConfig.real_guidance / .alia after with_dataset_overrides,
    field for field the JAX package's, and the same output folder; where
    JAX's assert refuses the preset (Real-Guidance on cub: 2 SDXL-Turbo
    steps at 0.15 run none), the port's refuses it too."""
    kw = dict(num_per_image=3, seed=5, batch_size=4)
    port, jax_ = getattr(GenerationConfig, preset)(dataset, **kw), getattr(JaxGenerationConfig, preset)(dataset, **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_)
    try:
        want = jax_.with_dataset_overrides()
    except AssertionError:
        with pytest.raises(AssertionError):
            port.with_dataset_overrides()
        assert (preset, dataset) == ("real_guidance", "cub")
        return
    got = port.with_dataset_overrides()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.output_folder("/d") == want.output_folder("/d")


@pytest.mark.parametrize("preset,dataset", [("real_guidance", "cars"), ("alia", "planes"), ("alia", "cub")])
def test_cli_preset_calls_the_jax_filter_recipe(preset, dataset, monkeypatch):
    """`gen --preset ...` through both CLIs, run_generation_and_filter
    replaced: the same GenerationConfig and the same filter kwargs (CLIP
    per-class for Real-Guidance; semantic + ALIA confidence for ALIA), with
    --skip_filter ignored as the JAX CLI ignores it; ALIA on cub resolves to
    SDXL-Turbo + SDEdit (2 trailing steps, strength 0.5: 1 runs)."""
    import saspa_tpu.cli as jcli
    import saspa_tpu.gen.driver as jdriver
    import saspa_tpu.utils.logging_utils as jlog
    import saspa_tpu_torch.cli as tcli

    seen = {}
    monkeypatch.setattr(jdriver, "run_generation_and_filter", lambda cfg, **kw: seen.setdefault("jax", (cfg, kw)))
    monkeypatch.setattr(tdriver, "run_generation_and_filter", lambda cfg, **kw: seen.setdefault("port", (cfg, kw)))
    monkeypatch.setattr(jlog, "init_logging", lambda **kw: None)
    monkeypatch.setattr("saspa_tpu.utils.enable_compilation_cache", lambda *a, **k: None)
    argv = ["gen", "--preset", preset, "--dataset", dataset, "--num_per_image", "1", "--seed", "3", "--batch_size",
            "4", "--skip_filter"]
    jcli.main(argv)
    tcli.main(argv)
    (pcfg, pkw), (jcfg, jkw) = seen["port"], seen["jax"]
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg) and pkw == jkw
    resolved = pcfg.with_dataset_overrides()
    assert resolved.sdedit and resolved.controlnet is None
    if dataset == "cub":
        assert (resolved.base_model, resolved.num_inference_steps) == ("sd_xl-turbo", 2)
        assert sdedit_start_step(2, resolved.sdedit_strength) == 1


# ---- run_generation ----------------------------------------------------------------

@pytest.mark.parametrize("controlnet", [None, "canny"])
def test_run_generation_sdedit_matches_generate_and_jax(stub_tree, controlnet):
    """`run_generation` with SDEdit (strength 0.5 of 4 steps; the canny
    case runs the ControlNet on the sources' edges) on the stub planes tree:
    3 sources x 2 prompts at 64^2, batch 4 (the second padded).  The PNGs
    agree with quantize of generate's output on the same batches of the
    same prompts, sources / 255 and noise (rebuilt here), and with the JAX
    driver's, within 1 uint8 level on >= 99% of the pixels (torch's CPU
    kernels can round differently between two calls of one process; the
    card's smoke holds the replay bit for bit); the _source and _control
    files are bit-equal."""
    import saspa_tpu_torch.data.registry as TR
    from saspa_tpu.gen.driver import run_generation as jax_run_generation
    from saspa_tpu_torch.gen.image_io import read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    jp, tp = sdedit_pipes(controlnet)
    cfg = _cfg(controlnet=controlnet, sdedit=True, sdedit_strength=0.5, num_inference_steps=4)
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir and "-SDEdit_strength_0.5/" in got_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 6 + 3 + (3 if controlnet else 0)
    for name in got:
        if "_prompt_" in name:
            _images_close(got[name], want[name])
        else:
            assert np.array_equal(got[name], want[name]), name

    c = cfg.with_dataset_overrides()
    ds = TR.DS_UTILS_DICT["planes"]()
    engine = PromptEngine(c, ds, ds.get_image_stem_to_class_str_dict())
    items = [(i, k, p) for i, p in enumerate(ds.original_images_paths) for k in range(2)]
    lf = tp.latent_factor
    for lo in range(0, len(items), 4):
        chunk = items[lo:lo + 4]
        chunk += chunk[-1:] * (4 - len(chunk))  # padded as the driver pads
        src = np.stack([resize_image(read_rgb(p), 64) for _, _, p in chunk])
        h, w = src.shape[1:3]
        lat = np.stack([rngs.item_normal(c.seed, "noise", i, k, shape=(h // lf, w // lf, 4)) for i, k, _ in chunk])
        prompts = [engine.build(p, i, k) for i, k, p in chunk]
        out = quantize(tp.generate(prompts, height=h, width=w, num_inference_steps=4, guidance_scale=7.5,
                                   negative_prompt=c.negative_prompt, control_image=tp.control_from_src(src, h, w),
                                   init_image=torch.from_numpy(src).float() / 255.0, sdedit_strength=0.5,
                                   latents=lat)).numpy()
        for (i, k, p), prompt, img in zip(chunk, prompts, out):
            _images_close(got[f"{Path(p).stem}_prompt_{prompt.replace('/', '-')}_{k}.png"], img)
