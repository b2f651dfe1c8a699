"""Parity of the port's InstructPix2Pix path (ALIA's editor for
planes_biased) with the JAX package, on the CPU.

The 8-channel UNet, the unscaled posterior mean as the image condition,
3-way guidance over [cond, uncond, uncond] contexts and [img, img, 0] image
latents, the single forward when image guidance is below 1, the
`golden_gen_ip2p.npz` replay, and the driver's planes_biased ALIA run
(`cli gen --preset alia --dataset planes_biased`: 100 steps, image guidance
1.3, no SDEdit) against the JAX driver's PNGs.  Tiny configs in f32:
tests/test_golden_families.py::build_ip2p_pipe's (the tiny SD1.5 of
tests/test_diffusion_pipeline.py with in_channels 8), the golden fixture's
params on both sides (the port's through the bridge).  Inputs are numpy
arrays from a seed, handed to both packages.  Tolerances: float images
within 1e-4 of the largest (f32 summation order differs between XLA and
torch on the CPU), as tests/test_torch_sdedit.py's; uint8 images within 1
level on >= 99% of the pixels (tests/test_torch_blip.py::_images_close).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saspa_tpu.data.registry as JR
import saspa_tpu_torch.data.registry as TR
from saspa_tpu.utils.config import GenerationConfig as JaxGenerationConfig
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, init_pipeline, quantize
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.models.unet import UNET_CONFIGS
from saspa_tpu_torch.utils.config import GenerationConfig
from tests.test_diffusion_pipeline import TINY_TEXT, TINY_UNET, TINY_VAE
from tests.test_generation_driver import StubPlanesUtils
from tests.test_golden_families import GOLDEN_IP2P_PATH
from tests.test_golden_generation import _unflatten_params
from tests.test_torch_blip import T_TEXT, T_UNET, T_VAE, _images_close
from tests.test_torch_driver import _pngs
from tests.test_torch_pipeline import _close, _PresetJaxPipeline

T_UNET8 = dataclasses.replace(T_UNET, in_channels=8)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


_PIPES = {}


def ip2p_pipes():
    """The JAX and port ip2p pipelines on golden_gen_ip2p.npz's params, built once."""
    if not _PIPES:
        params = _unflatten_params(np.load(GOLDEN_IP2P_PATH))
        _PresetJaxPipeline.preset = params
        jp = _PresetJaxPipeline(base_model="ip2p", controlnet=None, sampler="ddim", dtype=jnp.float32,
                                unet_cfg=dataclasses.replace(TINY_UNET, in_channels=8), vae_cfg=TINY_VAE,
                                text_cfgs=TINY_TEXT)
        tp = DiffusionPipeline("ip2p", controlnet=None, device="cpu", dtype=torch.float32, init_seed=None,
                               unet_cfg=T_UNET8, vae_cfg=T_VAE, text_cfgs=T_TEXT)
        tp.load_flax_params(params)
        _PIPES.update(jax=jp, port=tp)
    return _PIPES["jax"], _PIPES["port"]


def test_ip2p_unet_config_and_refusals():
    """UNET_CONFIGS["ip2p"] is SD1.5's UNet with 8 input channels; ip2p with a
    ControlNet raises in the pipeline, init_pipeline and the driver, as the
    JAX package's; a control image given to generate raises in the sampler."""
    assert dataclasses.replace(UNET_CONFIGS["ip2p"], in_channels=4) == UNET_CONFIGS["sd_v1.5"]
    assert UNET_CONFIGS["ip2p"].in_channels == 8
    for build in (lambda: init_pipeline("ip2p", "canny"),
                  lambda: DiffusionPipeline("ip2p", controlnet="canny", device="cpu"),
                  lambda: tdriver._check_supported(GenerationConfig(base_model="ip2p", controlnet="canny"))):
        with pytest.raises(ValueError, match="ControlNet"):
            build()
    tdriver._check_supported(GenerationConfig.alia("planes_biased").with_dataset_overrides())
    _, tp = ip2p_pipes()
    img = np.zeros((1, 64, 64, 3), np.float32)
    lat = np.zeros((1, 32, 32, 4), np.float32)
    with pytest.raises(ValueError, match="control_image"):
        tp.generate(["x"], lat, height=64, width=64, num_inference_steps=1, init_image=img,
                    control_image=torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="init_image"):
        tp.generate(["x"], lat, height=64, width=64, num_inference_steps=1)


def test_golden_ip2p_replay():
    """tests/fixtures/golden_gen_ip2p.npz: 2 steps of 3-way guidance (7.5,
    image 1.3), its params, image, noise and token ids through the port's
    generate: within 1e-4 of the range, and as uint8 within 1 level on >=
    99% of the pixels."""
    npz = np.load(GOLDEN_IP2P_PATH)
    _, tp = ip2p_pipes()
    got = tp.generate(["golden ip2p make it snowy"], npz["latents"], height=64, width=64, num_inference_steps=2,
                      guidance_scale=7.5, init_image=npz["img"], image_guidance_scale=1.3,
                      token_ids=npz["token_ids"], negative_token_ids=npz["neg_token_ids"])
    _close(got, npz["expected"], rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(npz["expected"] * 255.0), 0, 255).astype(np.uint8))


def test_image_condition_is_the_unscaled_mean():
    """The image latents are the encoder's posterior mean, unscaled (JAX's
    `mean`), while SDEdit's z0 is scaled by 0.18215."""
    jp, tp = ip2p_pipes()
    img = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    from saspa_tpu.models.vae import AutoencoderKL as JaxVAE

    want, _ = jp.vae.apply({"params": jp.params["vae"]}, jnp.asarray(img) * 2.0 - 1.0, method=JaxVAE.encode)
    mean = tp.encode_mean(img)
    _close(mean.permute(0, 2, 3, 1), want, rel=2e-5)
    assert torch.equal(tp.encode_image(img), (mean * tp.vae_cfg.scaling_factor).permute(0, 2, 3, 1))


@pytest.mark.parametrize("gs,igs", [(7.5, 1.3), (5.0, 2.0), (7.5, 0.5), (1.0, 1.3)])
def test_generate_matches_jax(gs, igs):
    """Two images (different prompts, sources and noise) through both
    pipelines: 3-way guidance in diffusers' [text, image, uncond] order at
    two pairs of scales (a swapped order or the 2-way order moves the
    output far past the bound), and guidance off, by image guidance below 1
    or guidance 1 (one forward on [lat, img] against the prompt only)."""
    jp, tp = ip2p_pipes()
    rng = np.random.RandomState(int(10 * gs + igs * 7))
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    lat = rng.randn(2, 32, 32, 4).astype(np.float32)
    ids = tp.tokenizer(["make it snowy", "put it on a runway at dusk"], pad="eot")
    neg = tp.tokenizer(["blurry, low quality"] * 2, pad="eot")
    kw = dict(height=64, width=64, num_inference_steps=3, guidance_scale=gs, image_guidance_scale=igs,
              token_ids=ids, negative_token_ids=neg)
    want = jp.generate(["a", "b"], jax.random.PRNGKey(0), init_image=jnp.asarray(img), latents=jnp.asarray(lat), **kw)
    got = tp.generate(["a", "b"], lat, init_image=img, **kw)
    _close(got, want, rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(np.asarray(want) * 255.0), 0, 255).astype(np.uint8))


@pytest.fixture()
def biased_tree(tmp_path, monkeypatch):
    """Three 96x128 JPEG sources of a stub planes_biased tree in both
    registries (StubPlanesUtils: one class string, the gen side's reader)."""
    from PIL import Image

    images = tmp_path / "ds" / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(images / f"{2100000 + i}.jpg")

    def stub(print_func=print):
        return StubPlanesUtils(tmp_path / "ds", print_func)

    monkeypatch.setitem(JR.DS_UTILS_DICT, "planes_biased", stub)
    monkeypatch.setitem(TR.DS_UTILS_DICT, "planes_biased", stub)
    return tmp_path


RUN_STEPS = 3  # the recipe's 100 steps of the tiny UNet take minutes on the CPU


def _steps_checked(generate, calls):
    """generate, recording the steps and image guidance each call asks for
    and running RUN_STEPS of them."""
    def run(*a, num_inference_steps, image_guidance_scale, **kw):
        calls.append((num_inference_steps, image_guidance_scale))
        return generate(*a, num_inference_steps=RUN_STEPS, image_guidance_scale=image_guidance_scale, **kw)

    return run


def test_run_generation_alia_planes_biased_matches_generate_and_jax(biased_tree, monkeypatch):
    """The ALIA preset on planes_biased through both drivers: 3 sources, one
    prompt each, batch 2 (the second padded), 64^2, ip2p's generate asked
    for 100 steps and image guidance 1.3 whatever the config's 30 says (each
    pipeline runs 3 of them here), no SDEdit folder suffix.  The PNGs agree
    with the JAX driver's and with quantize of the port's generate on the
    same batches (sources / 255, the items' noise), within 1 uint8 level on
    >= 99% of the pixels; the _source files are bit-equal."""
    from saspa_tpu.gen.driver import run_generation as jax_run_generation
    from saspa_tpu_torch.gen.image_io import read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    jp, tp = ip2p_pipes()
    calls = {"jax": [], "port": []}
    generate = tp.generate
    monkeypatch.setattr(jp, "generate", _steps_checked(jp.generate, calls["jax"]))
    monkeypatch.setattr(tp, "generate", _steps_checked(tp.generate, calls["port"]))
    cfg = GenerationConfig.alia("planes_biased", num_per_image=1, seed=4, batch_size=2, resolution=64)
    jcfg = JaxGenerationConfig.alia("planes_biased", num_per_image=1, seed=4, batch_size=2, resolution=64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    c = cfg.with_dataset_overrides()
    assert (c.base_model, c.controlnet, c.sdedit, c.num_inference_steps) == ("ip2p", None, False, 30)
    want_dir = jax_run_generation(jcfg, pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir and got_dir.endswith("/regular/ip2p/None/ALIA_prompt_w_sub_class_seed_4/images")
    got = _pngs(got_dir)
    assert calls["jax"] == calls["port"] == [(100, 1.3)] * 2
    assert sorted(got) == sorted(want) and len(got) == 3 + 3
    for name in got:
        if "_prompt_" in name:
            _images_close(got[name], want[name])
        else:
            assert np.array_equal(got[name], want[name]), name

    ds = TR.DS_UTILS_DICT["planes_biased"]()
    engine = PromptEngine(c, ds, ds.get_image_stem_to_class_str_dict())
    paths = ds.original_images_paths
    items = [(i, p) for i, p in enumerate(paths)]
    for lo in range(0, 3, 2):
        chunk = items[lo:lo + 2]
        chunk += chunk[-1:] * (2 - len(chunk))
        src = np.stack([resize_image(read_rgb(p), 64) for _, p in chunk])
        lat = np.stack([rngs.item_normal(c.seed, "noise", i, 0, shape=(32, 32, 4)) for i, _ in chunk])
        prompts = [engine.build(p, i, 0) for i, p in chunk]
        out = quantize(generate(prompts, lat, height=64, width=64, num_inference_steps=RUN_STEPS,
                                   guidance_scale=c.guidance_scale, negative_prompt=c.negative_prompt,
                                   init_image=torch.from_numpy(src).float() / 255.0,
                                   image_guidance_scale=tdriver.IP2P_IMAGE_GUIDANCE)).numpy()
        for (i, p), prompt, img in zip(chunk, prompts, out):
            _images_close(got[f"{Path(p).stem}_prompt_{prompt.replace('/', '-')}_0.png"], img)


def test_ip2p_loads_from_its_files_and_matches_jax(tmp_path, monkeypatch):
    """InstructPix2Pix's public files (timbrooks/instruct-pix2pix: unet with an
    8-channel conv_in, vae with the 2022 attention names, text_encoder) at
    tiny configs under `*instruct-pix2pix*/`: init_pipeline loads every
    model strictly (0 keys left, every parameter from its file), and its
    generate equals the JAX pipeline's on convert_weights' trees of the
    same files."""
    from saspa_tpu_torch.diffusion import pipelines as tpipelines
    from saspa_tpu_torch.weights import load as pload
    from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
    from tests.test_torch_weights import P_G_TEXT, P_G_UNET, P_G_VAE, TORCH_G_UNET, TORCH_VAE, _text_sd, _write
    from tools import convert_weights as jconv
    from tools import synth_checkpoints as synth

    sds = {"unet": synth.diffusers_unet_state_dict(dict(TORCH_G_UNET, in_channels=8),
                                                   fill=np.random.RandomState(21)),
           "vae": synth.diffusers_vae_state_dict(TORCH_VAE, fill=np.random.RandomState(22)),
           "text_encoder": _text_sd(G_TEXT[0], 23)}
    for folder, sd in sds.items():
        _write(tmp_path, f"timbrooks-instruct-pix2pix/{folder}/diffusion_pytorch_model.safetensors", sd)
    real = tpipelines._spec
    monkeypatch.setattr(tpipelines, "_spec", lambda base: tpipelines.PipelineSpec(
        False, P_G_TEXT, P_G_VAE, real(base).scheduler_cfg))
    monkeypatch.setitem(tpipelines.UNET_CONFIGS, "ip2p", dataclasses.replace(P_G_UNET, in_channels=8))
    tp = init_pipeline("ip2p", None, weights_dir=str(tmp_path), device="cpu", dtype=torch.float32)
    assert tp.weights_loaded and tp.params["unet"].conv_in.kernel.shape[1] == 8
    assert sorted(r["model"] for r in tp.load_report) == ["text", "unet", "vae"]
    assert all(r["unconsumed"] == 0 and r["params"] == r["module_params"] for r in tp.load_report)
    assert all("instruct-pix2pix" in r["file"] for r in tp.load_report)
    assert pload.find_source(tmp_path, "sd15_unet") is None

    cfg8 = dataclasses.replace(G_UNET, in_channels=8)
    _PresetJaxPipeline.preset = {"text": [jconv.convert_clip_text_hf(sds["text_encoder"], 2)],
                                 "unet": jconv.convert_sd_unet(sds["unet"], cfg8),
                                 "vae": jconv.convert_vae(sds["vae"], G_VAE)}
    jp = _PresetJaxPipeline(base_model="ip2p", controlnet=None, sampler="ddim", dtype=jnp.float32, unet_cfg=cfg8,
                            vae_cfg=G_VAE, text_cfgs=G_TEXT)
    rng = np.random.RandomState(24)
    img, lat = rng.rand(1, 32, 32, 3).astype(np.float32), rng.randn(1, 16, 16, 4).astype(np.float32)
    ids = tp.tokenizer(["make it a sunny runway"], pad="eot")
    neg = tp.tokenizer(["blurry"], pad="eot")
    kw = dict(height=32, width=32, num_inference_steps=2, guidance_scale=7.5, image_guidance_scale=1.3,
              token_ids=ids, negative_token_ids=neg)
    want = jp.generate(["a"], jax.random.PRNGKey(0), init_image=jnp.asarray(img), latents=jnp.asarray(lat), **kw)
    _close(tp.generate(["a"], lat, init_image=img, **kw), want, rel=1e-4)
