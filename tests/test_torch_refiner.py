"""Parity of the port's SDXL refiner (`--base_model sd_xl --sdedit
--controlnet none`) with the JAX package, on the CPU.

A tiny refiner config (`J_REF`: plain blocks at both ends and a cross-
attention level between, as SDXL_REFINER_UNET has them, linear projections,
the bigG-style tower of tests/test_golden_families.py's GX_TEXT alone as
the text, add_embedding input 32 pooled + 5 time ids x 8) with GX_VAE, in
f32: the towers and VAE take tests/fixtures/golden_gen_xl.npz's params, the
UNet a seeded tree from the port's parameter shapes, both packages the same
numpy params through the bridge and the same numpy inputs.  SDEdit's
`generate` under CFG against JAX's `DiffusionPipeline("sd_xl-refiner",
sdedit=True)`: images within 1e-4 of the largest, uint8 within 1 level on
>= 99% of the pixels (tests/test_torch_blip.py::_images_close).  Then the
5 time ids (aesthetic score 6.0 for the prompt, 2.5 for the negative),
`init_pipeline`'s mapping in both packages, the full-width config and
parameter count, the loader on tools/synth_checkpoints.py's layout, and
the refusals that remain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.diffusion import pipelines as jpipelines
from saspa_tpu.models import unet as j_unet
from saspa_tpu_torch.diffusion import pipelines as tpipelines
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, PipelineSpec
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.weights import convert as pconv
from saspa_tpu_torch.weights import load as pload
from saspa_tpu_torch.weights.files import write_safetensors
from tests.test_golden_families import GOLDEN_XL_PATH, GX_TEXT, GX_VAE
from tests.test_golden_generation import _unflatten_params
from tests.test_torch_blip import _close, _images_close, random_flax_tree
from tests.test_torch_pipeline import _inputs, _PresetJaxPipeline
from tests.test_torch_xl import P_GX_TEXT, P_GX_VAE, port_cfg
from tools import convert_weights as jconv
from tools import synth_checkpoints as synth

F32 = torch.float32

J_REF = dataclasses.replace(
    j_unet.SDXL_REFINER_UNET, block_out_channels=(32, 64, 64), layers_per_block=1,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 2, 2), num_attention_heads=(2, 2, 2), cross_attention_dim=32,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=32 + 5 * 8)
P_REF = port_cfg(t_unet.UNetConfig, J_REF)
J_TEXT, P_TEXT = (GX_TEXT[1],), (P_GX_TEXT[1],)
TORCH_REF = dict(in_channels=4, out_channels=4, block_out_channels=J_REF.block_out_channels,
                 layers_per_block=1, down_block_types=J_REF.down_block_types, up_block_types=J_REF.up_block_types,
                 transformer_layers_per_block=J_REF.transformer_layers_per_block, cross_attention_dim=32,
                 use_linear_projection=True, addition_embed_type="text_time",
                 projection_class_embeddings_input_dim=J_REF.projection_class_embeddings_input_dim)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several worker processes share a few cores (tests/test_torch_sdedit.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port(params=None, sampler="ddim") -> DiffusionPipeline:
    tp = DiffusionPipeline("sd_xl-refiner", None, sampler=sampler, device="cpu", dtype=F32, init_seed=None,
                           unet_cfg=P_REF, vae_cfg=P_GX_VAE, text_cfgs=P_TEXT)
    if params is not None:
        tp.load_flax_params(params)
    return tp


def _jax(params, sampler="ddim"):
    _PresetJaxPipeline.preset = params
    return _PresetJaxPipeline(base_model="sd_xl-refiner", controlnet=None, sdedit=True, sampler=sampler,
                              dtype=jnp.float32, unet_cfg=J_REF, vae_cfg=GX_VAE, text_cfgs=J_TEXT)


@pytest.fixture(scope="module")
def params():
    """golden_gen_xl's bigG-style tower and VAE, a seeded refiner UNet."""
    base = _unflatten_params(np.load(GOLDEN_XL_PATH))
    unet = random_flax_tree(_port().params["unet"], np.random.RandomState(17))
    return {"text": [base["text"][1]], "vae": base["vae"], "unet": unet}


def test_configs_match_jax():
    """SDXL_REFINER_UNET field for field; the spec: bigG alone, SDXL's VAE,
    leading spacing."""
    assert port_cfg(t_unet.UNetConfig, j_unet.SDXL_REFINER_UNET) == t_unet.SDXL_REFINER_UNET
    assert t_unet.UNET_CONFIGS["sd_xl-refiner"] == t_unet.SDXL_REFINER_UNET
    js, ts = jpipelines._spec("sd_xl-refiner"), tpipelines._spec("sd_xl-refiner")
    assert ts.is_xl and js.is_xl and len(ts.text_cfgs) == 1 and ts.text_cfgs[0].width == 1280
    assert ts.scheduler_cfg.timestep_spacing == js.scheduler_cfg.timestep_spacing == "leading"


def test_full_width_refiner_unet_shapes():
    """At the published widths (384/768/1536/1536, depth 4, heads 6/12/24,
    cross width 1280, add_embedding 2560) the port's UNet holds the flax
    tree's leaves in the bridge's layout, ~2.3 B parameters (meta device)."""
    cfg = j_unet.SDXL_REFINER_UNET
    ac = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, 5))}
    tree = jax.eval_shape(lambda: j_unet.UNet2DCondition(cfg=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 1280)),
        added_cond=ac))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        shape = tuple(leaf.shape)
        if path[-1].key == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        want[".".join(k.key for k in path)] = shape
    unet = t_unet.UNet2DCondition(t_unet.SDXL_REFINER_UNET, device="meta")
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == want
    n = sum(p.numel() for p in unet.parameters())
    assert 2.2e9 < n < 2.35e9, n


def test_time_ids_match_jax(params):
    """(h, w, 0, 0, 6.0) for the prompt, (h, w, 0, 0, 2.5) for the
    negative; the base models keep their 6 ids, alike for both."""
    tp = _port(params)
    jp = _jax(params)
    want, nwant = jp._make_time_ids(3, 64, 48)
    assert np.array_equal(tp.make_time_ids(3, 64, 48).numpy(), np.asarray(want))
    assert np.array_equal(tp.make_time_ids(3, 64, 48, negative=True).numpy(), np.asarray(nwant))
    assert tp.make_time_ids(1, 64, 48).tolist() == [[64, 48, 0, 0, 6.0]]
    assert tp.make_time_ids(1, 64, 48, negative=True).tolist() == [[64, 48, 0, 0, 2.5]]
    base = DiffusionPipeline.__new__(DiffusionPipeline)
    base.base_model, base.device = "sd_xl", "cpu"
    assert base.make_time_ids(1, 64, 48).tolist() == base.make_time_ids(1, 64, 48, True).tolist() == \
        [[64, 48, 0, 0, 64, 48]]


@pytest.mark.parametrize("sampler", ["ddim", "unipcmultistep"])
def test_sdedit_generate_matches_jax(params, sampler):
    """SDEdit at 32^2 (16x16 latents), CFG 7.5, 4 steps at strength 0.5:
    the source's posterior mean, add_noise, 2 steps of the truncated
    schedule under the prompt's and the negative's (2.5) conditions, the
    decode; against JAX's refiner pipeline."""
    jp, tp = _jax(params, sampler), _port(params, sampler)
    assert type(tp.scheduler).__name__ == type(jp.scheduler).__name__
    src, lat = _inputs(11, b=2, size=32)
    init = src.astype(np.float32) / 255.0
    ids = tp.tokenizer(["a photo of a warbler", "a small bird on a twig"], pad="eot")
    nids = tp.tokenizer(["blurry, low quality"] * 2, pad="eot")
    want = jp.generate(["x"] * 2, jax.random.PRNGKey(0), 32, 32, 4, 7.5, init_image=jnp.asarray(init),
                       sdedit_strength=0.5, latents=jnp.asarray(lat), token_ids=jnp.asarray(ids),
                       negative_token_ids=jnp.asarray(nids))
    got = tp.generate(["x"] * 2, lat, 32, 32, 4, 7.5, init_image=torch.from_numpy(init), sdedit_strength=0.5,
                      token_ids=ids, negative_token_ids=nids)
    assert tuple(got.shape) == (2, 32, 32, 3)
    _close(got, want, 1e-4)
    q = lambda a: np.clip(np.round(np.asarray(a) * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    _images_close(q(got.numpy()), q(want))


def test_negative_aesthetic_score_enters_the_result(params, monkeypatch):
    """Handing the negative the prompt's score (6.0) changes the images: the
    2.5 is what the comparison above holds."""
    tp = _port(params)
    src, lat = _inputs(11, b=2, size=32)
    kw = dict(init_image=torch.from_numpy(src.astype(np.float32) / 255.0), sdedit_strength=0.5,
              token_ids=tp.tokenizer(["a bird"] * 2, pad="eot"), negative_token_ids=tp.tokenizer([""] * 2, pad="eot"))
    right = tp.generate(["x"] * 2, lat, 32, 32, 4, 7.5, **kw)
    real = tp.make_time_ids
    monkeypatch.setattr(tp, "make_time_ids", lambda b, h, w, negative=False: real(b, h, w))
    wrong = tp.generate(["x"] * 2, lat, 32, 32, 4, 7.5, **kw)
    assert float((right - wrong).abs().max()) > 1e-3


class _Recorder:
    def __init__(self, *args, **kwargs):
        _Recorder.calls.append((args, kwargs))


@pytest.mark.parametrize("base_model,controlnet,sdedit,want", [
    ("sd_xl", None, True, "sd_xl-refiner"), ("sd_xl", "canny", True, "sd_xl"), ("sd_xl", None, False, "sd_xl"),
    ("sd_xl-turbo", None, True, "sd_xl-turbo")])
def test_init_pipeline_maps_sd_xl_sdedit_to_the_refiner(monkeypatch, base_model, controlnet, sdedit, want):
    """init_pipeline(base, controlnet, SDEdit) builds the model JAX's does:
    the refiner exactly for sd_xl + SDEdit without a ControlNet."""
    got = []
    for mod in (jpipelines, tpipelines):
        _Recorder.calls = []
        monkeypatch.setattr(mod, "DiffusionPipeline", _Recorder)
        mod.init_pipeline(base_model, controlnet, SDEdit=sdedit)
        (args, kwargs), = _Recorder.calls
        got.append(kwargs.get("base_model", args[0] if args else None))
    assert got == [want, want]


def test_refusals_left(monkeypatch):
    """No generation family is refused any more: the refiner and UniPC, and
    SD2.1 and the HED ControlNet, build the pipeline JAX's init_pipeline
    builds (the refusal helpers are gone)."""
    assert not hasattr(tpipelines, "unported_family") and not hasattr(tpipelines, "refuse_unported")
    got = []
    for mod in (jpipelines, tpipelines):
        _Recorder.calls = []
        monkeypatch.setattr(mod, "DiffusionPipeline", _Recorder)
        for args, kw in ((("sd_v2.1", "canny"), {}), (("sd_v1.5", "hed"), {}), (("sd_xl", None), {"SDEdit": True}),
                         (("sd_v1.5", "canny"), {"sampler": "unipcmultistep"})):
            mod.init_pipeline(*args, **kw)
        got.append([(kwargs.get("base_model", a[0] if a else None), kwargs["controlnet"], kwargs["sampler"])
                    for a, kwargs in _Recorder.calls])
    assert got[0] == got[1] == [("sd_v2.1", "canny", "ddim"), ("sd_v1.5", "hed", "ddim"),
                                ("sd_xl-refiner", None, "ddim"), ("sd_v1.5", "canny", "unipcmultistep")]


def _tiny_specs(monkeypatch):
    real = tpipelines._spec

    def spec(base_model):
        s = real(base_model)
        return PipelineSpec(s.is_xl, P_TEXT, P_GX_VAE, s.scheduler_cfg)

    monkeypatch.setattr(tpipelines, "_spec", spec)
    monkeypatch.setitem(tpipelines.UNET_CONFIGS, "sd_xl-refiner", P_REF)


def test_loader_takes_the_refiner_layout(tmp_path, monkeypatch):
    """init_pipeline("sd_xl", None, SDEdit=True, weights_dir=tree) on the
    public layout (`*xl-refiner*/unet/`, the fp16-fix VAE, the turbo tree's
    text_encoder_2, as weights_day composes sd_xl-refiner) at the tiny
    config: strict loads, every key of every file used and every parameter
    loaded; the port's converter gives tools/convert_weights.py's tree bit
    for bit."""
    rng = np.random.RandomState(21)
    unet_sd = synth.diffusers_unet_state_dict(TORCH_REF, fill=rng)
    vae_sd = synth.diffusers_vae_state_dict(dict(block_out_channels=GX_VAE.block_out_channels,
                                                 layers_per_block=GX_VAE.layers_per_block, in_channels=3,
                                                 out_channels=3, latent_channels=4), fill=rng, legacy_attn=False)
    text_sd = synth.hf_clip_text_state_dict(width=32, layers=2, projection_dim=32, fill=rng)
    for rel, sd in (("stable-diffusion-xl-refiner-1.0/unet/diffusion_pytorch_model.safetensors", unet_sd),
                    ("sdxl-vae-fp16-fix/diffusion_pytorch_model.safetensors", vae_sd),
                    ("sdxl-turbo/text_encoder_2/model.safetensors", text_sd)):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        write_safetensors(tmp_path / rel, sd)
    want = jconv.convert_sd_unet(unet_sd, J_REF)
    got = pconv.convert_sd_unet(unet_sd, P_REF)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    assert flat(got).keys() == flat(want).keys()
    assert all(np.array_equal(np.asarray(flat(got)[k]), np.asarray(v)) for k, v in flat(want).items())

    _tiny_specs(monkeypatch)
    monkeypatch.setattr(pload, "REPORT_SUMS", True)
    tp = tpipelines.init_pipeline("sd_xl", None, SDEdit=True, weights_dir=str(tmp_path), device="cpu", dtype=F32)
    assert tp.base_model == "sd_xl-refiner" and tp.weights_loaded
    assert sorted(r["model"] for r in tp.load_report) == ["text", "unet", "vae"]
    for r in tp.load_report:
        assert r["unconsumed"] == 0 and r["params"] == r["module_params"], r
        assert r["loaded_sum"] == pytest.approx(r["rounded_sum"], rel=1e-6)
    assert "xl-refiner" in next(r["file"] for r in tp.load_report if r["model"] == "unet")
