"""Parity of the port's SD2.1 (`--base_model sd_v2.1`) with the JAX package,
on the CPU.

A tiny SD2.1-shaped config (`J_SD21`: tests/test_golden_generation.py's
G_UNET with linear projections, per-level head counts (2 at the cross-
attention level, 4 in the mid block) and a 24-wide context) under a tiny
OpenCLIP-style tower (exact-erf GELU, read after ln_final, ids padded as
OpenCLIP pads them) and G_VAE, in f32: both packages take the same numpy
params (the golden fixture's VAE, seeded UNet, ControlNet and tower)
through the bridge and the same numpy inputs.  `generate` and the fused
function with the canny ControlNet against JAX's
`DiffusionPipeline("sd_v2.1", ...)`: images within 1e-4 of the largest,
uint8 within 1 level on >= 99% of the pixels
(tests/test_torch_blip.py::_images_close).  Then the configs and the spec,
the full-width UNet and tower against the flax trees' shapes (meta device),
and the loader on tools/synth_checkpoints.py's SD21_TORCH_CFG at tiny width
with the clear refusal of an SD2.1 ControlNet file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.diffusion import pipelines as jpipelines
from saspa_tpu.models import text_encoder as j_text
from saspa_tpu.models import unet as j_unet
from saspa_tpu_torch.diffusion import pipelines as tpipelines
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, PipelineSpec, quantize
from saspa_tpu_torch.models import text_encoder as t_text
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models.vae import SD_VAE
from saspa_tpu_torch.weights import convert as pconv
from saspa_tpu_torch.weights import load as pload
from saspa_tpu_torch.weights.files import write_safetensors
from tests.test_golden_generation import G_UNET, G_VAE, GOLDEN_PATH, _unflatten_params
from tests.test_torch_blip import _close, _images_close, random_flax_tree
from tests.test_torch_pipeline import P_VAE, _inputs, _PresetJaxPipeline
from tests.test_torch_xl import port_cfg
from tools import convert_weights as jconv
from tools import synth_checkpoints as synth

F32 = torch.float32

J_SD21 = dataclasses.replace(G_UNET, num_attention_heads=(2, 4), cross_attention_dim=24, use_linear_projection=True)
P_SD21 = port_cfg(t_unet.UNetConfig, J_SD21)
J_TEXT = (j_text.CLIPTextConfig(width=24, layers=2, heads=2, act="gelu", output_layer=-1),)
P_TEXT = tuple(port_cfg(t_text.CLIPTextConfig, c) for c in J_TEXT)
TORCH_SD21 = dict(synth.SD21_TORCH_CFG, block_out_channels=J_SD21.block_out_channels, layers_per_block=1,
                  down_block_types=J_SD21.down_block_types, up_block_types=J_SD21.up_block_types,
                  transformer_layers_per_block=J_SD21.transformer_layers_per_block, cross_attention_dim=24)
PROMPTS = ["a photo of a jet on the runway", "a small propeller plane"]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several worker processes share a few cores (tests/test_torch_sdedit.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port(params=None, controlnet="canny") -> DiffusionPipeline:
    tp = DiffusionPipeline("sd_v2.1", controlnet, device="cpu", dtype=F32, init_seed=None, unet_cfg=P_SD21,
                           vae_cfg=P_VAE, text_cfgs=P_TEXT)
    if params is not None:
        tp.load_flax_params(params)
    return tp


def _jax(params, controlnet="canny"):
    _PresetJaxPipeline.preset = params
    return _PresetJaxPipeline(base_model="sd_v2.1", controlnet=controlnet, sampler="ddim", dtype=jnp.float32,
                              unet_cfg=J_SD21, vae_cfg=G_VAE, text_cfgs=J_TEXT)


@pytest.fixture(scope="module")
def params():
    """The golden fixture's VAE; a seeded UNet, a ControlNet whose encoder
    is that UNet's, and a seeded OpenCLIP-style tower."""
    shell = _port()
    rng = np.random.RandomState(21)
    unet = random_flax_tree(shell.params["unet"], rng)
    return {"text": [random_flax_tree(shell.params["text"][0], rng)], "unet": unet,
            "controlnet": random_flax_tree(shell.params["controlnet"], rng, base=unet),
            "vae": _unflatten_params(np.load(GOLDEN_PATH))["vae"]}


def test_configs_and_spec_match_jax():
    """SD21_TEXT and SD21_UNET field for field; UNET_CONFIGS; the spec: the
    tower alone, the SD VAE (scaling 0.18215), leading spacing and the
    scheduler's default epsilon prediction, as JAX's `_spec` leaves them."""
    assert port_cfg(t_text.CLIPTextConfig, j_text.SD21_TEXT) == t_text.SD21_TEXT
    assert port_cfg(t_unet.UNetConfig, j_unet.SD21_UNET) == t_unet.SD21_UNET == t_unet.UNET_CONFIGS["sd_v2.1"]
    js, ts = jpipelines._spec("sd_v2.1"), tpipelines._spec("sd_v2.1")
    assert ts.text_cfgs == (t_text.SD21_TEXT,) and not ts.is_xl and not js.is_xl and ts.vae_cfg == SD_VAE
    assert dataclasses.asdict(ts.scheduler_cfg) == dataclasses.asdict(js.scheduler_cfg)
    assert ts.scheduler_cfg.prediction_type == "epsilon" and ts.scheduler_cfg.timestep_spacing == "leading"
    assert "sd_v2.1" in tpipelines.BASE_MODELS


def _flax_shapes(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        shape = tuple(leaf.shape)
        if path[-1].key == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        out[".".join(k.key for k in path)] = shape
    return out


def test_full_width_unet_and_tower_shapes():
    """At the published widths the port's SD2.1 UNet (heads 5/10/20/20 of
    d 64, context 1024, linear projections) and its OpenCLIP-H tower (23
    layers of 1024) hold the flax trees' leaves in the bridge's layout: about
    866 M and 340 M parameters (meta device)."""
    utree = jax.eval_shape(lambda: j_unet.UNet2DCondition(cfg=j_unet.SD21_UNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 1024))))
    unet = t_unet.UNet2DCondition(t_unet.SD21_UNET, device="meta")
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == _flax_shapes(utree["params"])
    assert sum(p.numel() for p in unet.parameters()) == 865_910_724  # the public UNet's count
    ttree = jax.eval_shape(lambda: j_text.CLIPTextEncoder(cfg=j_text.SD21_TEXT).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))
    tower = t_text.CLIPTextEncoder(t_text.SD21_TEXT, device="meta")
    assert {k: tuple(v.shape) for k, v in tower.state_dict().items()} == _flax_shapes(ttree["params"])
    assert 3.39e8 < sum(p.numel() for p in tower.parameters()) < 3.41e8


def test_text_tower_takes_openclip_padding(params):
    """The conditioning of EOT-padded ids is the tower's on OpenCLIP's
    padding (the first EOT kept, later ones 0), as JAX's `_encode_ids`."""
    tp, jp = _port(params), _jax(params)
    ids = tp.tokenizer(PROMPTS, pad="eot")
    ctx, pooled = tp.encode_ids(tp.params["text"], ids)
    jctx, jpooled = jp._encode_ids(jp.params["text"], jnp.asarray(ids))
    _close(ctx, jctx, 1e-5)
    _close(pooled, jpooled, 1e-5)
    raw = tp.params["text"][0](torch.as_tensor(ids).long())["hidden"]
    assert float((raw - ctx).abs().max()) > 1e-3  # the padding enters the hidden states


@pytest.mark.parametrize("entry", ["generate", "fused"])
def test_sd21_canny_matches_jax(params, entry):
    """SD2.1 + canny at 32^2 (16x16 latents), 3 DDIM steps, CFG 7.5, scale
    0.75: `generate` on the control image of control_from_src, or the fused
    function on the uint8 sources, against JAX's pipeline."""
    tp, jp = _port(params), _jax(params)
    src, lat = _inputs(31, b=2, size=32)
    ids = tp.tokenizer(PROMPTS, pad="eot")
    nids = tp.tokenizer(["blurry, low quality"] * 2, pad="eot")
    if entry == "generate":
        control = tp.control_from_src(src, 32, 32)
        jcontrol = jp._control_from_src(jp.params, jnp.asarray(src, jnp.float32), 32, 32, 120.0, 200.0)
        assert np.array_equal(control.numpy(), np.asarray(jcontrol))
        kw = dict(height=32, width=32, num_inference_steps=3, guidance_scale=7.5, controlnet_scale=0.75,
                  token_ids=ids, negative_token_ids=nids)
        want = jp.generate(["x"] * 2, jax.random.PRNGKey(0), control_image=jcontrol, latents=jnp.asarray(lat), **kw)
        got = tp.generate(["x"] * 2, lat, control_image=control, **kw)
        _close(got, want, 1e-4)
        want_u8 = np.clip(np.round(np.asarray(want) * 255.0), 0, 255).astype(np.uint8)
        _images_close(quantize(got).numpy(), want_u8)
    else:
        want_u8 = jp.make_fused_generate(32, 32, 3, 7.5)(jp.params, jnp.asarray(ids), jnp.asarray(nids),
                                                         jnp.asarray(src), jnp.asarray(lat))
        got_u8 = tp.make_fused_generate(32, 32, 3, 7.5)(tp.params, ids, nids, src, lat)
        _images_close(got_u8.numpy(), np.asarray(want_u8))


def _tiny_specs(monkeypatch):
    real = tpipelines._spec

    def spec(base_model):
        s = real(base_model)
        return PipelineSpec(s.is_xl, P_TEXT, P_VAE, s.scheduler_cfg)

    monkeypatch.setattr(tpipelines, "_spec", spec)
    monkeypatch.setitem(tpipelines.UNET_CONFIGS, "sd_v2.1", P_SD21)


def _write_tree(root, prefix: str, rng) -> dict:
    sds = {"unet": synth.diffusers_unet_state_dict(TORCH_SD21, fill=rng),
           "vae": synth.diffusers_vae_state_dict(dict(block_out_channels=G_VAE.block_out_channels,
                                                      layers_per_block=G_VAE.layers_per_block, in_channels=3,
                                                      out_channels=3, latent_channels=4), fill=rng),
           "text_encoder": synth.hf_clip_text_state_dict(width=24, layers=2, fill=rng)}
    for part, sd in sds.items():
        name = "model.safetensors" if part == "text_encoder" else "diffusion_pytorch_model.safetensors"
        path = root / prefix / part / name
        path.parent.mkdir(parents=True, exist_ok=True)
        write_safetensors(path, sd)
    return sds


@pytest.mark.parametrize("prefix", ["sd_v2.1", "stabilityai-stable-diffusion-2-1"])
def test_loader_takes_the_sd21_layout(tmp_path, monkeypatch, prefix):
    """init_pipeline("sd_v2.1", None, weights_dir=tree) on SD2.1's public
    layout at tiny width (SD21_TORCH_CFG's linear projections and 24-wide
    context, HF's CLIPTextModel layout for the tower): strict loads, every
    key of every file used and every parameter loaded; the port's UNet
    converter gives tools/convert_weights.py's tree bit for bit."""
    sds = _write_tree(tmp_path, prefix, np.random.RandomState(23))
    want = jconv.convert_sd_unet(sds["unet"], J_SD21)
    got = pconv.convert_sd_unet(sds["unet"], P_SD21)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    assert flat(got).keys() == flat(want).keys()
    assert all(np.array_equal(np.asarray(flat(got)[k]), np.asarray(v)) for k, v in flat(want).items())
    _tiny_specs(monkeypatch)
    monkeypatch.setattr(pload, "REPORT_SUMS", True)
    tp = tpipelines.init_pipeline("sd_v2.1", None, weights_dir=str(tmp_path), device="cpu", dtype=F32)
    assert tp.base_model == "sd_v2.1" and tp.weights_loaded
    assert sorted(r["model"] for r in tp.load_report) == ["text", "unet", "vae"]
    for r in tp.load_report:
        assert r["unconsumed"] == 0 and r["params"] == r["module_params"] and prefix in r["file"], r
        assert r["loaded_sum"] == pytest.approx(r["rounded_sum"], rel=1e-6)


@pytest.mark.parametrize("controlnet", ["canny", "hed"])
def test_sd21_controlnet_file_is_refused_by_name(tmp_path, monkeypatch, controlnet):
    """Under --weights_dir SD2.1 with a ControlNet raises a FileNotFoundError
    naming the SD2.1 ControlNet no rule provides, before any file is read,
    even where the tree holds SD1.5's ControlNet of that kind (whose widths
    do not fit; the JAX package would load it there)."""
    _write_tree(tmp_path, "sd_v2.1", np.random.RandomState(24))
    cn = tmp_path / f"controlnet_{controlnet}_sd15" / "diffusion_pytorch_model.safetensors"
    cn.parent.mkdir(parents=True)
    sd15 = dict(TORCH_SD21, cross_attention_dim=16, use_linear_projection=False)  # a tiny SD1.5 ControlNet
    write_safetensors(cn, synth.diffusers_controlnet_state_dict(sd15, fill=np.random.RandomState(25)))
    _tiny_specs(monkeypatch)
    with pytest.raises(FileNotFoundError, match=rf"SD2\.1 {controlnet} ControlNet \(controlnet_{controlnet}_sd21\)"):
        tpipelines.init_pipeline("sd_v2.1", controlnet, weights_dir=str(tmp_path), device="cpu", dtype=F32)
