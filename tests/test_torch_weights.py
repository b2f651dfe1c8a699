"""The port's loader of public checkpoint files (saspa_tpu_torch/weights)
against tools/convert_weights.py and the JAX modules, on the CPU.

The files are tools/synth_checkpoints.py's public key layouts with seeded
values (fill=np.random.RandomState(seed)), at tiny configs where the layout
takes a config (the diffusers UNet, ControlNet and VAE, the HF text towers,
BLIP-Diffusion's Q-Former and ViT) and at full size where it does not
(OpenAI's RN50.pt, the WSDAN-CAL checkpoints, lpips), written as the public
files are: safetensors, TorchScript, torch.save pickles.  For each family:
  * the port's converter gives tools/convert_weights.py's tree, key for key
    and bit for bit;
  * the port loaded from the files runs the JAX module's forward given
    convert_weights' tree, in f32 within the tolerances of the other
    test_torch_* files.
Then the loader's strictness (a dropped key, an extra key, a wrong shape
each raise and name it), a tree without a family (warning and seeded init,
or a raise under SASPA_STRICT_WEIGHTS=1) and a released CAL .pth through
`train --ckpt`'s restore.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import cal as jcal
from saspa_tpu.models import clip as jclip
from saspa_tpu.models import unet as j_unet
from saspa_tpu.models.blip_diffusion import QFormer as JaxQFormer
from saspa_tpu.models.clip import CLIPVisionViT as JaxViT
from saspa_tpu.models.clip import CLIPVisionViTConfig as JaxViTConfig
from saspa_tpu.models.controlnet import ControlNet as JaxControlNet
from saspa_tpu.models.vae import AutoencoderKL as JaxVAE
from saspa_tpu_torch.diffusion import pipelines as tpipelines
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, PipelineSpec
from saspa_tpu_torch.filters import confidence as tconf
from saspa_tpu_torch.filters.clip_filters import CLIPScorer
from saspa_tpu_torch.models import text_encoder as t_text
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline, QFormerConfig
from saspa_tpu_torch.models.clip import CLIPVisionViTConfig
from saspa_tpu_torch.utils import checkpoint as tckpt
from saspa_tpu_torch.weights import convert as pconv
from saspa_tpu_torch.weights import load as pload
from saspa_tpu_torch.weights.files import read_state_dict, write_safetensors
from tests.test_golden_families import GX_TEXT, GX_UNET, GX_VAE
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_blip import _close, _images_close
from tests.test_torch_pipeline import _inputs, _PresetJaxPipeline
from tests.test_torch_xl import port_cfg
from tools import convert_weights as jconv
from tools import synth_checkpoints as synth

F32 = torch.float32

# the torch-side (diffusers config.json) fields of the tiny JAX configs
TORCH_G_UNET = dict(in_channels=4, out_channels=4, block_out_channels=G_UNET.block_out_channels,
                    layers_per_block=G_UNET.layers_per_block, down_block_types=G_UNET.down_block_types,
                    up_block_types=G_UNET.up_block_types,
                    transformer_layers_per_block=G_UNET.transformer_layers_per_block,
                    cross_attention_dim=G_UNET.cross_attention_dim, use_linear_projection=False,
                    addition_embed_type=None, projection_class_embeddings_input_dim=None)
LX_UNET = dataclasses.replace(GX_UNET, use_linear_projection=True)
TORCH_LX_UNET = dict(TORCH_G_UNET, cross_attention_dim=LX_UNET.cross_attention_dim, use_linear_projection=True,
                     addition_embed_type="text_time",
                     projection_class_embeddings_input_dim=LX_UNET.projection_class_embeddings_input_dim)
TORCH_VAE = dict(block_out_channels=G_VAE.block_out_channels, layers_per_block=G_VAE.layers_per_block,
                 in_channels=3, out_channels=3, latent_channels=4)
P_G_UNET, P_LX_UNET = port_cfg(t_unet.UNetConfig, G_UNET), port_cfg(t_unet.UNetConfig, LX_UNET)
P_G_VAE, P_GX_VAE = port_cfg(t_vae.VAEConfig, G_VAE), port_cfg(t_vae.VAEConfig, GX_VAE)
P_G_TEXT = tuple(port_cfg(t_text.CLIPTextConfig, c) for c in G_TEXT)
P_GX_TEXT = tuple(port_cfg(t_text.CLIPTextConfig, c) for c in GX_TEXT)
T_VISION = CLIPVisionViTConfig(width=32, layers=2, heads=2, output_dim=None, patch_size=32)
T_QFORMER = QFormerConfig(width=32, layers=3, heads=2, out_dim=32, encoder_width=32)


def _text_sd(cfg, seed):
    return synth.hf_clip_text_state_dict(width=cfg.width, layers=cfg.layers, projection_dim=cfg.projection_dim,
                                         fill=np.random.RandomState(seed))


def _blip_sd(seed):
    rng = np.random.RandomState(seed)
    sd = dict(synth.blip_diffusion_qformer_state_dict(width=32, layers=3, queries=16, enc_width=32, fill=rng))
    sd.update(synth.blip_diffusion_vision_state_dict(width=32, layers=2, patch=32, fill=rng))
    return sd


# family -> (the synthetic state_dict, the port's converter, tools/convert_weights.py's)
FAMILIES = {
    "sd15_unet": (lambda: synth.diffusers_unet_state_dict(TORCH_G_UNET, fill=np.random.RandomState(1)),
                  lambda sd: pconv.convert_sd_unet(sd, P_G_UNET), lambda sd: jconv.convert_sd_unet(sd, G_UNET)),
    "sd15_controlnet": (lambda: synth.diffusers_controlnet_state_dict(TORCH_G_UNET, fill=np.random.RandomState(2)),
                        lambda sd: pconv.convert_controlnet(sd, P_G_UNET),
                        lambda sd: jconv.convert_controlnet(sd, G_UNET)),
    "vae_legacy_names": (lambda: synth.diffusers_vae_state_dict(TORCH_VAE, fill=np.random.RandomState(3)),
                         lambda sd: pconv.convert_vae(sd, P_G_VAE), lambda sd: jconv.convert_vae(sd, G_VAE)),
    "vae_modern_names": (lambda: synth.diffusers_vae_state_dict(TORCH_VAE, fill=np.random.RandomState(4),
                                                                legacy_attn=False),
                         lambda sd: pconv.convert_vae(sd, P_G_VAE), lambda sd: jconv.convert_vae(sd, G_VAE)),
    "sd15_text": (lambda: _text_sd(G_TEXT[0], 5), lambda sd: pconv.convert_clip_text_hf(sd, 2),
                  lambda sd: jconv.convert_clip_text_hf(sd, 2)),
    "xl_unet": (lambda: synth.diffusers_unet_state_dict(TORCH_LX_UNET, fill=np.random.RandomState(6)),
                lambda sd: pconv.convert_sd_unet(sd, P_LX_UNET), lambda sd: jconv.convert_sd_unet(sd, LX_UNET)),
    "xl_controlnet": (lambda: synth.diffusers_controlnet_state_dict(TORCH_LX_UNET, fill=np.random.RandomState(7)),
                      lambda sd: pconv.convert_controlnet(sd, P_LX_UNET),
                      lambda sd: jconv.convert_controlnet(sd, LX_UNET)),
    "xl_text_l": (lambda: _text_sd(GX_TEXT[0], 8), lambda sd: pconv.convert_clip_text_hf(sd, 2),
                  lambda sd: jconv.convert_clip_text_hf(sd, 2)),
    "xl_text_bigg": (lambda: _text_sd(GX_TEXT[1], 9), lambda sd: pconv.convert_clip_text_hf(sd, 2),
                     lambda sd: jconv.convert_clip_text_hf(sd, 2)),
    "blip_qformer": (lambda: _blip_sd(10), lambda sd: pconv.convert_blip_diffusion_qformer(sd, 3),
                     lambda sd: jconv.convert_blip_diffusion_qformer(sd, 3)),
    "blip_vision": (lambda: _blip_sd(10), lambda sd: pconv.convert_blip_diffusion_vision(sd, 2),
                    lambda sd: jconv.convert_blip_diffusion_vision(sd, 2)),
    "clip_rn50": (lambda: synth.openai_clip_rn50_state_dict(fill=np.random.RandomState(11)),
                  pconv.convert_clip_rn50, jconv.convert_clip_rn50),
    "cal_resnet50": (lambda: synth.cal_checkpoint_state_dict(depth=50, num_classes=7,
                                                             fill=np.random.RandomState(12)),
                     pconv.convert_cal, jconv.convert_cal),
    "cal_resnet101": (lambda: synth.cal_checkpoint_state_dict(depth=101, num_classes=7,
                                                              fill=np.random.RandomState(13)),
                      pconv.convert_cal, jconv.convert_cal),
    "lpips": (lambda: synth.lpips_alex_state_dict(fill=np.random.RandomState(14)), pconv.convert_lpips,
              jconv.convert_lpips),
}


def _flat(tree, prefix=""):
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}{i}/").items()}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_matches_convert_weights(family):
    """Key for key and bit for bit, and every key of the file read (the
    documented exceptions aside)."""
    make, port, jax_side = FAMILIES[family]
    sd = make()
    tsd = pload.TrackingStateDict(sd)
    got, want = _flat(port(tsd)), _flat(jax_side(dict(sd)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    if family == "blip_qformer":  # the file's vision_model.* keys feed the other converter
        pconv.convert_blip_diffusion_vision(tsd, 2)
    if family == "blip_vision":
        pconv.convert_blip_diffusion_qformer(tsd, 3)
    assert pload.unconsumed(tsd, pload.RN50_METADATA) == []


# ---- the file readers ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    rng = np.random.RandomState(0)
    t = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}[dtype]
    tensors = {"a.weight": torch.from_numpy(rng.randn(3, 5).astype(np.float32) * 100).to(t),
               "b": torch.from_numpy(rng.randn(7).astype(np.float32) * 100).to(t),
               "scalar": torch.tensor(2.5).to(t)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got, want = read_state_dict(tmp_path / "x.safetensors"), load_file(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = (w.float() if w.dtype == torch.bfloat16 else w).numpy()
        assert got[k].dtype == w.dtype and got[k].shape == w.shape and np.array_equal(got[k], w), k


def test_safetensors_writer_reads_back_in_the_package(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.RandomState(1)
    tensors = {"w": rng.randn(4, 3).astype(np.float16).T, "s": np.float32(0.5).reshape(()),
               "i": np.arange(5, dtype=np.int64)}
    write_safetensors(tmp_path / "y.safetensors", tensors)
    back = load_file(str(tmp_path / "y.safetensors"))
    assert all(np.array_equal(back[k], v) and back[k].dtype == v.dtype for k, v in tensors.items())
    with pytest.raises(ValueError, match="I32"):
        from safetensors.numpy import save_file

        save_file({"x": np.zeros(2, np.int32)}, str(tmp_path / "z.safetensors"))
        read_state_dict(tmp_path / "z.safetensors")


def test_pth_reader_unwraps_and_keeps_feature_center(tmp_path):
    sd = {"_orig_mod.fc.weight": torch.randn(3, 4), "features.0.weight": torch.randn(2, 3, 1, 1).bfloat16()}
    torch.save({"logs": {"epoch": 3, "val_acc": 0.5}, "state_dict": sd, "feature_center": torch.ones(3, 4)},
               tmp_path / "model.pth")
    got = read_state_dict(tmp_path / "model.pth")
    assert sorted(got) == ["fc.weight", "features.0.weight"] and got["features.0.weight"].dtype == np.float32
    assert np.array_equal(got["fc.weight"], sd["_orig_mod.fc.weight"].numpy())
    assert np.array_equal(got.extras["feature_center"], np.ones((3, 4), np.float32))
    torch.save({"model": {"x": torch.arange(3)}}, tmp_path / "lavis.pth")
    assert np.array_equal(read_state_dict(tmp_path / "lavis.pth")["x"], np.arange(3))


def scripted_state_archive(path, sd) -> None:
    """A TorchScript archive whose state_dict is `sd` (OpenAI's RN50.pt is a
    scripted model)."""
    root = torch.nn.Module()
    for key, v in sd.items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, torch.nn.Module())
            m = getattr(m, name)
        m.register_buffer(leaf, torch.as_tensor(np.asarray(v)))
    torch.jit.save(torch.jit.script(root), str(path))


def test_torchscript_reader(tmp_path):
    sd = {"visual.conv1.weight": np.random.RandomState(2).randn(4, 3, 3, 3).astype(np.float32),
          "logit_scale": np.float32(4.6).reshape(()), "input_resolution": np.asarray(224, np.int64)}
    scripted_state_archive(tmp_path / "RN50.pt", sd)
    got = read_state_dict(tmp_path / "RN50.pt")
    assert sorted(got) == sorted(sd) and all(np.array_equal(got[k], v) for k, v in sd.items())


# ---- a tree of public files, loaded, against JAX -----------------------------------

def _write(root, rel, sd):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    write_safetensors(path, sd)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """sd_v1.5 + canny, sdxl-turbo and sd_xl (one set of files) + ControlNet-XL
    and blip_diffusion at tiny configs, in the weights_day --src_dir layout;
    {name: state_dict} beside."""
    root = tmp_path_factory.mktemp("weights")
    sds = {name: FAMILIES[name][0]() for name in FAMILIES if not name.startswith(("clip", "cal", "lpips"))}
    files = {"sd_v1.5/unet/diffusion_pytorch_model.safetensors": "sd15_unet",
             "sd_v1.5/vae/diffusion_pytorch_model.safetensors": "vae_legacy_names",
             "sd_v1.5/text_encoder/model.safetensors": "sd15_text",
             "controlnet_canny_sd15/diffusion_pytorch_model.safetensors": "sd15_controlnet",
             "sdxl-turbo/unet/diffusion_pytorch_model.safetensors": "xl_unet",
             "sdxl-vae-fp16-fix/diffusion_pytorch_model.safetensors": "vae_modern_names",
             "sdxl-turbo/text_encoder/model.safetensors": "xl_text_l",
             "sdxl-turbo/text_encoder_2/model.safetensors": "xl_text_bigg",
             "controlnet_canny_xl/diffusion_pytorch_model.safetensors": "xl_controlnet",
             "sd_xl/unet/diffusion_pytorch_model.safetensors": "xl_unet",
             "sd_xl/text_encoder/model.safetensors": "xl_text_l",
             "sd_xl/text_encoder_2/model.safetensors": "xl_text_bigg",
             "blip_diffusion/unet/diffusion_pytorch_model.safetensors": "sd15_unet",
             "blip_diffusion/vae/diffusion_pytorch_model.safetensors": "vae_legacy_names",
             "blip_diffusion/text_encoder/model.safetensors": "sd15_text",
             "blip_diffusion/qformer/diffusion_pytorch_model.safetensors": "blip_qformer"}
    for rel, name in files.items():
        _write(root, rel, sds[name])
    return root, sds


def _jax_tree(sds, family, cfgs):
    """convert_weights' trees of the tree's files, as the JAX pipeline takes them."""
    unet_cfg, vae_cfg, n_text = cfgs
    text = ("sd15_text",) if n_text == 1 else ("xl_text_l", "xl_text_bigg")
    pre = "sd15" if family == "sd_v1.5" else "xl"
    vae = "vae_legacy_names" if family == "sd_v1.5" else "vae_modern_names"
    return {"text": [jconv.convert_clip_text_hf(sds[t], 2) for t in text],
            "unet": jconv.convert_sd_unet(sds[f"{pre}_unet"], unet_cfg), "vae": jconv.convert_vae(sds[vae], vae_cfg),
            "controlnet": jconv.convert_controlnet(sds[f"{pre}_controlnet"], unet_cfg)}


def _tiny_specs(monkeypatch):
    """init_pipeline's models at the tiny configs."""
    real = tpipelines._spec

    def spec(base_model):
        s = real(base_model)
        xl = base_model.startswith("sd_xl")
        return PipelineSpec(s.is_xl, P_GX_TEXT if xl else P_G_TEXT, P_GX_VAE if xl else P_G_VAE, s.scheduler_cfg)

    monkeypatch.setattr(tpipelines, "_spec", spec)
    for name, cfg in (("sd_v1.5", P_G_UNET), ("sd_xl-turbo", P_LX_UNET), ("sd_xl", P_LX_UNET)):
        monkeypatch.setitem(tpipelines.UNET_CONFIGS, name, cfg)


@pytest.mark.parametrize("base_model,gs", [("sd_v1.5", 7.5), ("sd_xl-turbo", 0.0), ("sd_xl", 7.5)])
def test_init_pipeline_from_files_matches_jax(tree, monkeypatch, base_model, gs):
    """init_pipeline(weights_dir=tree) at tiny configs: every model loaded
    from its file (0 keys left, every parameter from the file), then the
    fused function against the JAX pipeline given convert_weights' trees of
    the same files: uint8 within 1 level, >= 99% equal."""
    root, sds = tree
    _tiny_specs(monkeypatch)
    monkeypatch.setattr(pload, "REPORT_SUMS", True)
    tp = tpipelines.init_pipeline(base_model, "canny", weights_dir=str(root), device="cpu", dtype=F32)
    assert tp.weights_loaded
    xl = base_model != "sd_v1.5"
    models = ["text", "text", "unet", "vae", "controlnet"] if xl else ["text", "unet", "vae", "controlnet"]
    assert sorted(r["model"] for r in tp.load_report) == sorted(models)
    for r in tp.load_report:
        assert r["unconsumed"] == 0 and r["params"] == r["module_params"], r
        assert r["loaded_sum"] == pytest.approx(r["rounded_sum"], rel=1e-6) and r["sum"] == pytest.approx(
            r["loaded_sum"], rel=1e-6)
        if r["model"] == "vae":  # the encoder's keys too: every element of the file loaded
            vae = sds["vae_legacy_names" if base_model == "sd_v1.5" else "vae_modern_names"]
            assert r["elements"] == sum(np.asarray(t).size for t in vae.values()), r
    jcfg = (LX_UNET, GX_VAE, 2) if xl else (G_UNET, G_VAE, 1)
    _PresetJaxPipeline.preset = _jax_tree(sds, base_model, jcfg)
    jp = _PresetJaxPipeline(base_model=base_model, controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=jcfg[0], vae_cfg=jcfg[1], text_cfgs=GX_TEXT if xl else G_TEXT)
    src, lat = _inputs(5, b=2, size=64)
    ids = tp.tokenizer(["a photo of a jet", "a small bird"], pad="eot")
    nids = tp.tokenizer(["blurry"] * 2, pad="eot")
    want = jp.make_fused_generate(64, 64, 2, gs)(jp.params, *map(jnp.asarray, (ids, nids, src, lat)))
    got = tp.make_fused_generate(64, 64, 2, gs)(tp.params, ids, nids, src, lat)
    _images_close(got.numpy(), want)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).permute(0, 3, 1, 2)


def test_sd15_models_from_files_match_jax_modules(tree):
    """The UNet, ControlNet and VAE decoder (legacy attention names) loaded
    from the files, against the JAX modules given convert_weights' trees,
    on float outputs."""
    root, sds = tree
    tp = DiffusionPipeline("sd_v1.5", "canny", device="cpu", dtype=F32, weights_dir=str(root), init_seed=None,
                           unet_cfg=P_G_UNET, vae_cfg=P_G_VAE, text_cfgs=P_G_TEXT)
    rng = np.random.RandomState(3)
    sample = rng.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 16).astype(np.float32)
    cond = rng.rand(2, 128, 128, 3).astype(np.float32)
    want = jax.jit(j_unet.UNet2DCondition(cfg=G_UNET).apply)(  # jitted: flax's eager dispatch costs more
        {"params": jconv.convert_sd_unet(sds["sd15_unet"], G_UNET)}, jnp.asarray(sample), jnp.asarray(499),
        jnp.asarray(ctx))
    with torch.no_grad():
        got = tp.params["unet"](_nchw(sample), 499, torch.from_numpy(ctx))
    _close(got.permute(0, 2, 3, 1), want, 1e-4)
    want_down, want_mid = jax.jit(lambda v, *a: JaxControlNet(cfg=G_UNET).apply(v, *a, 0.75))(
        {"params": jconv.convert_controlnet(sds["sd15_controlnet"], G_UNET)}, jnp.asarray(sample),
        jnp.asarray(999), jnp.asarray(ctx), jnp.asarray(cond))
    cn = tp.params["controlnet"]
    with torch.no_grad():
        down, mid = cn(_nchw(sample), 999, torch.from_numpy(ctx), cn.embed_cond(_nchw(cond)), 0.75)
    for g, w in zip(down + [mid], list(want_down) + [want_mid]):
        _close(g.permute(0, 2, 3, 1), w, 1e-4)
    z = rng.randn(1, 8, 8, 4).astype(np.float32)
    want = jax.jit(lambda v, z: JaxVAE(cfg=G_VAE).apply(v, z, method=JaxVAE.decode))(
        {"params": jconv.convert_vae(sds["vae_legacy_names"], G_VAE)}, jnp.asarray(z))
    with torch.no_grad():
        got = tp.params["vae"].decode(_nchw(z)).permute(0, 2, 3, 1)
    _close(got, want, 1e-4)


def test_blip_towers_from_files_match_jax(tree):
    """BLIP-Diffusion's Q-Former and ViT from the one qformer file (and the
    SD1.5 models from theirs), against the JAX modules on the same trees."""
    root, sds = tree
    tp = BlipDiffusionPipeline(controlnet="canny", device="cpu", dtype=F32, weights_dir=str(root), init_seed=None,
                               unet_cfg=P_G_UNET, vae_cfg=P_G_VAE, text_cfgs=P_G_TEXT, vision_cfg=T_VISION,
                               qformer_cfg=T_QFORMER)
    assert tp.weights_loaded
    assert sorted(r["model"] for r in tp.load_report) == ["blip_qformer", "blip_vision", "controlnet", "text",
                                                          "unet", "vae"]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 224, 224, 3).astype(np.float32)
    jv = JaxViTConfig(width=32, layers=2, heads=2, output_dim=None, patch_size=32)
    tokens = jax.jit(lambda v, x: JaxViT(cfg=jv).apply(v, x, return_tokens=True))(
        {"params": jconv.convert_blip_diffusion_vision(sds["blip_qformer"], 2)}, jnp.asarray(x))
    with torch.no_grad():
        got = tp.params["blip_vision"](_nchw(x), return_tokens=True)
    _close(got, tokens, 2e-5)
    ids, mask = tp.bert_category_ids("aston martin", 2)
    want = jax.jit(JaxQFormer(width=32, layers=3, heads=2, out_dim=32).apply)(
        {"params": jconv.convert_blip_diffusion_qformer(sds["blip_qformer"], 3)}, tokens, jnp.asarray(ids),
        jnp.asarray(mask))
    with torch.no_grad():
        got = tp.params["blip_qformer"](torch.from_numpy(np.asarray(tokens)), ids, mask)
    _close(got, want, 2e-5)


def test_clip_rn50_from_the_torchscript_file_matches_jax(tmp_path):
    """OpenAI's RN50.pt (a TorchScript archive, full size): params and
    BatchNorm statistics into the CLIP scorer, against flax's CLIPModel on
    convert_weights' variables."""
    sd = FAMILIES["clip_rn50"][0]()
    scripted_state_archive(tmp_path / "RN50.pt", sd)
    scorer = CLIPScorer(weights_dir=str(tmp_path), device="cpu")
    assert [r["model"] for r in scorer.load_report] == ["clip"] and scorer.load_report[0]["unconsumed"] == 0
    params, stats = jconv.convert_clip_rn50(sd)
    v = {"params": params, "batch_stats": stats}
    jm = jclip.CLIPModel(vision_kind="rn50", dtype=jnp.float32)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 224, 224, 3).astype(np.float32)
    ids = scorer.tokenizer(["a photo of a jet", "an image"])
    with torch.no_grad():
        img = scorer.model.encode_image(_nchw(x))
        txt = scorer.model.encode_text(torch.from_numpy(ids).long())
    want_img, want_txt = jax.jit(lambda v, x, ids: (jm.apply(v, x, method=jclip.CLIPModel.encode_image),
                                                    jm.apply(v, ids, method=jclip.CLIPModel.encode_text)))(
        v, jnp.asarray(x), jnp.asarray(ids))
    _close(img, want_img, 1e-4)
    _close(txt, want_txt, 1e-4)
    assert scorer.logit_scale == pytest.approx(float(np.exp(np.float32(sd["logit_scale"]))), rel=1e-6)


@pytest.mark.parametrize("depth", [50, 101])
def test_cal_baseline_from_checkpoints_dir_matches_jax(tmp_path, monkeypatch, depth):
    """The released WSDAN-CAL .pth under checkpoints/<dataset>/ (one file):
    ResNet-50 or -101 as its keys say, every key consumed, its eval forward
    against flax's WSDAN_CAL on convert_weights' variables; `train --ckpt`'s
    restore of the same file gives the same model and keeps feature_center."""
    sd = FAMILIES[f"cal_resnet{depth}"][0]()
    fc = np.random.RandomState(6).randn(7, 32 * 2048).astype(np.float32)
    (tmp_path / "planes").mkdir()
    torch.save({"logs": {"epoch": 9}, "state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "feature_center": torch.from_numpy(fc)}, tmp_path / "planes" / "model_bestacc.pth")
    monkeypatch.setenv("SASPA_CHECKPOINTS", str(tmp_path))
    model, _ = tconf.load_cal_baseline("planes", 7, device="cpu")
    assert model.net == f"resnet{depth}" and model.load_report[0]["unconsumed"] == 0
    params, stats = jconv.convert_cal(sd)
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    want = jcal.WSDAN_CAL(num_classes=7, M=32, net=f"resnet{depth}").apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(_nchw(x))
    _close(got[0], want[0], 1e-4)
    _close(got[2], want[2], 1e-4)
    ck = tckpt.load_checkpoint(str(tmp_path / "planes" / "model_bestacc.pth"))
    assert ck["net"] == f"resnet{depth}" and np.array_equal(ck["feature_center"].numpy(), fc)
    fresh = type(model)(num_classes=7, M=32, net=model.net)
    assert tckpt.restore_into(fresh, ck, strict=True) == []
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


# ---- strictness and missing files ----------------------------------------------------

@pytest.mark.parametrize("fault", ["dropped", "extra", "shape"])
def test_a_file_that_does_not_match_raises_and_names_the_key(tmp_path, fault):
    sd = dict(FAMILIES["sd15_text"][0]())
    if fault == "dropped":
        del sd["text_model.final_layer_norm.bias"]
        key = "text_model.final_layer_norm.bias"
    elif fault == "extra":
        sd["text_model.encoder.layers.2.mlp.fc1.weight"] = np.zeros((4, 4), np.float32)
        key = "text_model.encoder.layers.2.mlp.fc1.weight"
    else:
        sd["text_model.embeddings.position_embedding.weight"] = np.zeros((76, 16), np.float32)
        key = "positional_embedding"
    write_safetensors(tmp_path / "model.safetensors", sd)
    te = t_text.CLIPTextEncoder(P_G_TEXT[0])
    with pytest.raises(pload.WeightsMismatch, match=key.replace(".", r"\.")):
        pload.load_file(tmp_path / "model.safetensors", "clip_text", te)


def test_a_tree_without_the_family_warns_and_seeds_or_raises(tmp_path, tree, monkeypatch, caplog):
    kw = dict(device="cpu", dtype=F32, unet_cfg=P_G_UNET, vae_cfg=P_G_VAE, text_cfgs=P_G_TEXT)
    with caplog.at_level(logging.WARNING):
        tp = DiffusionPipeline("sd_v1.5", "canny", weights_dir=str(tmp_path), **kw)
    assert not tp.weights_loaded and tp.load_report == [] and "seeded random init" in caplog.text
    seeded = DiffusionPipeline("sd_v1.5", "canny", **kw)
    for a, b in zip(tp.params["unet"].state_dict().values(), seeded.params["unet"].state_dict().values()):
        assert torch.equal(a, b)
    # the family's files without the ControlNet's: the base loads, the ControlNet seeds
    root, _ = tree
    part = tmp_path / "partial"
    for rel in ("sd_v1.5/unet", "sd_v1.5/vae", "sd_v1.5/text_encoder"):
        (part / rel).mkdir(parents=True)
        for f in (root / rel).iterdir():
            (part / rel / f.name).symlink_to(f)
    tp = DiffusionPipeline("sd_v1.5", "canny", weights_dir=str(part), **kw)
    assert tp.weights_loaded and "controlnet" not in [r["model"] for r in tp.load_report]
    for a, b in zip(tp.params["controlnet"].state_dict().values(),
                    seeded.params["controlnet"].state_dict().values()):
        assert torch.equal(a, b)
    (part / "sd_v1.5" / "vae" / "diffusion_pytorch_model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="incomplete"):
        DiffusionPipeline("sd_v1.5", "canny", weights_dir=str(part), **kw)
    monkeypatch.setenv("SASPA_STRICT_WEIGHTS", "1")
    with pytest.raises(FileNotFoundError, match="SASPA_STRICT_WEIGHTS"):
        DiffusionPipeline("sd_v1.5", "canny", weights_dir=str(tmp_path), **kw)
    with pytest.raises(FileNotFoundError, match="SASPA_STRICT_WEIGHTS"):
        CLIPScorer(weights_dir=str(tmp_path), device="cpu")


def test_the_jax_packages_converted_checkpoints_are_refused(tmp_path):
    (tmp_path / "clip_rn50").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        CLIPScorer(weights_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_checkpoint(str(tmp_path))
