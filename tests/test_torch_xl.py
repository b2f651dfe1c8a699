"""Parity of the port's SDXL path with the JAX package, on the CPU.

Tiny XL configs: tests/test_golden_families.py's GX_TEXT (a ViT-L-style
tower of 16 and a bigG-style gelu tower of 32 with a projection), GX_VAE,
and GX_UNET with linear projections (`LX_UNET`; the golden fixture's UNet
keeps the 1x1 convs), plus a canny ControlNet of the same config.  f32.
The text towers and the VAE take tests/fixtures/golden_gen_xl.npz's params;
the UNet and ControlNet take seeded trees made from the port's parameter
shapes (the ControlNet's encoder copied from the UNet, its conditioning
embedding and zero convs seeded nonzero).  Both packages get the same numpy
params through the bridge and the same numpy inputs.  Tolerances: towers,
UNet and ControlNet within 2e-5 / 1e-4 of the largest output (f32
summation order differs between XLA and torch); token ids equal; uint8
images within 1 level, >= 99% of them exactly.  The full-width shape test
traces the flax trees with jax.eval_shape and builds the port's modules on
the meta device: nothing is allocated.
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
from saspa_tpu.models import vae as j_vae
from saspa_tpu.models.controlnet import ControlNet as JaxControlNet
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.diffusion import pipelines as tpipelines
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, openclip_pad
from saspa_tpu_torch.models import text_encoder as t_text
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.models.controlnet import ControlNet
from tests.test_golden_families import GOLDEN_XL_PATH, GX_TEXT, GX_UNET, GX_VAE
from tests.test_golden_generation import _unflatten_params
from tests.test_torch_blip import _close, _images_close, random_flax_tree
from tests.test_torch_pipeline import _PresetJaxPipeline

F32 = torch.float32


def port_cfg(cls, cfg):
    """A JAX config dataclass -> the port's of the same fields."""
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


LX_UNET = dataclasses.replace(GX_UNET, use_linear_projection=True)
P_GX_UNET, P_LX_UNET = (port_cfg(t_unet.UNetConfig, c) for c in (GX_UNET, LX_UNET))
P_GX_VAE = port_cfg(t_vae.VAEConfig, GX_VAE)
P_GX_TEXT = tuple(port_cfg(t_text.CLIPTextConfig, c) for c in GX_TEXT)
PROMPTS = ["a painted bunting on a branch", "a small grey bird", ""]


def port_pipe(params, base_model="sd_xl-turbo", controlnet="canny", unet_cfg=P_LX_UNET) -> DiffusionPipeline:
    tp = DiffusionPipeline(base_model, controlnet, device="cpu", dtype=F32, init_seed=None, unet_cfg=unet_cfg,
                           vae_cfg=P_GX_VAE, text_cfgs=P_GX_TEXT)
    tp.load_flax_params(params)
    return tp


def jax_pipe(params, base_model="sd_xl-turbo", controlnet="canny", unet_cfg=LX_UNET):
    _PresetJaxPipeline.preset = params
    return _PresetJaxPipeline(base_model=base_model, controlnet=controlnet, sampler="ddim", dtype=jnp.float32,
                              unet_cfg=unet_cfg, vae_cfg=GX_VAE, text_cfgs=GX_TEXT)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_XL_PATH)


def xl_params() -> dict:
    """The golden fixture's towers and VAE; a seeded linear-projection UNet
    and a ControlNet whose encoder is that UNet's.  Flax layout, numpy
    leaves."""
    base = _unflatten_params(np.load(GOLDEN_XL_PATH))
    shell = DiffusionPipeline("sd_xl-turbo", "canny", device="cpu", dtype=F32, init_seed=None, unet_cfg=P_LX_UNET,
                              vae_cfg=P_GX_VAE, text_cfgs=P_GX_TEXT)
    rng = np.random.RandomState(5)
    unet = random_flax_tree(shell.params["unet"], rng)
    cn = random_flax_tree(shell.params["controlnet"], rng, base=unet)
    return {"text": base["text"], "vae": base["vae"], "unet": unet, "controlnet": cn}


@pytest.fixture(scope="module")
def params():
    return xl_params()


def _ids(tp, prompts=PROMPTS):
    return tp.tokenizer(prompts, pad="eot")


def _added_cond(rng, b, pooled):
    return {"text_embeds": rng.randn(b, pooled).astype(np.float32),
            "time_ids": np.tile(np.array([[64, 48, 0, 0, 64, 48]], np.float32), (b, 1))}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ---- configs and trees ---------------------------------------------------------

def test_configs_match_jax():
    """SDXL's UNet, towers and VAE, the ported UNET_CONFIGS entries and each
    ported base model's spec (towers, VAE, timestep spacing) equal the JAX
    package's field for field."""
    assert port_cfg(t_unet.UNetConfig, j_unet.SDXL_UNET) == t_unet.SDXL_UNET
    for name, cfg in t_unet.UNET_CONFIGS.items():
        assert port_cfg(t_unet.UNetConfig, j_unet.UNET_CONFIGS[name]) == cfg, name
    assert port_cfg(t_text.CLIPTextConfig, j_text.SDXL_TEXT_L) == t_text.SDXL_TEXT_L
    assert port_cfg(t_text.CLIPTextConfig, j_text.SDXL_TEXT_BIGG) == t_text.SDXL_TEXT_BIGG
    assert port_cfg(t_vae.VAEConfig, j_vae.SDXL_VAE) == t_vae.SDXL_VAE
    for base_model in tpipelines.BASE_MODELS:
        js, ts = jpipelines._spec(base_model), tpipelines._spec(base_model)
        assert ts.is_xl == js.is_xl and ts.scheduler_cfg.timestep_spacing == js.scheduler_cfg.timestep_spacing
        assert ts.text_cfgs == tuple(port_cfg(t_text.CLIPTextConfig, c) for c in js.text_cfgs), base_model
        assert ts.vae_cfg == port_cfg(t_vae.VAEConfig, js.vae_cfg), base_model


def _bridged_shapes(tree) -> dict:
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        shape = tuple(leaf.shape)
        if path[-1].key == "kernel":  # the bridge's transposes
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        want[".".join(k.key for k in path)] = shape
    return want


def test_full_width_trees_match_jax():
    """At SDXL's published widths (UNet 320/640/1280, depth 1/2/10, heads
    5/10/20, cross width 2048, linear projections, add_embedding 2816;
    ControlNet-XL; OpenCLIP bigG 32 x 1280 with its 1280 projection) the
    port's modules hold exactly the flax trees' leaves, in the bridge's
    layout (jax.eval_shape and the meta device: nothing is computed)."""
    key = jax.random.PRNGKey(0)
    cfg = j_unet.SDXL_UNET
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 77, cfg.cross_attention_dim))
    ac = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, 6))}
    trees = {
        "unet": jax.eval_shape(lambda: j_unet.UNet2DCondition(cfg=cfg).init(key, lat, t, ctx, added_cond=ac)),
        "controlnet": jax.eval_shape(lambda: JaxControlNet(cfg=cfg).init(
            key, lat, t, ctx, jnp.zeros((1, 64, 64, 3)), 1.0, added_cond=ac)),
        "bigG": jax.eval_shape(lambda: j_text.CLIPTextEncoder(cfg=j_text.SDXL_TEXT_BIGG).init(
            key, jnp.zeros((1, 77), jnp.int32))),
    }
    ports = {"unet": t_unet.UNet2DCondition(t_unet.SDXL_UNET, device="meta"),
             "controlnet": ControlNet(t_unet.SDXL_UNET, device="meta"),
             "bigG": t_text.CLIPTextEncoder(t_text.SDXL_TEXT_BIGG, device="meta")}
    for name, tree in trees.items():
        want = _bridged_shapes(tree["params"])
        got = {k: tuple(v.shape) for k, v in ports[name].state_dict().items()}
        assert got == want, (name, sorted(set(got.items()) ^ set(want.items()))[:6])
    n = sum(p.numel() for m in ports.values() for p in m.parameters())
    assert 4.4e9 < n < 4.6e9, n  # UNet 2.57 B + ControlNet-XL 1.25 B + bigG 0.69 B


# ---- the towers ----------------------------------------------------------------

def test_openclip_pad_matches_jax(params):
    """Only the first EOT of a row survives; later EOT padding becomes 0."""
    tp = port_pipe(params)
    ids = _ids(tp, PROMPTS + ["x " * 100])
    want = np.asarray(jpipelines._openclip_pad(jnp.asarray(ids)))
    got = openclip_pad(torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want) and not np.array_equal(got, ids)


@pytest.mark.parametrize("tower", [0, 1])
def test_text_tower_matches_jax(params, tower):
    """The ViT-L-style tower (quick-gelu) and the bigG-style one (exact-erf
    gelu, projection) on their ids: the raw penultimate layer, ln_final's
    EOT-pooled output and (bigG) its projection."""
    tp = port_pipe(params)
    ids = _ids(tp)
    if tower == 1:
        ids = openclip_pad(torch.from_numpy(ids)).numpy()
    tree = params["text"][tower]
    want = j_text.CLIPTextEncoder(cfg=GX_TEXT[tower]).apply({"params": tree}, jnp.asarray(ids))
    got = tp.params["text"][tower](torch.from_numpy(ids).long())
    assert sorted(got) == sorted(want) == (["hidden", "pooled", "proj"] if tower else ["hidden", "pooled"])
    for k in want:
        _close(got[k], want[k], 2e-5)


def test_encode_ids_matches_jax(params):
    """Both towers on EOT-padded ids: hidden states concatenated to 48, the
    pooled output taken from bigG's projection."""
    jp, tp = jax_pipe(params), port_pipe(params)
    ids = _ids(tp)
    want_ctx, want_pooled = jp._encode_ids(jp.params["text"], jnp.asarray(ids))
    got_ctx, got_pooled = tp.encode_ids(tp.params["text"], ids)
    assert tuple(got_ctx.shape) == (3, 77, 48) and tuple(got_pooled.shape) == (3, 32)
    _close(got_ctx, want_ctx, 2e-5)
    _close(got_pooled, want_pooled, 2e-5)
    want_tids, _ = jp._make_time_ids(3, 64, 48)
    assert np.array_equal(tp.make_time_ids(3, 64, 48).numpy(), np.asarray(want_tids))


# ---- UNet and ControlNet -------------------------------------------------------

def test_unet_matches_jax(params):
    """The UNet with text_time added conditions and linear projections, at
    batch 2 on 16x16 latents (the transformer level at 256 tokens takes the
    port's packed attention); an added-cond batch other than the sample's
    raises, as JAX's assertion does."""
    rng = np.random.RandomState(2)
    sample = rng.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 48).astype(np.float32)
    ac = _added_cond(rng, 2, 32)
    want = jax.jit(j_unet.UNet2DCondition(cfg=LX_UNET).apply)(  # jitted: flax's eager dispatch takes longer
        {"params": params["unet"]}, jnp.asarray(sample), jnp.asarray(499), jnp.asarray(ctx),
        added_cond=jax.tree_util.tree_map(jnp.asarray, ac))
    unet = t_unet.UNet2DCondition(P_LX_UNET, F32, "cpu").eval()
    unet.load_state_dict(state_dict_from_flax(params["unet"]), strict=True)
    tac = {k: torch.from_numpy(v) for k, v in ac.items()}
    with torch.no_grad():
        got = unet(_nchw(sample), 499, torch.from_numpy(ctx), added_cond=tac)
    _close(got.permute(0, 2, 3, 1), want, 1e-4)
    with pytest.raises(ValueError, match="no CFG shared prefix"):
        unet(_nchw(sample[:1]), 499, torch.from_numpy(ctx), added_cond=tac)


def test_controlnet_matches_jax(params):
    """ControlNet-XL: the added conditions in its time embedding, the
    conditioning embedding of a [0, 1] control image, scale 0.75: every
    down residual and the mid residual."""
    rng = np.random.RandomState(3)
    sample = rng.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 48).astype(np.float32)
    cond = rng.rand(2, 128, 128, 3).astype(np.float32)  # 8x the latents
    ac = _added_cond(rng, 2, 32)
    want_down, want_mid = JaxControlNet(cfg=LX_UNET).apply(
        {"params": params["controlnet"]}, jnp.asarray(sample), jnp.asarray(999), jnp.asarray(ctx),
        jnp.asarray(cond), 0.75, added_cond=jax.tree_util.tree_map(jnp.asarray, ac))
    cn = ControlNet(P_LX_UNET, F32, "cpu").eval()
    cn.load_state_dict(state_dict_from_flax(params["controlnet"]), strict=True)
    with torch.no_grad():
        emb = cn.embed_cond(_nchw(cond))
        down, mid = cn(_nchw(sample), 999, torch.from_numpy(ctx), emb, 0.75,
                       {k: torch.from_numpy(v) for k, v in ac.items()})
    assert len(down) == len(want_down) == 4
    for g, w in zip(down + [mid], list(want_down) + [want_mid]):
        _close(g.permute(0, 2, 3, 1), w, 1e-4)


# ---- the fused path ------------------------------------------------------------

@pytest.mark.parametrize("base_model,gs", [("sd_xl-turbo", 0.0), ("sd_xl", 7.5)])
def test_fused_generate_matches_jax(params, base_model, gs):
    """make_fused_generate at 64^2 (32x32 latents), 2 DDIM steps, canny
    ControlNet at 0.75: SDXL-Turbo's recipe (trailing steps 999, 499,
    guidance 0, no negative tower) and sd_xl under CFG 7.5 (leading steps;
    the latents, the ControlNet embedding and the [uncond, cond] added
    conditions at 2B), against JAX's fused program on the same ids,
    sources and noise."""
    jp, tp = jax_pipe(params, base_model), port_pipe(params, base_model)
    assert list(tp.scheduler.timesteps(2)) == list(np.asarray(jp.scheduler.timesteps(2)))
    rng = np.random.RandomState(4)
    b, res = 2, 64
    src = (rng.rand(b, res, res, 3) * 255).astype(np.uint8)
    lat = rng.randn(b, res // 2, res // 2, 4).astype(np.float32)
    ids, nids = _ids(tp, PROMPTS[:2]), _ids(tp, ["blurry, low quality"] * b)
    want = jp.make_fused_generate(res, res, 2, gs)(jp.params, *map(jnp.asarray, (ids, nids, src, lat)))
    got = tp.make_fused_generate(res, res, 2, gs)(tp.params, ids, nids, src, lat)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, res, res, 3)
    _images_close(got.numpy(), want)


def test_golden_xl_replay(golden):
    """tests/fixtures/golden_gen_xl.npz (SDXL-Turbo, no ControlNet, 1x1-conv
    projections): its params, ids, source and latents through the port's
    fused function, 2 trailing steps at guidance 0, to its `expected` within
    1 uint8 level (>= 99% exactly)."""
    tp = port_pipe(_unflatten_params(golden), controlnet=None, unet_cfg=P_GX_UNET)
    ids = golden["token_ids"]
    got = tp.make_fused_generate(64, 64, 2, 0.0)(tp.params, ids, ids * 0, golden["src"], golden["latents"])
    assert got.dtype == torch.uint8
    _images_close(got.numpy(), golden["expected"])
