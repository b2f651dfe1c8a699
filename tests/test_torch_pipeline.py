"""Parity of the PyTorch port's generation slice with the JAX package.

Tiny configs (tests/test_golden_generation.py's G_UNET/G_VAE/G_TEXT plus a
ControlNet of the same UNet config), f32, on the CPU.  Params are the golden
fixture's plus a ControlNet whose zero-initialised convs get seeded nonzero
values (otherwise the residual path compares zeros); the tree is carried
into the port through the bridge.  Inputs are numpy arrays from a
seed, handed to both packages.  The port runs with head-padded packed
attention wherever the token count qualifies (16x16 latents: 256 tokens),
the JAX package on the CPU with unpadded XLA attention: equal up to f32
rounding.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.diffusion.pipelines import DiffusionPipeline as JaxPipeline
from saspa_tpu.gen.tokenizer import CLIPTokenizer as JaxTokenizer
from saspa_tpu.utils.config import NEGATIVE_PROMPT as JAX_NEGATIVE_PROMPT
from saspa_tpu_torch.bridge import params_from_flax
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT, CLIPTokenizer
from saspa_tpu_torch.models import text_encoder as t_text
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE, GOLDEN_PATH, _unflatten_params

REPO = Path(__file__).resolve().parent.parent
# the port's own copies of the tiny configs
P_UNET = t_unet.UNetConfig(
    block_out_channels=G_UNET.block_out_channels, down_block_types=G_UNET.down_block_types,
    up_block_types=G_UNET.up_block_types, layers_per_block=G_UNET.layers_per_block,
    transformer_layers_per_block=G_UNET.transformer_layers_per_block,
    num_attention_heads=G_UNET.num_attention_heads, cross_attention_dim=G_UNET.cross_attention_dim,
)
P_VAE = t_vae.VAEConfig(block_out_channels=G_VAE.block_out_channels, layers_per_block=G_VAE.layers_per_block)
P_TEXT = (t_text.CLIPTextConfig(width=16, layers=2, heads=2),)


def tiny_params(seed=11):
    """The golden fixture's text/UNet/VAE params plus a ControlNet: its UNet
    encoder copied from the UNet (as a ControlNet is initialised), its
    conditioning embedding and zero convs seeded N(0, 0.05^2) (nonzero, so
    the residual path carries signal).  Flax layout, numpy leaves."""
    params = _unflatten_params(np.load(GOLDEN_PATH))
    rng = np.random.RandomState(seed)
    shell = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                              unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    cn = {}
    for key, t in shell.params["controlnet"].state_dict().items():
        path = key.split(".")
        src = params["unet"]
        for p in path:
            src = src.get(p) if isinstance(src, dict) else None
        if src is None:
            shape = tuple(t.shape)
            if path[-1] == "kernel":
                shape = shape[::-1] if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])
            src = (0.05 * rng.randn(*shape)).astype(np.float32)
        node = cn
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(src, np.float32)
    params["controlnet"] = cn
    return params


class _PresetJaxPipeline(JaxPipeline):
    """The JAX pipeline with given params instead of its seeded init."""

    preset = None

    def _init_params(self, weights_dir, seed):
        return jax.tree_util.tree_map(jnp.asarray, self.preset)


@pytest.fixture(scope="module")
def pipes():
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(params)
    return jp, tp, params


def _inputs(seed, b=2, size=32):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    src = np.empty((b, size, size, 3), np.uint8)
    for i in range(b):
        img = np.full((size, size, 3), rng.randint(0, 256, 3), np.float32)
        for _ in range(3):
            cy, cx, r = rng.randint(0, size, 2).tolist() + [rng.randint(3, 10)]
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
        src[i] = img
    lat = rng.randn(b, size // 2, size // 2, 4).astype(np.float32)
    return src, lat


def _ids(b=2):
    tok = CLIPTokenizer()
    prompts = ["a photo of a jet", "a small propeller plane"][:b]
    return tok(prompts, pad="eot"), tok([NEGATIVE_PROMPT] * b, pad="eot")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).permute(0, 3, 1, 2)


def _close(got, want, rel=1e-4):
    """f32 parity: |diff| <= rel * max|want| (summation order and conv
    algorithms differ between XLA and torch on the CPU)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-6, (err, scale)


# ---- bridge and tokenizer --------------------------------------------------

def test_bridge_maps_every_leaf_strictly(pipes):
    """load_state_dict(strict=True) passed in the fixture for text, UNet,
    ControlNet and VAE; every flax leaf maps to one torch entry, the VAE
    encoder's (quant_conv included) too."""
    _, tp, params = pipes
    n_leaves = len(jax.tree_util.tree_leaves(params))
    n_torch = sum(len(m.state_dict()) for m in tp._modules())
    assert n_torch == n_leaves
    sds = params_from_flax(params)
    enc = {k for k in sds["vae"] if k.startswith("encoder.")}
    assert len(enc) == len(jax.tree_util.tree_leaves(params["vae"]["encoder"])) > 0
    assert "encoder.quant_conv.kernel" in enc
    w = sds["unet"]["down_0_resnets_0.conv1.kernel"]
    assert tuple(w.shape) == np.asarray(params["unet"]["down_0_resnets_0"]["conv1"]["kernel"]).shape[::-1][:2] + (3, 3)


def test_tokenizer_copy_matches():
    prompts = ["a photo of a Boeing 747, high quality", "", "café — naïve 123!", "x" * 400]
    for pad in ("eot", "zero"):
        assert np.array_equal(CLIPTokenizer()(prompts, pad=pad), JaxTokenizer()(prompts, pad=pad))
    assert NEGATIVE_PROMPT == JAX_NEGATIVE_PROMPT


# ---- the slice ---------------------------------------------------------------

def test_fused_generate_matches_jax(pipes):
    """make_fused_generate on a tiny canny config: 32x32 uint8 sources (the
    control image is resized 32 -> 128 for the 16x16 latents), 2 DDIM steps,
    CFG 7.5, scale 0.75, f32.  uint8 outputs agree to 1 level (a rounding
    boundary can fall between the two f32 results), >= 99% exactly."""
    jp, tp, _ = pipes
    src, lat = _inputs(5)
    ids, neg = _ids()
    want = np.asarray(jp.make_fused_generate(32, 32, 2, 7.5)(jp.params, jnp.asarray(ids), jnp.asarray(neg),
                                                               jnp.asarray(src), jnp.asarray(lat)))
    got = tp.make_fused_generate(32, 32, 2, 7.5)(tp.params, ids, neg, src, lat).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 32, 32, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.99


def test_uint8_and_float_sources_give_the_same_output(pipes):
    _, tp, _ = pipes
    src, lat = _inputs(6)
    ids, neg = _ids()
    fn = tp.make_fused_generate(32, 32, 2, 7.5)
    a, ia = fn(tp.params, ids, neg, src, lat, return_images=True)
    b, ib = fn(tp.params, ids, neg, src.astype(np.float32), lat, return_images=True)
    assert torch.equal(a, b) and torch.equal(ia, ib)


def test_golden_ddim_replay():
    """tests/fixtures/golden_gen.npz: the JAX package's pinned 2-step DDIM
    output (CFG 7.5, no ControlNet), replayed through the port with the
    fixture's params, latents and token ids; f32, to 1e-4 of the range."""
    npz = np.load(GOLDEN_PATH)
    tp = DiffusionPipeline(controlnet=None, device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(_unflatten_params(npz))
    ids = torch.from_numpy(npz["token_ids"]).long()
    te = tp.params["text"][0]
    ctx, nctx = te(ids)["hidden"], te(ids * 0)["hidden"]
    out = tp._sample(tp.params, torch.from_numpy(npz["latents"]), ctx, nctx, tp.scheduler.timesteps(2),
                     guidance_scale=7.5)
    _close(out, npz["expected_ddim"], rel=1e-4)


def test_port_imports_no_jax():
    """`import saspa_tpu_torch` (and every module of the slice) loads neither
    jax nor saspa_tpu; chip_smoke.py's source imports neither."""
    code = (
        "import sys, importlib, pkgutil, saspa_tpu_torch\n"
        "for m in pkgutil.walk_packages(saspa_tpu_torch.__path__, 'saspa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'saspa_tpu'))\n"
        "assert not bad, bad\n"
        # the prompt and caption tools' modules are among them
        "new = ['saspa_tpu_torch.models.blip_caption', 'saspa_tpu_torch.models.blip_vqa', 'saspa_tpu_torch.models.t5',\n"
        "       'saspa_tpu_torch.gen.caption_tools', 'saspa_tpu_torch.gen.recipes', 'saspa_tpu_torch.utils.misc_tools']\n"
        "assert all(m in sys.modules for m in new), [m for m in new if m not in sys.modules]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    import ast

    sources = [p for p in sorted((REPO / "saspa_tpu_torch").rglob("*.py")) if "_build" not in p.parts]
    for path in [REPO / "chip_smoke.py", *sources]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "saspa_tpu"), (path, n)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from saspa_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionPipeline(controlnet=None, unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    assert resolve_device("cpu").type == "cpu"
