"""Parity of the port's BLIP-Diffusion path with the JAX package, on the CPU.

Tiny configs of tests/test_blip_edit.py::_tiny_blip_pipe (ViT width 32, 1
layer, patch 32, 2 heads; Q-Former width 32, 1 layer; the tiny SD1.5 of
tests/test_diffusion_pipeline.py), f32.  The params are those of
tests/fixtures/golden_gen_blip.npz, carried into the port through the
bridge; the JAX pipeline takes them as preset params (its own seeded init of
the tiny UNet costs about a minute on a CPU).  The canny variant adds a
ControlNet whose encoder is the UNet's and whose conditioning embedding and
zero convs are seeded nonzero.  Inputs are numpy arrays from a seed, handed
to both packages.  Tolerances: the towers within 2e-5 of the largest output
(f32 summation order differs between XLA and torch); clip_preprocess
bit-equal at 224^2 (jax skips a same-size resize), otherwise within 8 f32
ulps of a [0, 1] pixel divided by the smallest std; token ids equal; uint8 images within 1 level,
>= 99% of them exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from saspa_tpu.diffusion.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from saspa_tpu.models.blip_caption import WordPieceTokenizer as JaxWordPiece
from saspa_tpu.models.blip_diffusion import BlipDiffusionPipeline as JaxBlipPipeline
from saspa_tpu.models.blip_diffusion import QFormer as JaxQFormer
from saspa_tpu.models.clip import CLIPVisionViT as JaxViT
from saspa_tpu.models.clip import CLIPVisionViTConfig as JaxViTConfig
from saspa_tpu.models.clip import clip_preprocess as jax_clip_preprocess
from saspa_tpu.models.text_encoder import CLIPTextEncoder as JaxTextEncoder
from saspa_tpu_torch.models import text_encoder as t_text
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.models.blip_caption import WordPieceTokenizer
from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline, QFormer, QFormerConfig
from saspa_tpu_torch.models.clip import CLIP_STD, CLIPVisionViT, CLIPVisionViTConfig, clip_preprocess
from saspa_tpu_torch.ops.image import pil_resize
from tests.test_diffusion_pipeline import TINY_TEXT, TINY_UNET, TINY_VAE
from tests.test_golden_families import GOLDEN_BLIP_PATH
from tests.test_golden_generation import _unflatten_params

# the port's copies of the tiny configs
T_UNET = t_unet.UNetConfig(
    block_out_channels=TINY_UNET.block_out_channels, down_block_types=TINY_UNET.down_block_types,
    up_block_types=TINY_UNET.up_block_types, layers_per_block=TINY_UNET.layers_per_block,
    transformer_layers_per_block=TINY_UNET.transformer_layers_per_block,
    num_attention_heads=TINY_UNET.num_attention_heads, cross_attention_dim=TINY_UNET.cross_attention_dim,
)
T_VAE = t_vae.VAEConfig(block_out_channels=TINY_VAE.block_out_channels, layers_per_block=TINY_VAE.layers_per_block)
T_TEXT = (t_text.CLIPTextConfig(width=32, layers=2, heads=2),)
T_VISION = CLIPVisionViTConfig(width=32, layers=1, heads=2, output_dim=None, patch_size=32)
T_QFORMER = QFormerConfig(width=32, layers=1, heads=2, out_dim=32, encoder_width=32)
J_VISION = JaxViTConfig(width=32, layers=1, heads=2, output_dim=None, patch_size=32)
META = "airplane"


def _close(got, want, rel):
    """|got - want| <= rel * max|want| elementwise."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def _images_close(got, want):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    assert d.max() <= 1 and np.mean(d == 0) >= 0.99, (d.max(), np.mean(d == 0))


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def random_flax_tree(module: torch.nn.Module, rng: np.random.RandomState, base=None) -> dict:
    """A flax-layout tree for every parameter of a port module: the leaf at
    the same path in `base` where there is one, else seeded values (kernels
    N(0, 1/fan_in) in flax's layout, norm scales 1 + N(0, 0.1^2), the rest
    N(0, 0.1^2))."""
    flat = {}
    for key, t in module.state_dict().items():
        node = base
        for p in key.split("."):
            node = node.get(p) if isinstance(node, dict) else None
        if node is not None:
            flat[key] = np.array(node, np.float32)
            continue
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[1:]))
            shape = shape[::-1] if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])
            flat[key] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        elif leaf == "scale":
            flat[key] = (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            flat[key] = (0.1 * rng.randn(*shape)).astype(np.float32)
    return _nest(flat)


def port_pipe(params, controlnet=None) -> BlipDiffusionPipeline:
    tp = BlipDiffusionPipeline(controlnet=controlnet, device="cpu", dtype=torch.float32, init_seed=None,
                               unet_cfg=T_UNET, vae_cfg=T_VAE, text_cfgs=T_TEXT, vision_cfg=T_VISION,
                               qformer_cfg=T_QFORMER)
    tp.load_flax_params(params)
    return tp


class _PresetJaxBlip(JaxBlipPipeline):
    """The JAX BLIP pipeline with given SD params instead of its seeded init."""

    preset = None

    def _init_params(self, weights_dir, seed):
        return jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in self.preset.items()
                                                    if not k.startswith("blip_")})


def jax_pipe(params, controlnet=None) -> JaxBlipPipeline:
    """tests/test_blip_edit.py::_tiny_blip_pipe with `params` preset."""
    _PresetJaxBlip.preset = params
    pipe = _PresetJaxBlip.__new__(_PresetJaxBlip)
    JaxDiffusionPipeline.__init__(
        pipe, base_model="blip_diffusion-controlnet" if controlnet else "blip_diffusion", controlnet=controlnet,
        sampler="ddim", dtype=jnp.float32, unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, text_cfgs=TINY_TEXT)
    pipe.vision = JaxViT(cfg=J_VISION, dtype=jnp.float32)
    pipe.qformer = JaxQFormer(width=32, layers=1, heads=2, out_dim=32, dtype=jnp.float32)
    for k in ("blip_vision", "blip_qformer"):
        pipe.params[k] = jax.tree_util.tree_map(jnp.asarray, params[k])
    pipe._bert_tok = JaxWordPiece(None)
    return pipe


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_BLIP_PATH)


def blip_params() -> dict:
    """{None: the golden fixture's params, "canny": the same plus a ControlNet}."""
    base = _unflatten_params(np.load(GOLDEN_BLIP_PATH))
    shell = BlipDiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                                  unet_cfg=T_UNET, vae_cfg=T_VAE, text_cfgs=T_TEXT, vision_cfg=T_VISION,
                                  qformer_cfg=T_QFORMER)
    cn = random_flax_tree(shell.params["controlnet"], np.random.RandomState(17), base=base["unet"])
    return {None: base, "canny": {**base, "controlnet": cn}}


@pytest.fixture(scope="module")
def params():
    return blip_params()


def _refs(seed, b=2, h=224, w=224):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


# ---- the towers ---------------------------------------------------------------

def test_full_width_trees_match_jax():
    """At BLIP-Diffusion's published widths (ViT-L/14: 1024 wide, 24 layers;
    Q-Former: 768 wide, 12 layers over the 1024-wide image tokens) the
    port's modules hold exactly the flax trees' leaves, in the bridge's
    layout (shapes from jax.eval_shape and the meta device: nothing is
    computed)."""
    from saspa_tpu.models.blip_diffusion import _CAT_LEN
    from saspa_tpu_torch.models.blip_diffusion import BLIP_VISION

    key = jax.random.PRNGKey(0)
    vit = JaxViT(cfg=JaxViTConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=None))
    trees = {
        "blip_vision": jax.eval_shape(lambda: vit.init(key, jnp.zeros((1, 224, 224, 3)), return_tokens=True)),
        "blip_qformer": jax.eval_shape(lambda: JaxQFormer().init(
            key, jnp.zeros((1, 257, 1024)), jnp.zeros((1, _CAT_LEN), jnp.int32), jnp.ones((1, _CAT_LEN), jnp.int32))),
    }
    ports = {"blip_vision": CLIPVisionViT(BLIP_VISION, device="meta"), "blip_qformer": QFormer(device="meta")}
    for name, tree in trees.items():
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree["params"]):
            shape = tuple(leaf.shape)
            if path[-1].key == "kernel":  # the bridge's transposes
                shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
            want[".".join(k.key for k in path)] = shape
        got = {k: tuple(t.shape) for k, t in ports[name].state_dict().items()}
        assert got == want, (name, sorted(set(got.items()) ^ set(want.items()))[:6])


@pytest.mark.parametrize("return_tokens", [True, False])
def test_vit_matches_jax(params, return_tokens):
    """The vision tower on clip_preprocess'd images: the tokens after
    ln_post (BLIP's input), and the pooled class token through a 16-wide
    projection (a seeded `proj` added to the fixture's tree)."""
    tree = dict(params[None]["blip_vision"])
    if not return_tokens:
        tree["proj"] = {"kernel": np.random.RandomState(4).randn(32, 16).astype(np.float32) / np.sqrt(32)}
    out_dim = None if return_tokens else 16
    x = np.array(jax_clip_preprocess(jnp.asarray(_refs(1))))
    want = JaxViT(cfg=JaxViTConfig(width=32, layers=1, heads=2, output_dim=out_dim, patch_size=32)).apply(
        {"params": tree}, jnp.asarray(x), return_tokens=return_tokens)
    vit = CLIPVisionViT(CLIPVisionViTConfig(width=32, layers=1, heads=2, output_dim=out_dim, patch_size=32))
    vit.load_state_dict(_flat_state_dict(tree), strict=True)
    got = vit(torch.from_numpy(x).permute(0, 3, 1, 2), return_tokens=return_tokens)
    assert tuple(got.shape) == ((2, 50, 32) if return_tokens else (2, 16))
    _close(got, want, 2e-5)


def _flat_state_dict(tree):
    from saspa_tpu_torch.bridge import state_dict_from_flax

    return state_dict_from_flax(tree)


@pytest.mark.parametrize("h,w", [(224, 224), (300, 400), (150, 100)])
def test_clip_preprocess_matches_jax(h, w):
    """As the fused program runs it (jitted): 224^2 is the identity resize,
    bit-equal; 300x400 downscales (antialiased Keys cubic) and centre-crops
    the width; 150x100 upscales."""
    x = _refs(h * w, b=2, h=h, w=w)
    want = np.asarray(jax.jit(jax_clip_preprocess)(jnp.asarray(x)))
    got = clip_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    if (h, w) == (224, 224):
        assert np.array_equal(got, want)
    else:  # 8 f32 ulps of a [0, 1] pixel, divided by the smallest std
        assert np.abs(got - want).max() <= 8 * 2.0 ** -23 / min(CLIP_STD)


@pytest.mark.parametrize("text", ["none", "full", "padded"])
def test_qformer_matches_jax(text):
    """A 3-layer Q-Former (cross-attention on layers 0 and 2, so the text
    half's FFN feeds later layers) over 48-wide image tokens (the vision
    tower's width differs from the Q-Former's) with seeded params: without
    category text, with text and no mask, and with the padded mask of
    bert_category_ids."""
    cfg = QFormerConfig(width=32, layers=3, heads=2, out_dim=32, encoder_width=48)
    port = QFormer(cfg)
    tree = random_flax_tree(port, np.random.RandomState(9))
    port.load_state_dict(_flat_state_dict(tree), strict=True)
    tokens = np.random.RandomState(2).randn(2, 50, 48).astype(np.float32)
    tok = WordPieceTokenizer()
    ids = np.zeros((2, 24), np.int32)
    mask = np.zeros((2, 24), np.int32)
    for i, cat in enumerate(["aston martin v8 vantage convertible 2012", "banded"]):
        row = [101] + tok.encode(cat) + [102]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    args = {"none": (), "full": (ids,), "padded": (ids, mask)}[text]
    want = JaxQFormer(width=32, layers=3, heads=2, out_dim=32).apply(
        {"params": tree}, jnp.asarray(tokens), *map(jnp.asarray, args))
    got = port(torch.from_numpy(tokens), *args)
    assert tuple(got.shape) == (2, 16, 32)
    _close(got, want, 2e-5)


def test_spliced_text_encoder_matches_jax(params):
    """_encode_with_ctx: 16 seeded subject embeddings spliced at position 2
    of 61-wide prompt ids; the text tower's spliced_embeddings alone too.
    77-wide ids raise, as in JAX."""
    jp, tp = jax_pipe(params[None]), port_pipe(params[None])
    ids = tp.build_subject_prompt_ids(["parked at night", "flying low"], META)
    ctx = np.random.RandomState(6).randn(2, 16, 32).astype(np.float32)
    want = jp._encode_with_ctx(jp.params, jnp.asarray(ids), jnp.asarray(ctx))
    got = tp._encode_with_ctx(tp.params, ids, torch.from_numpy(ctx))
    _close(got, want, 2e-5)
    full = tp.tokenizer(["a car", "a dog"], pad="eot")
    emb = np.random.RandomState(8).randn(2, 77, 32).astype(np.float32)
    want = JaxTextEncoder(cfg=TINY_TEXT[0]).apply({"params": params[None]["text"][0]}, jnp.asarray(full),
                                                  spliced_embeddings=jnp.asarray(emb))["hidden"]
    got = tp.params["text"][0](torch.from_numpy(full).long(), spliced_embeddings=torch.from_numpy(emb))["hidden"]
    _close(got, want, 2e-5)
    with pytest.raises(ValueError, match="build_subject_prompt_ids"):
        tp._encode_with_ctx(tp.params, full, torch.from_numpy(ctx))


def test_token_ids_match_jax(params, tmp_path):
    """bert_category_ids (empty, short, past the 24-token budget) and
    build_subject_prompt_ids equal JAX's; the WordPiece tokenizer equals
    JAX's with its hash fallback and with a vocabulary."""
    jp, tp = jax_pipe(params[None]), port_pipe(params[None])
    for cat in ["", "texture", "car", " ".join(f"word{i}" for i in range(30)), "Boeing 707-320, (x)!"]:
        for a, b in zip(jp.bert_category_ids(cat, 3), tp.bert_category_ids(cat, 3)):
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), cat
    prompts = ["a close up of a striped wallpaper", "", "x" * 300]
    for subject in (META, "texture"):
        want = np.asarray(jp.build_subject_prompt_ids(prompts, subject))
        got = tp.build_subject_prompt_ids(prompts, subject)
        assert got.shape == (3, 61) and np.array_equal(got, want)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "air", "##plane", "##s", "car", "un", "##aff", "##able"]))
    for path in (None, str(vocab)):
        jt, pt = JaxWordPiece(path), WordPieceTokenizer(path)
        for text in ["airplanes car", "unaffable", "zebra", "Airplane-car 12"]:
            assert pt.encode(text) == jt.encode(text), (path, text)
            assert pt.decode(pt.encode(text) + [0, 102]) == jt.decode(jt.encode(text) + [0, 102])


@pytest.mark.parametrize("h,w", [(64, 64), (512, 512), (64, 85), (224, 224)])
def test_reference_resize_is_pils_default(h, w):
    """The driver's reference resize: PIL's Image.resize((224, 224)) with its
    default resample, bit for bit."""
    img = (np.random.RandomState(h + w).rand(h, w, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224)))
    assert np.array_equal(pil_resize(img, (224, 224)), want)


# ---- the fused path -----------------------------------------------------------

@pytest.mark.parametrize("controlnet", [None, "canny"])
def test_fused_generate_matches_jax(params, controlnet):
    """make_fused_generate at 64^2, 3 DDIM steps, CFG 7.5, ControlNet scale
    0.75: towers, splice, Canny, denoise and decode against JAX's fused
    program on the same ids, category ids, references, sources and noise."""
    jp, tp = jax_pipe(params[controlnet], controlnet), port_pipe(params[controlnet], controlnet)
    rng = np.random.RandomState(3)
    b, res = 2, 64
    refs = _refs(4)
    src = (rng.rand(b, res, res, 3) * 255).astype(np.uint8)
    lat = rng.randn(b, res // tp.latent_factor, res // tp.latent_factor, 4).astype(np.float32)
    ids = tp.build_subject_prompt_ids(["flying over mountains", "parked at night"], META)
    nids = tp.tokenizer([""] * b, pad="eot")
    cat_ids, cat_mask = tp.bert_category_ids(META, b)
    want = jp.make_fused_generate(res, res, 3, 7.5)(
        jp.params, *map(jnp.asarray, (ids, nids, cat_ids, cat_mask, refs, src, lat)))
    got = tp.make_fused_generate(res, res, 3, 7.5)(tp.params, ids, nids, cat_ids, cat_mask, refs, src, lat)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, res, res, 3)
    _images_close(got.numpy(), want)


def test_golden_blip_replay(golden, params):
    """tests/fixtures/golden_gen_blip.npz: its params, ids, category ids,
    references, source and latents through the port's fused function, to
    its `expected` within 1 uint8 level (>= 99% exactly)."""
    tp = port_pipe(params[None])
    fn = tp.make_fused_generate(64, 64, 3, 7.5)
    got = fn(tp.params, golden["token_ids"], golden["neg_token_ids"], golden["cat_ids"], golden["cat_mask"],
             golden["refs"], golden["src"], golden["latents"])
    assert got.dtype == torch.uint8
    _images_close(got.numpy(), golden["expected"])
