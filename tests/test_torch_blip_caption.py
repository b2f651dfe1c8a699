"""Parity of the port's BLIP captioner with the JAX package, on the CPU.

Tiny configs (ViT 32^2, patch 16, width 16, 1 layer, 2 heads; BERT width
16, 2 layers, 2 heads, FFN 32, BLIP's vocabulary of 30524), f32, one
seeded flax-layout tree handed to both packages (the JAX wrapper as preset
params, the port through the bridge).  Tolerances: the ViT tokens and the
logits within 1e-5 of the largest output (f32 sums in another order);
greedy ids and the decoded captions equal.  `blip_preprocess` is held
within 16 * 2^-24 of a [0, 1] pixel divided by the smallest std: the
resize's contraction runs in XLA's summation order, which torch does not
reproduce, and XLA's own result lies up to 11 * 2^-24 from the exact sum
at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import blip_caption as J
from saspa_tpu_torch.models import blip_caption as T

VIT = dict(image_size=32, patch_size=16, width=16, layers=1, heads=2)
TEXT = dict(width=16, layers=2, heads=2, intermediate=32)
MAX_LEN = 8


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share a few cores: torch's thread a core would
    oversubscribe them (tests/test_torch_blip_edit.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def seeded_tree(module: torch.nn.Module, seed: int) -> dict:
    """A flax-layout tree for every parameter of a port module: kernels
    N(0, 1/fan_in) in flax's layout, norm scales and RMS weights
    1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for key, t in module.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[1:]))
            shape = shape[::-1] if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif leaf in ("scale", "weight"):
            value = 1 + 0.1 * rng.randn(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        node = tree
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value.astype(np.float32)
    return tree


def jax_apply(model, params, *args, method=None):
    """model.apply jitted: flax's eager dispatch of the tiny models takes
    longer than their compile."""
    return jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))(params, *args)


def images(seed: int, shapes) -> list:
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (1, h, w, 3)).astype(np.uint8) for h, w in shapes]


@pytest.fixture(scope="module")
def captioners():
    port = T.TorchBlipCaptioner(max_len=MAX_LEN, vit=T.BlipViTConfig(**VIT), text=T.BlipTextConfig(**TEXT),
                                device="cpu", seed=3)
    tree = seeded_tree(port.model, 7)
    port = T.TorchBlipCaptioner(max_len=MAX_LEN, vit=T.BlipViTConfig(**VIT), text=T.BlipTextConfig(**TEXT),
                                params=tree, device="cpu")
    jax_cap = J.FlaxBlipCaptioner(max_len=MAX_LEN, vit=J.BlipViTConfig(**VIT), text=J.BlipTextConfig(**TEXT),
                                  params=jax.tree_util.tree_map(jnp.asarray, tree))
    return port, jax_cap


@pytest.mark.parametrize("hw,size", [((40, 56), 32), ((20, 28), 32), ((33, 47), 48), ((48, 48), 48)])
def test_blip_preprocess_matches_jax(hw, size):
    img = images(hw[0] * 100 + hw[1], [hw])[0]
    got = T.blip_preprocess(img, size).numpy()
    want = np.asarray(J.blip_preprocess(img, size))
    if hw == (size, size):  # no resize: the same division, bit for bit
        np.testing.assert_array_equal(got, want)
    bound = 16 * 2.0 ** -24 / min(T.CLIP_STD)
    assert got.shape == want.shape and np.abs(got - want).max() <= bound, np.abs(got - want).max() / bound


def test_vit_decoder_and_captioner_logits_match_flax(captioners):
    port, jax_cap = captioners
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    ids = np.random.RandomState(1).randint(0, T.VOCAB, (2, 6)).astype(np.int32)
    jm = jax_cap.model
    j_tokens = jax_apply(jm, jax_cap.params, jnp.asarray(x), method=J.BlipCaptioner.encode_image)
    j_logits = jax_apply(jm, jax_cap.params, jnp.asarray(x), jnp.asarray(ids))
    with torch.no_grad():
        t_tokens = port.model.encode_image(torch.from_numpy(x))
        t_logits = port.model(torch.from_numpy(x), torch.from_numpy(ids).long())
        t_step = port.model.decode_step_logits(torch.from_numpy(ids).long(), torch.from_numpy(np.array(j_tokens)))
    _close(t_tokens, j_tokens, 1e-5)
    _close(t_logits, j_logits, 1e-5)
    j_step = jax_apply(jm, jax_cap.params, jnp.asarray(ids), j_tokens, method=J.BlipCaptioner.decode_step_logits)
    _close(t_step, j_step, 1e-5)


def test_greedy_ids_and_captions_match_jax(captioners):
    port, jax_cap = captioners
    batch = np.concatenate(images(11, [(40, 56), (40, 56), (40, 56)]))
    want_text = jax_cap.caption_batch(batch)
    want_ids = np.asarray(jax_cap._decode_jit(jax_cap.params, J.blip_preprocess(batch, 32)))
    got_ids, margins = port.caption_ids(batch, return_margins=True)
    n0 = len(port.prompt_ids())
    assert margins.shape == (3, MAX_LEN - n0) and bool((margins >= 0).all())
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert port.caption_batch(batch) == want_text
    assert (want_ids[:, n0:] != T.PAD_ID).any()  # the decode wrote tokens


def test_caption_of_a_png_path_matches_jax(captioners, tmp_path):
    from PIL import Image

    port, jax_cap = captioners
    img = images(12, [(30, 44)])[0][0]
    path = tmp_path / "src.jpg"  # PNG bytes under a .jpg name, as the datasets' sources
    Image.fromarray(img).save(path, format="PNG")
    assert port(str(path)) == jax_cap(str(path))
