"""The train stage's draws, views and transforms against the JAX package's,
on the CPU.

* utils/rng.py's split, uniform_f32, bernoulli, randint, gumbel and categorical
  against jax.random for the keys the train path uses: bit-equal.
* batch_augment's crop and drop (the file's jitted JAX function, ops/
  batch_augment.py's own jit): boxes equal, views within 1e-6 (measured:
  bit-equal at these shapes), with drawn and injected thetas.
* the classic, classic_no_color and center-crop train transforms and the val
  transform, from the same key: within 1e-6 (measured: bit-equal); an
  unknown preset raises (RandAugment, AutoAugment and CutMix:
  tests/test_torch_train_recipes.py).
* the copied host resize bit-equal to the JAX package's native build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.native import native_available
from saspa_tpu.native import resize_bilinear_u8 as j_resize
from saspa_tpu.ops import augment as jaug
from saspa_tpu.ops import batch_augment as jba
from saspa_tpu_torch.ops import augment as taug
from saspa_tpu_torch.ops import batch_augment as tba
from saspa_tpu_torch.ops.host_resize import resize_bilinear_u8 as t_resize
from saspa_tpu_torch.utils import rng as trng

KEYS = [("dropout", 0, 0), ("dropout", 3, 17), ("augment", 1, 2), ("attention_pick", 0, 5)]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("where", KEYS)
def test_draws_equal_jax_random(where):
    key = trng.item_key(1, *where)
    jk = jnp.asarray(key)
    assert np.array_equal(trng.split(key, 4), np.asarray(jax.random.split(jk, 4)))
    for lo, hi in ((0.0, 2.0), (0.4, 0.6), (0.2, 0.5), (1 - 0.126, 1 + 0.126), (0.5, 1.5)):
        assert np.array_equal(trng.uniform_f32(key, (4, 7, 7, 32), lo, hi),
                              np.asarray(jax.random.uniform(jk, (4, 7, 7, 32), jnp.float32, lo, hi)))
    assert np.array_equal(trng.bernoulli(key, 0.5, (16, 1, 1, 1)), np.asarray(jax.random.bernoulli(jk, 0.5, (16, 1, 1, 1))))
    assert np.array_equal(trng.randint(key, (16,), 0, 33), np.asarray(jax.random.randint(jk, (16,), 0, 33)))
    assert np.array_equal(trng.gumbel(key, (6, 2, 32)), np.asarray(jax.random.gumbel(jk, (6, 2, 32))))
    logits = np.log(np.random.RandomState(where[2]).dirichlet(np.ones(32))).astype(np.float32)
    assert np.array_equal(trng.categorical(key, logits, (2,)), np.asarray(jax.random.categorical(jk, logits, shape=(2,))))


@pytest.mark.parametrize("shape", [(8, 64, 4), (4, 224, 14), (3, 96, 7)])
@pytest.mark.parametrize("mode", ["crop", "drop", "eval_crop", "injected"])
def test_batch_augment_matches_jax(shape, mode):
    b, h, ah = shape
    rng = np.random.RandomState(h + ah)
    X = rng.randn(b, h, h, 3).astype(np.float32)
    A = (np.maximum(rng.randn(b, ah, ah), 0) * 3).astype(np.float32)
    key = trng.item_key(1, "dropout", 0, b)
    kw = {"crop": dict(mode="crop", theta=(0.4, 0.6), padding_ratio=0.1),
          "drop": dict(mode="drop", theta=(0.2, 0.5)),
          "eval_crop": dict(mode="crop", theta=0.1, padding_ratio=0.05),
          "injected": dict(mode="crop", theta=(0.4, 0.6), padding_ratio=0.1)}[mode]
    thetas = rng.uniform(0.2, 0.9, b).astype(np.float32) if mode == "injected" else None
    want = np.asarray(jba.batch_augment(jnp.asarray(X), jnp.asarray(A), jnp.asarray(key),
                                        thetas=None if thetas is None else jnp.asarray(thetas), **kw))
    got = tba.batch_augment(_nchw(X), torch.from_numpy(A), key,
                            thetas=None if thetas is None else torch.from_numpy(thetas), **kw)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-6
    if kw["mode"] == "crop":  # the boxes themselves, against JAX's mask, bbox and truncation
        th = thetas if thetas is not None else tba.draw_thetas(key, kw["theta"], b)
        th = th * A.max(axis=(1, 2))
        up = np.asarray(jax.image.resize(jnp.asarray(A), (b, h, h), method="linear"))
        boxes = tba.crop_boxes(torch.from_numpy(A), torch.from_numpy(th), h, h, kw["padding_ratio"]).numpy()
        for i in range(b):
            ys, xs = np.nonzero(up[i] >= th[i])
            pad = kw["padding_ratio"] * h
            want_box = [max(np.trunc(ys.min() - pad), 0), min(np.trunc(ys.max() + pad), h),
                        max(np.trunc(xs.min() - pad), 0), min(np.trunc(xs.max() + pad), h)]
            assert boxes[i].tolist() == want_box, (i, boxes[i], want_box)


@pytest.mark.parametrize("preset", ["classic", "classic_no_color", None])
@pytest.mark.parametrize("batch_index", [0, 1])
def test_train_transform_matches_jax(preset, batch_index):
    u8 = np.random.RandomState(batch_index).randint(0, 256, (6, 73, 80, 3)).astype(np.uint8)
    key = trng.item_key(1, "augment", 0, batch_index)
    want = np.asarray(jaug.train_transform_batch(jnp.asarray(u8), jnp.asarray(key), preset, 64, 64))
    got = taug.train_transform_batch(torch.from_numpy(u8), key, preset, 64, 64)
    assert got.shape == (6, 3, 64, 64) and got.is_contiguous()
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-6


def test_val_transform_matches_jax_and_the_rest_raises():
    u8 = np.random.RandomState(7).randint(0, 256, (5, 256, 256, 3)).astype(np.uint8)
    want = np.asarray(jaug.val_transform_batch(jnp.asarray(u8), 224, 224))
    got = taug.val_transform_batch(torch.from_numpy(u8), 224, 224)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-6
    key = trng.item_key(1, "augment", 0, 0)
    for preset in ("Classic", "randaugment", "cutmix", "none"):  # cutmix wraps a preset; "none" maps to None upstream
        with pytest.raises(ValueError, match="unknown train transform preset"):
            taug.train_transform_batch(torch.from_numpy(u8), key, preset, 224, 224)


@pytest.mark.parametrize("shape", [(700, 1000, 256, 256), (512, 512, 256, 256), (100, 90, 256, 256),
                                   (257, 255, 256, 256), (31, 77, 40, 20), (13, 17, 256, 256), (300, 200, 256, 299)])
def test_host_resize_is_bit_equal_to_the_native_build(shape):
    h, w, dh, dw = shape
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    assert native_available()  # else the JAX package would resize with PIL, which gives other pixels
    assert np.array_equal(t_resize(img, dh, dw), j_resize(img, dh, dw))
