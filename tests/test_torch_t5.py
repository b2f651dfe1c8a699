"""Parity of the port's keytotext T5 with the JAX package, on the CPU.

A tiny T5 (d_model 16, d_kv 8, FFN 32, 2 + 2 layers, 2 heads, t5's
vocabulary of 32128 and its 32 buckets up to distance 128), f32, one
seeded flax-layout tree handed to both packages.  Tolerances: the bucket
of every relative position in [-1024, 1024] equal, both directions; the
encoder states and the logits within 1e-5 of the largest output, with a
padded batch (the encoder's mask and the decoder's cross mask); greedy ids
and top-k 50 sampled ids equal to JAX's for two seeds and two calls each
(the wrapper's key advances a call); the sampling noise within 2^-22 of
max(1, |g|) of jax.random.gumbel's g and equal on >= 99.8% of values
(XLA's f32 log rounds ~0.04% of inputs the other way from utils/rng.py's
emulation of it), the
table lookup equal to the direct draw bit for bit; the fallback
tokenizer's ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import t5 as J
from saspa_tpu_torch.models import t5 as T
from tests.test_torch_blip_caption import _close, _two_torch_threads, jax_apply, seeded_tree  # noqa: F401

CFG = dict(d_model=16, d_kv=8, d_ff=32, layers=2, heads=2)
MAX_NEW = 8
TEXTS = ["airplane", "airplane, of type 707-320 on a runway", "jet"]


@pytest.fixture(scope="module")
def tree():
    return seeded_tree(T.T5ForGeneration(T.T5Config(**CFG)), 27)


def models(tree, seed: int, sample: bool):
    port = T.TorchKeytotextT5(cfg=T.T5Config(**CFG), params=tree, seed=seed, max_new_tokens=MAX_NEW, sample=sample,
                              device="cpu")
    jax_t5 = J.FlaxKeytotextT5(cfg=J.T5Config(**CFG), params=jax.tree_util.tree_map(jnp.asarray, tree), seed=seed,
                               max_new_tokens=MAX_NEW, sample=sample)
    return port, jax_t5


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_match_jax(bidirectional):
    rel = np.arange(-1024, 1025)
    want = np.asarray(J.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128))
    np.testing.assert_array_equal(T.relative_position_bucket(rel, bidirectional, 32, 128), want)
    grid = np.arange(40)[None, :] - np.arange(33)[:, None]
    np.testing.assert_array_equal(T.relative_position_bucket(grid, bidirectional),
                                  np.asarray(J.relative_position_bucket(jnp.asarray(grid), bidirectional)))


def test_sampling_noise_is_jax_gumbel_through_the_table():
    from saspa_tpu_torch.utils import rng

    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(11)))
    small = T.sampling_noise(key, 2, 3, 32128)  # under TABLE_DRAWS: rng.gumbel
    big = T.sampling_noise(key, 11, 3, 32128)  # the table
    for noise, b in ((small, 2), (big, 11)):
        for i, k in enumerate(jax.random.split(jax.random.PRNGKey(11), 3)):
            want = np.asarray(jax.random.gumbel(k, (b, 32128)))
            # XLA's f32 log rounds ~0.04% of inputs the other way from utils/rng.py's emulation
            err = np.abs(noise[i] - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= 2.0 ** -22 and np.mean(noise[i] == want) >= 0.998, (err.max(), np.mean(err == 0))
    np.testing.assert_array_equal(big[:, :2], T.sampling_noise(key, 2, 3, 32128))
    np.testing.assert_array_equal(rng.gumbel_by_table(key, (5, 999)), rng.gumbel(key, (5, 999)))


def test_fallback_tokenizer_matches_jax(tmp_path):
    port, jax_tok = T.T5Tokenizer(None), J.T5Tokenizer(None)
    assert not port.has_vocab
    for text in TEXTS + ["Texture, of type banded", ""]:
        assert port.encode(text) == jax_tok.encode(text)
    assert port.decode([0, 5, 77, 1, 0]) == jax_tok.decode([0, 5, 77, 1, 0])


def test_encoder_and_logits_match_flax_with_masks(tree):
    port, jax_t5 = models(tree, 0, False)
    ids, mask = port.encode_batch(TEXTS)
    assert int(mask.sum()) < mask.numel()  # the batch is padded
    dec = np.random.RandomState(3).randint(0, 32128, (3, 5))
    j_enc = jax_apply(jax_t5.model, jax_t5.params, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
                      method=J.T5ForGeneration.encode)
    j_logits = jax_apply(jax_t5.model, jax_t5.params, jnp.asarray(ids.numpy()), jnp.asarray(dec),
                         jnp.asarray(mask.numpy()))
    with torch.no_grad():
        t_enc = port.model.encode(ids, mask)
        t_logits = port.model(ids, torch.from_numpy(dec), mask)
    _close(t_enc, j_enc, 1e-5)
    _close(t_logits, j_logits, 1e-5)


def test_greedy_ids_match_jax(tree):
    port, jax_t5 = models(tree, 0, False)
    ids, mask = port.encode_batch(TEXTS)
    want = J.t5_generate_ids(jax_t5._apply_fn, jax_t5.params, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
                             MAX_NEW)
    got = T.t5_generate_ids(port.model, ids, mask, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.generate_batch(TEXTS) == jax_t5.generate_batch(TEXTS)


@pytest.mark.parametrize("seed", [0, 5])
def test_sampled_ids_match_jax_over_two_calls(tree, seed):
    port, jax_t5 = models(tree, seed, True)
    ids, mask = port.encode_batch(TEXTS)
    for _ in range(2):  # each call draws from the next key
        key = port.next_key()
        jax_t5._key, jkey = jax.random.split(jax_t5._key)
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
        want = J.t5_generate_ids(jax_t5._apply_fn, jax_t5.params, jnp.asarray(ids.numpy()),
                                 jnp.asarray(mask.numpy()), MAX_NEW, key=jkey)
        got = T.t5_generate_ids(port.model, ids, mask, MAX_NEW, key=key)
        np.testing.assert_array_equal(got.numpy(), want)
    assert port("airplane") == jax_t5("airplane")  # the third call through the wrappers
