"""The port's RNG streams against the JAX package's (saspa_tpu/utils/rng.py),
in the mode the JAX package runs: jax_threefry_partitionable=True (set by
tests/conftest.py; the default of jax 0.9).

Keys, random bits and uniforms are bit-exact.  Normals: the port computes
XLA's float32 ErfInv, log1p and log (and their fused multiply-adds) in
numpy; on this CPU backend >= 99.99% of the draws are bit-equal to
jax.random.normal and every draw is within 2 float32 ulps (measured at
these keys: the rest differ where XLA orders an operation of its log
differently).  The hashlib streams are bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from saspa_tpu.utils import rng as J
from saspa_tpu_torch.utils import rng as T

KEYS = [(1, "noise", (0, 0)), (1, "noise", (3, 1)), (0, "noise", (12345, 7)), (42, "dropout", (2**31 + 3, 0)),
        (7, "prompt_choice", (5,)), (2**33 + 5, "noise", (1, 1))]


def test_partitionable_mode_is_the_one_in_use():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,stream,idx", KEYS)
def test_keys_bits_and_uniforms_are_bit_exact(seed, stream, idx):
    jk = J.item_key(seed, stream, *idx)
    tk = T.item_key(seed, stream, *idx)
    assert np.array_equal(np.asarray(jax.random.key_data(jk)), tk)
    shape = (64, 48, 4)
    assert np.array_equal(np.asarray(jax.random.bits(jk, shape, jnp.uint32)), T.random_bits(tk, shape))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for a, b in ((0.0, 1.0), (lo, 1.0)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, a, b))
        assert np.array_equal(want, T.uniform_f32(tk, shape, a, b))


@pytest.mark.parametrize("seed,stream,idx", KEYS)
def test_normals_within_two_ulps(seed, stream, idx):
    shape = (128, 128, 4)  # the latents of a 1024^2 image
    want = np.asarray(jax.random.normal(J.item_key(seed, stream, *idx), shape, jnp.float32))
    got = T.item_normal(seed, stream, *idx, shape=shape)
    assert got.dtype == np.float32 and got.shape == shape
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert np.mean(ulps == 0) >= 0.9999


def test_host_streams_are_bit_exact():
    assert T.STREAMS == J.STREAMS
    for seed in (0, 1, 99):
        for idx in ((0,), (3, 1), (5, 2, 1), ()):
            assert T.host_uniform(seed, "artistic", *idx) == J.host_uniform(seed, "artistic", *idx)
            for n in (1, 7, 100):
                assert T.host_choice(n, seed, "prompt_choice", *idx) == J.host_choice(n, seed, "prompt_choice", *idx)
