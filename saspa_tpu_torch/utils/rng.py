"""Deterministic RNG streams (counterpart of saspa_tpu/utils/rng.py).

Every work item's randomness derives from (seed, stream, indices), so the
generation stage's results do not depend on batch composition, sharding or
resume point.  `host_uniform`/`host_choice` are hashlib only, as in the JAX
package.  The per-item keys and the initial noise reproduce `jax.random`
bit for bit without jax: `item_key` is `jax.random.fold_in` chained over a
threefry2x32 `PRNGKey`, and `item_normal` is `jax.random.normal`'s float32
draw, in the mode the JAX package runs (`jax_threefry_partitionable=True`,
the default of jax 0.9 and what tests/conftest.py sets):
  bits    = threefry2x32(key, (hi, lo) of a 64-bit iota) -> bits1 ^ bits2
  uniform = bitcast((bits >> 9) | 0x3f800000) - 1, mapped to
            [nextafter(-1, 0), 1)
  normal  = sqrt(2) * erfinv(uniform), with XLA's float32 ErfInv (Giles'
            polynomial on w = -log1p(-u^2)) and the Cephes log1p/log of
            XLA's CPU backend.
All arithmetic is numpy uint32 / float32, as XLA does it, with XLA's fused
multiply-adds.  Keys, bits and uniforms equal jax's bit for bit; a normal
can differ from jax on the CPU by an ulp where XLA orders an operation of
its log differently (tests/test_torch_rng.py states the measured bound).
The train path's draws `split`, `bernoulli` and `randint` equal
jax.random's bit for bit (tests/test_torch_train_augment.py); `gumbel`
and `categorical` go through `_log_f32`, which rounds ~0.04% of inputs one
ulp away from the XLA CPU log of jax 0.9, so a gumbel value g lies within
2^-22 * max(1, |g|) of jax's and equals it >= 99.8% of the time
(tests/test_torch_t5.py).  CutMix's `permutation` does too;
its `beta_f32` (two `loggamma_f32` draws, Marsaglia and Tsang's rejection
loop on jax's key schedule, then XLA's exp) and `exponential_f32` go
through XLA's log and log1p, and so are >= 99.9% bit-equal and otherwise
within 3 ulps (tests/test_torch_train_recipes.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

# Stable, documented stream ids; never renumber.
STREAMS = {
    "noise": 0,  # diffusion initial latents
    "prompt_choice": 1,  # which prompt from the prompt pool
    "artistic": 2,  # artistic/camera suffix coin flips + choice
    "dropout": 3,  # model-internal randomness
    "attention_pick": 4,  # WSDAN attention-map sampling
    "augment": 5,  # train-time image augmentation
    "cutmix": 6,
    "aug_swap": 7,  # AugWrapper original/aug swap coin
    "subject_choice": 8,  # BLIP-diffusion same-class subject image pick
    "alia_amnesty": 9,  # 20% amnesty coin in ALIA filtering
}

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under key = (k0, k1): uint32 arrays in, a pair of uint32 arrays out."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) without x64: (0, the seed's low 32 bits)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in: the hash of the counter pair (0, data)."""
    with np.errstate(over="ignore"):
        a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def item_key(seed: int, stream: str, *indices: int) -> np.ndarray:
    """Key for one work item, e.g. item_key(seed, 'noise', image_idx, prompt_idx)."""
    k = fold_in(prng_key(seed), STREAMS[stream])
    for idx in indices:
        k = fold_in(k, idx)
    return k


def random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape, uint32) in the partitionable mode."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, (iota >> np.uint64(32)).astype(np.uint32), iota.astype(np.uint32))
    return (b1 ^ b2).reshape(shape)


def uniform_f32(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval) as XLA's CPU
    code computes it: floats * (maxval - minval) + minval in one fused
    multiply-add."""
    return _uniform_of_bits(random_bits(key, tuple(shape)), minval, maxval)


def _uniform_of_bits(bits: np.ndarray, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c):
    """float32 a * b + c with one rounding, as XLA's CPU code contracts a
    multiply that feeds an add (the f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _horner(x, coeffs):
    r = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, np.float32(c))
    return r


# XLA's float32 log (the Cephes logf its CPU backend emits)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_f32(v):
    f = np.float32
    t = np.maximum(np.array(0x00800000, np.uint32).view(np.float32), v.astype(np.float32))
    e = f(1) + ((t.view(np.uint32) >> _U32(23)).astype(np.int32) - 0x7F).astype(np.float32)
    t = ((t.view(np.uint32) & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)  # mantissa in [0.5, 1)
    small = t < f(0.707106781186547524)
    e = e - np.where(small, f(1), f(0))
    t = (t - f(1)) + np.where(small, t, f(0))
    x2 = t * t
    x3 = x2 * t
    p = [f(c) for c in _LOG_P]
    y, y1, y2 = _fma(t, p[0], p[1]), _fma(t, p[3], p[4]), _fma(t, p[6], p[7])
    y, y1, y2 = _fma(y, t, p[2]), _fma(y1, t, p[5]), _fma(y2, t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(f(-2.12194440e-4), e, y)
    t = _fma(-f(0.5), x2, t) + y
    return _fma(f(0.693359375), e, t)


# XLA's float32 exp (the Cephes expf its CPU backend emits): n = floor(x *
# log2(e) + 1/2), x - n * ln(2) in two parts, a degree-5 polynomial, * 2^n
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp_f32(v):
    f = np.float32
    x = np.clip(np.asarray(v, f), f(-87.8), f(88.8))
    n = np.floor(_fma(x, f(1.44269504088896341), f(0.5)))
    x = _fma(-n, f(0.693359375), x)
    x = _fma(-n, f(-2.12194440e-4), x)
    y = _horner(x, _EXP_P)
    y = _fma(y, x * x, x) + f(1)
    return y * ((n.astype(np.int32) + 127) << 23).astype(np.int32).view(f)


# XLA's float32 log1p: a Cephes rational approximation below sqrt(2) - 1
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)


def _log1p_f32(x):
    f = np.float32
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(-f(0.5), x2, small)
    return np.where(np.abs(x) < f(0.41421356237309504880), small, _log_f32(f(1) + x))


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"):
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                        -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                        -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], np.float32)


def erfinv_f32(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    f = np.float32
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = -_log1p_f32(-x * x)
        lt = w < f(5.0)
        w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0))
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
        for i in range(1, len(_ERFINV_LT5)):
            p = _fma(p, w, np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]))
        return np.where(np.abs(x) == f(1.0), x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal_f32(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    return _normal_of_bits(random_bits(key, tuple(shape)))


def _normal_of_bits(bits: np.ndarray) -> np.ndarray:
    u = _uniform_of_bits(bits, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def item_normal(seed: int, stream: str, *indices: int, shape) -> np.ndarray:
    """jax.random.normal(item_key(seed, stream, *indices), shape, float32)."""
    return normal_f32(item_key(seed, stream, *indices), tuple(shape))


def host_uniform(seed: int, stream: str, *indices: int) -> float:
    """A cheap host-side uniform in [0,1) derived from the same mapping, for
    host-side control flow (file skipping, sampling ratios) that must not
    depend on traced values."""
    h = hashlib.sha256(
        f"{seed}:{STREAMS[stream]}:{':'.join(map(str, indices))}".encode()
    ).digest()
    return int.from_bytes(h[:8], "little") / 2**64


def host_choice(n: int, seed: int, stream: str, *indices: int) -> int:
    """Host-side integer choice in [0, n)."""
    return int(host_uniform(seed, stream, *indices) * n) % max(n, 1)


# ---- the draws of the train path: jax.random's functions on numpy keys ----
@dataclass(frozen=True)
class Rows:
    """Rows `index` of a batch of `total`.  A shard of a batch makes each
    draw for all `total` rows and keeps its own (`take`), so it draws what
    the whole batch draws."""

    index: np.ndarray
    total: int

    def take(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        return np.take(a, self.index, axis=axis)


def draw_size(rows: Optional[Rows], b: int) -> int:
    """The batch a draw is made for: the whole of which `rows` are part, else b."""
    return b if rows is None else rows.total


def take_rows(a: np.ndarray, rows: Optional[Rows], axis: int = 0) -> np.ndarray:
    return a if rows is None else rows.take(a, axis)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) in the partitionable mode: key i is the
    hash of the counter pair (0, i), so it equals fold_in(key, i)."""
    with np.errstate(over="ignore"):
        a, b = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([a, b], axis=1)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """jax.random.bernoulli(key, p, shape): uniform(key, shape) < p, in f32."""
    return uniform_f32(key, shape) < np.float32(p)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) as int32: 64 random
    bits a value from the two halves of split(key), reduced mod the span in
    uint32 arithmetic, as jax does."""
    k1, k2 = split(key, 2)
    return _randint_of_bits(random_bits(k1, tuple(shape)), random_bits(k2, tuple(shape)), minval, maxval)


def _randint_of_bits(higher: np.ndarray, lower: np.ndarray, minval: int, maxval: int) -> np.ndarray:
    span = _U32(max(int(maxval) - int(minval), 1))
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


def gumbel(key, shape) -> np.ndarray:
    """jax.random.gumbel(key, shape, float32) in its default ("low") mode:
    -log(-log(U)) with U uniform on [tiny, 1), through XLA's float32 log."""
    u = uniform_f32(key, shape, np.finfo(np.float32).tiny, 1.0)
    return -_log_f32(-_log_f32(u))


_GUMBEL_TABLE = None


def gumbel_table() -> np.ndarray:
    """gumbel's value of each uniform it can draw, f32 (2^23 entries, 32 MB,
    built once a process in a few seconds): its U = max(tiny, floats +
    tiny) depends on the top 23 bits of a random word only."""
    global _GUMBEL_TABLE
    if _GUMBEL_TABLE is None:
        bits = np.arange(1 << 23, dtype=np.uint32) << _U32(9)
        _GUMBEL_TABLE = -_log_f32(-_log_f32(_uniform_of_bits(bits, np.finfo(np.float32).tiny, 1.0)))
    return _GUMBEL_TABLE


def gumbel_by_table(key, shape) -> np.ndarray:
    """gumbel(key, shape) bit for bit, looked up in gumbel_table: about 3x
    faster a draw, for draws of millions of values."""
    return gumbel_table()[random_bits(key, tuple(shape)) >> _U32(9)]


def categorical_gumbel(key, num_categories: int, shape) -> np.ndarray:
    """The noise of jax.random.categorical(key, logits, shape=shape) over
    logits of `num_categories` entries: the pick is argmax(noise + logits)
    over the last axis, so the host draws the noise and the logits may
    stay on the card."""
    return gumbel(key, (*tuple(shape), num_categories))


def categorical(key, logits: np.ndarray, shape) -> np.ndarray:
    """jax.random.categorical(key, logits, shape=shape) on one row of
    float32 logits."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(categorical_gumbel(key, logits.shape[-1], shape) + logits, axis=-1)


# ---- scalar draws of many keys at once: a per-sample key schedule vectorized ----
def _hash_each(keys: np.ndarray, counter):
    """The hash of the counter pair (0, counter) under each key of keys (n, 2)."""
    n = keys.shape[0]
    with np.errstate(over="ignore"):
        return threefry2x32((keys[:, 0], keys[:, 1]), np.zeros(n, np.uint32),
                            np.broadcast_to(np.asarray(counter, np.uint32), (n,)))


def split_each(keys: np.ndarray, num: int) -> np.ndarray:
    """split(k, num) of each key of keys (n, 2) -> (num, n, 2)."""
    n = keys.shape[0]
    a, b = _hash_each(np.tile(keys, (num, 1)), np.repeat(np.arange(num, dtype=np.uint32), n))
    return np.stack([a, b], axis=1).reshape(num, n, 2)


def fold_in_each(keys: np.ndarray, data: int) -> np.ndarray:
    """fold_in(k, data) of each key of keys (n, 2) -> (n, 2)."""
    return np.stack(_hash_each(keys, data & 0xFFFFFFFF), axis=1)


def bits_each(keys: np.ndarray) -> np.ndarray:
    """random_bits(k, ()) of each key of keys (n, 2) -> uint32 (n,)."""
    b1, b2 = _hash_each(keys, 0)
    return b1 ^ b2


def uniform_each(keys: np.ndarray) -> np.ndarray:
    """uniform(k, (), float32) of each key; bernoulli(k, p) is uniform < p."""
    return _uniform_of_bits(bits_each(keys))


def randint_each(keys: np.ndarray, minval: int, maxval: int) -> np.ndarray:
    """randint(k, (), minval, maxval) of each key -> int32 (n,)."""
    k1, k2 = split_each(keys, 2)
    return _randint_of_bits(bits_each(k1), bits_each(k2), minval, maxval)


# ---- CutMix's draws: jax.random's exponential, loggamma, beta, permutation ----


def exponential_f32(key, shape) -> np.ndarray:
    """jax.random.exponential(key, shape, float32): -log1p(-U)."""
    return -_log1p_f32(-uniform_f32(key, shape))


def gamma_one(keys: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """jax's _gamma_one(key, alpha, log_space=True) for each key of keys
    (n, 2) and alpha (n,) f32: Marsaglia and Tsang's rejection loop, its
    draws on jax's key schedule (key, subkey = split(key); each round splits
    key into (key, x_key, U_key) and draws normals off x_key until v > 0),
    with XLA's float32 log and its fused multiply-adds.  Returns log-gamma
    samples (n,) f32."""
    f = np.float32
    alpha = np.asarray(alpha, f)
    n = alpha.shape[0]
    boost = alpha >= f(1)
    a = np.where(boost, alpha, alpha + f(1))
    d = a - f(1.0 / 3.0)
    c = f(1.0 / 3.0) / np.sqrt(d)
    key, subkey = split_each(np.asarray(keys, np.uint32), 2)
    V = np.ones(n, f)
    active = np.ones(n, bool)  # the loop's initial state (X 0, V 1, U 2) always enters the body
    while active.any():
        idx = np.nonzero(active)[0]
        key[idx], x_key, u_key = split_each(key[idx], 3)
        x, v = np.zeros(len(idx), f), np.full(len(idx), f(-1))
        redraw = np.ones(len(idx), bool)
        while redraw.any():
            j = np.nonzero(redraw)[0]
            x_key[j], sub = split_each(x_key[j], 2)
            x[j] = _normal_of_bits(bits_each(sub))
            v[j] = _fma(x[j], c[idx][j], f(1))
            redraw[j] = v[j] <= f(0)
        X = x * x
        V[idx] = (v * v) * v
        U = _uniform_of_bits(bits_each(u_key))
        with np.errstate(divide="ignore", invalid="ignore"):
            reject = (U >= _fma(-f(0.0331), X * X, f(1))) & (
                _log_f32(U) >= _fma(d[idx], (f(1) - V[idx]) + _log_f32(V[idx]), X * f(0.5)))
        active[idx] = reject
    log_samples = _log1p_f32(-_uniform_of_bits(bits_each(subkey)))  # -exponential(subkey)
    log_boost = np.where(boost | (log_samples == 0), f(0), log_samples * (f(1) / alpha))
    return (_log_f32(d) + _log_f32(V)) + log_boost


def loggamma_f32(key, a: float, shape) -> np.ndarray:
    """jax.random.loggamma(key, a, shape, float32): one gamma_one a sample,
    on split(key, n)."""
    n = int(np.prod(shape, dtype=np.int64))
    return gamma_one(split(key, n), np.full(n, np.float32(a))).reshape(shape)


def beta_f32(key, a: float, b: float, shape) -> np.ndarray:
    """jax.random.beta(key, a, b, shape, float32): two log-gamma draws off
    split(key), then exp(la - max) / (exp(la - max) + exp(lb - max)), one
    XLA op at a time as jax runs it."""
    n = int(np.prod(shape, dtype=np.int64))
    key_a, key_b = split(key, 2)
    alpha = np.concatenate([np.full(n, np.float32(a)), np.full(n, np.float32(b))])
    la, lb = gamma_one(np.concatenate([split(key_a, n), split(key_b, n)]), alpha).reshape(2, *shape)  # both at once
    m = np.maximum(la, lb)
    ga, gb = _exp_f32(la - m), _exp_f32(lb - m)
    return ga / (ga + gb)


def permutation(key, n: int) -> np.ndarray:
    """jax.random.permutation(key, n): _shuffle's ceil(3 ln n / ln(2^32 - 1))
    rounds (one for n < 2^21), each a stable sort of arange's order by fresh
    random_bits of split(key)'s second key."""
    x = np.arange(n)
    for _ in range(int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))):
        key, sub = split(key, 2)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x
