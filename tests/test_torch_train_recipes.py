"""The train stage's augmentation recipes (RandAugment, AutoAugment, CutMix)
against the JAX package's, on the CPU.

* utils/rng.py's exponential, loggamma, beta and permutation against
  jax.random over >= 1,000 keys.  Measured shares of bit-equal draws:
  exponential 0.9998, loggamma 0.9996, beta 0.9999 (an XLA log that orders
  an operation differently; the rest lie within 1 ulp, beta's within 3),
  permutation 1.0.
  XLA's exp (`_exp_f32`) is bit-equal on [-87, 88].
* The op table at every strength of its finite set (RandAugment's +-9/30,
  AutoAugment's +-bin/9 over the policy's bins), each op alone against the
  JAX op under jit and vmap: bit-equal but for the geometric ops (<= 4e-6:
  XLA contracts the sampling grid's products the other way round when the
  op stands alone; inside the transform the port's order is XLA's, below),
  contrast (<= 1.2e-7: XLA's f32 mean sums in another order) and sharpness
  (<= 1.2e-7: its 3x3 convolution sums the taps in another order).  The
  affine matrices equal the ones JAX builds, bit for bit.
* randaugment_batch, autoaugment_batch and train_transform_batch("randaug"
  | "autoaug") against JAX's jitted functions from the same key: within
  1e-6 of the normalized image (measured 9.5e-7: contrast and sharpness,
  above) with >= 80% of the values bit-equal (measured 0.84-1.0); the op
  draws equal JAX's.
* cutmix_batch against the JAX package's: images, boxes and soft labels
  bit-equal.
* InputPipeline.iter_train with CutMix against the JAX pipeline on a tiny
  tree: X within the transform's bound, y and y_soft equal.
* `cli train --special_aug classic-cutmix | randaug-cutmix | autoaug |
  cutmix` and `--use_cutmix` for one epoch at 64^2.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.data import datasets as jds
from saspa_tpu.data.pipeline import InputPipeline as JPipeline
from saspa_tpu.native import native_available
from saspa_tpu.ops import augment as jaug
from saspa_tpu_torch import cli
from saspa_tpu_torch.data import datasets as tds
from saspa_tpu_torch.data.pipeline import InputPipeline as TPipeline
from saspa_tpu_torch.ops import augment as taug
from saspa_tpu_torch.utils import rng as trng
from tests.test_torch_train_data import _files, _quiet, _small_planes, _train_args
from tests.test_torch_train_data import tree  # noqa: F401  (the module's tiny FGVC-Aircraft tree)

F = np.float32
PRE, OUT, B = 73, 64, 4  # the pipeline's pre-crop and crop sizes at 64^2, and its batch: one jit a preset


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- (i) the draws -------------------------------------------------------
def test_exp_is_xlas():
    x = np.random.RandomState(0).uniform(-87, 88, 100_000).astype(F)
    assert np.array_equal(trng._exp_f32(x), np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("draw, min_equal", [("exponential", 0.999), ("loggamma", 0.999), ("beta", 0.999)])
def test_gamma_draws_equal_jax_random(draw, min_equal):
    """4096 draws: loggamma and beta on split(key, 4096), one key a sample;
    beta(1, 1) as CutMix draws it.  Shares measured here 0.99976 / 1.0 /
    0.99976; the others within 1 ulp (beta: 3 ulps, an ulp of a log-gamma
    through exp and the ratio)."""
    key = trng.item_key(1, "cutmix", 0, 7)
    jk = jnp.asarray(key)
    shape = (4096,)
    got, want = {"exponential": (trng.exponential_f32(key, shape), jax.random.exponential(jk, shape)),
                 "loggamma": (trng.loggamma_f32(key, 1.0, shape), jax.random.loggamma(jk, 1.0, shape)),
                 "beta": (trng.beta_f32(key, 1.0, 1.0, shape), jax.random.beta(jk, 1.0, 1.0, shape))}[draw]
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == shape
    assert (got == want).mean() >= min_equal
    assert np.all(np.abs(got.view(np.int32) - want.view(np.int32)) <= (3 if draw == "beta" else 1))


def test_loggamma_boost_below_one():
    """alpha < 1 takes the boosted draw and its log-space exponential."""
    key = trng.item_key(1, "cutmix", 3, 1)
    got, want = trng.loggamma_f32(key, 0.3, (1024,)), np.asarray(jax.random.loggamma(jnp.asarray(key), 0.3, (1024,)))
    assert (got == want).mean() >= 0.999 and np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_permutation_equals_jax_random():
    """1,000 keys at CutMix's batch sizes: every permutation equal."""
    for i in range(1000):
        key = trng.item_key(1, "cutmix", i // 100, i % 100)
        n = (16, 8, 4, 1, 3)[i % 5]
        assert np.array_equal(trng.permutation(key, n), np.asarray(jax.random.permutation(jnp.asarray(key), n)))


# ---- (ii) the op table ---------------------------------------------------
def _strengths():
    s = {name: {F(0.3), F(-0.3)} for name in taug.RANDAUG_OPS}
    s["invert"] = set()
    for policy in taug.AA_POLICY:
        for name, _, b in policy:
            s[name] |= {F(b / 9.0), -F(b / 9.0)}
    return {k: np.array(sorted(v), F) for k, v in s.items()}


STRENGTHS = _strengths()
# max |port - JAX| of an op alone (module docstring); 0: bit-equal
OP_BOUND = {"shear_x": 4e-6, "shear_y": 4e-6, "rotate": 4e-6, "contrast": 1.2e-7, "sharpness": 1.2e-7}


def test_op_table_is_jaxs():
    assert taug.AUTOAUG_OPS == tuple(jaug._AA_OP_NAMES)
    assert taug.AA_POLICY == jaug._AA_POLICY
    assert len(jaug._randaug_ops(OUT)) == len(taug.RANDAUG_OPS)


@pytest.mark.parametrize("name", taug.AUTOAUG_OPS)
def test_op_matches_jax_at_every_strength(name):
    k = taug.AUTOAUG_OPS.index(name)
    s = STRENGTHS[name]
    u8 = np.random.RandomState(k).randint(0, 256, (len(s), 40, 40, 3)).astype(np.uint8)
    if name in ("autocontrast", "equalize"):  # a flat channel, and few levels
        u8[0, :, :, 2] = 77
        u8[-1] = u8[-1] // 64 * 64
    x = (u8.astype(F) * F(1 / 255)).astype(F)
    op = jaug._autoaug_apply_table(40)[k]
    want = np.asarray(jax.jit(jax.vmap(op))(x, s))
    got = taug.OPS[name](torch.from_numpy(x), s).numpy()
    assert np.abs(got - want).max() <= OP_BOUND.get(name, 0.0)


def test_affine_matrices_are_jaxs(monkeypatch):
    """The geometric ops' matrices as JAX builds them under jit (its
    sampler swapped for one that returns the matrix)."""
    monkeypatch.setattr(jaug, "_affine_sample", lambda img, mat, fill=0.0: mat)
    for size in (OUT, 224):
        table = jaug._randaug_ops(size)
        for k, name in enumerate(taug.RANDAUG_OPS[1:6], 1):
            s = STRENGTHS[name]
            want = np.asarray(jax.jit(jax.vmap(table[k]))(np.zeros((len(s), 2, 2, 3), F), s))
            assert np.array_equal(taug.affine_matrices(name, s, size), want), (name, size)


# ---- (iii) the policies and the presets ----------------------------------
def _u8(seed, hw=OUT):
    return np.random.RandomState(seed).randint(0, 256, (B * 4, hw, hw, 3)).astype(np.uint8)


def _close(got, want, bound=1e-6, min_equal=0.8):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d.max() <= bound and (d == 0).mean() >= min_equal, (d.max(), (d == 0).mean())


@pytest.mark.parametrize("policy", ["randaug", "autoaug"])
def test_policy_batches_match_jax(policy):
    x = (_u8(11).astype(F) * F(1 / 255)).astype(F)
    key = trng.item_key(1, "augment", 2, 5)
    jfn, tfn = {"randaug": (jaug.randaugment_batch, taug.randaugment_batch),
                "autoaug": (jaug.autoaugment_batch, taug.autoaugment_batch)}[policy]
    _close(tfn(torch.from_numpy(x), key).numpy(), jax.jit(jfn)(x, jnp.asarray(key)))


def test_policy_draws_match_jax():
    """RandAugment's op and sign, AutoAugment's policy, coins and signs,
    replayed with jax.random on JAX's key schedule."""
    key = trng.item_key(1, "augment", 0, 3)
    op_idx, strength = taug.randaugment_draws(key, 16)
    ap_idx, ap_strength, apply = taug.autoaugment_draws(key, 16)
    for i, k in enumerate(jax.random.split(jnp.asarray(key), 16)):
        kk = k
        for r in range(2):
            ki, ks, kk = jax.random.split(jax.random.fold_in(kk, r), 3)
            assert op_idx[r, i] == int(jax.random.randint(ki, (), 0, 14))
            assert strength[r, i] == (1.0 if jax.random.bernoulli(ks, 0.5) else -1.0) * F(0.3)
        kp, k1, k2, ks1, ks2 = jax.random.split(k, 5)
        policy = jaug._AA_POLICY[int(jax.random.randint(kp, (), 0, 25))]
        for j, (kc, kss) in enumerate(((k1, ks1), (k2, ks2))):
            assert ap_idx[j, i] == jaug._AA_OP_NAMES.index(policy[j][0])
            assert apply[j, i] == bool(jax.random.bernoulli(kc, jnp.float32(policy[j][1])))
            assert ap_strength[j, i] == (1.0 if jax.random.bernoulli(kss, 0.5) else -1.0) * F(policy[j][2] / 9.0)


@pytest.mark.parametrize("preset", ["randaug", "autoaug"])
@pytest.mark.parametrize("batch_index", [0, 1])
def test_train_transform_matches_jax(preset, batch_index):
    u8 = np.random.RandomState(batch_index).randint(0, 256, (B, PRE, PRE, 3)).astype(np.uint8)
    key = trng.item_key(1, "augment", 0, batch_index)
    want = jaug.train_transform_batch(jnp.asarray(u8), jnp.asarray(key), preset, OUT, OUT)
    got = taug.train_transform_batch(torch.from_numpy(u8), key, preset, OUT, OUT)
    assert got.shape == (B, 3, OUT, OUT) and got.is_contiguous()
    _close(got.permute(0, 2, 3, 1).numpy(), want)


# ---- (iv) CutMix ---------------------------------------------------------
@pytest.mark.parametrize("b, hw", [(16, 224), (8, 224), (4, 64), (1, 32)])
def test_cutmix_matches_jax(b, hw):
    """Images, boxes and soft labels bit-equal over 6 keys a shape.  The
    boxes: sample i of a batch of constant images i shows where each pixel
    came from, which must be the port's drawn boxes."""
    for i in range(6):
        rng = np.random.RandomState(100 * b + i)
        X = rng.randn(b, hw, hw, 3).astype(F)
        y = rng.randint(0, 10, b).astype(np.int32)
        key = trng.item_key(1, "cutmix", i, b)
        jX, jy, jsoft = jaug.cutmix_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(key), 10)
        tX, ty, tsoft = taug.cutmix_batch(torch.from_numpy(X).permute(0, 3, 1, 2), torch.from_numpy(y), key, 10)
        assert np.array_equal(tX.permute(0, 2, 3, 1).numpy(), np.asarray(jX))
        assert np.array_equal(ty.numpy(), np.asarray(jy))
        assert tsoft.dtype == torch.float32 and np.array_equal(tsoft.numpy(), np.asarray(jsoft))
        src = np.broadcast_to(np.arange(b, dtype=F)[:, None, None, None], (b, hw, hw, 1))
        owner = np.asarray(jaug.cutmix_batch(jnp.asarray(src), jnp.asarray(y), jnp.asarray(key), 10)[0])[..., 0]
        ints, lams = taug.cutmix_draws(key, b, hw, hw)
        want_owner = np.broadcast_to(np.arange(b)[:, None, None], (b, hw, hw)).copy()
        for do, perm, y1, y2, x1, x2 in ints:
            nxt = want_owner[perm]
            for s in np.nonzero(do)[0]:
                want_owner[s, y1[s]:y2[s], x1[s]:x2[s]] = nxt[s, y1[s]:y2[s], x1[s]:x2[s]]
        assert np.array_equal(owner, want_owner)
        assert np.all(lams[:, 0] + lams[:, 1] == 1)


# ---- (vi) the pipeline with CutMix ---------------------------------------
@pytest.mark.parametrize("preset", ["randaug", "classic"])
def test_input_pipeline_with_cutmix_equals_jax(tree, preset):  # noqa: F811
    assert native_available()  # the JAX pipeline's resize: its native build, as tests/test_torch_train_data.py
    kw = dict(batch_size=B, resize=(OUT, OUT), seed=1, num_threads=2, train_transform=preset, use_cutmix=True)
    jds_train = jds.FGVCDataset(_files(jds, tree, "train"), "train", seed=1, print_func=_quiet)
    tds_train = tds.FGVCDataset(_files(tds, tree, "train"), "train", seed=1, print_func=_quiet)
    for (jx, jy, jsoft), (tx, ty, tsoft) in zip(JPipeline(jds_train, **kw).iter_train(1),
                                                TPipeline(tds_train, device="cpu", **kw).iter_train(1)):
        assert ty.tolist() == np.asarray(jy).tolist() and tsoft.shape == (B, tds_train.num_classes)
        assert np.array_equal(tsoft.numpy(), np.asarray(jsoft))
        _close(tx.permute(0, 2, 3, 1).numpy(), jx, min_equal=0.8 if preset == "randaug" else 1.0)


# ---- (vii) cli train -----------------------------------------------------
@pytest.mark.parametrize("extra", [["--special_aug", "classic-cutmix"], ["--special_aug", "randaug-cutmix"],
                                   ["--special_aug", "autoaug"], ["--special_aug", "cutmix"], ["--use_cutmix"]])
def test_cli_train_recipes_run_one_epoch(tree, tmp_path, monkeypatch, extra):  # noqa: F811
    _small_planes(monkeypatch, tree)
    logs = cli.cmd_train(_train_args(tree, tmp_path, *extra), device="cpu")
    lines = [json.loads(ln) for ln in (Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["steps"] == 4 and np.isfinite(lines[0]["train_loss"])
    assert np.isfinite(next(ln for ln in lines if "test_loss" in ln)["test_loss"])
    assert Path(logs["ckpt_path"]).exists()
