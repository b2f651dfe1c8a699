"""The port's WS-DAN/CAL train step against the JAX package's, on the CPU.

Both packages start from the same flax TrainState (carried across by the
bridge: params, batch_stats, optax's momentum, feature centers) and take 3
steps on the same numpy batches with the same injected draws (fake
attention, map picks, crop and drop thetas), at tests/test_train_step.py's
size: ResNet-50, 64^2, batch 8, M 4, 8 classes.  The batch repeats its
labels (class 3 four times), which pins the feature-center scatter:
duplicates accumulate every delta, as the JAX package's `.at[y].add`; a
last-write scatter misses the bounds below by orders of magnitude.

This file runs in f64 (jax's x64 mode, the port's modules in f64), where
the two compute the same function: over 3 steps the top-k counts are equal,
and loss, batch_stats and feature centers agree to 1e-9 of each tensor's
largest entry, the params to 1e-6 and the momentum to 1e-5 (measured:
1.8e-7 on a BatchNorm bias, which starts at 0, and 4e-7: the gradient of
the seeded ResNet-50 amplifies rounding most).
test_torch_train_step_f32.py runs f32 (one jitted JAX step a file).

The steps run at lr 1e-6, not the preset's 1e-3: at 1e-3 this seeded net's
trajectory is chaotic, so that JAX against itself with its params perturbed
by 1e-12 already differs by 4% in loss at step 3; the arithmetic of the
step is the same at any lr.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.fgvc.train import create_train_state as j_create_state
from saspa_tpu.fgvc.train import make_train_step as j_make_step
from saspa_tpu.models.cal import WSDAN_CAL as JCAL
from saspa_tpu.utils.config import get_train_config as j_train_config
from saspa_tpu_torch.bridge import _flatten, load_train_state, train_state_from_flax
from saspa_tpu_torch.fgvc import train as ttrain
from saspa_tpu_torch.models.cal import WSDAN_CAL as TCAL
from saspa_tpu_torch.utils.config import get_train_config as t_train_config

NUM_CLASSES, IMG, M, B = 8, 64, 4, 8
STEPS = 3
LR = 1e-6  # at the preset's 1e-3 the seeded net's trajectory is chaotic (module docstring)
BATCHES = {"random_labels": None, "duplicate_labels": np.array([3, 3, 3, 1, 1, 6, 0, 3], np.int32)}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _batch(seed, labels=None):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, NUM_CLASSES, size=B).astype(np.int32) if labels is None else labels
    X = rng.rand(B, IMG, IMG, 3).astype(np.float32) * 0.1  # class-dependent signal, as test_train_step.py
    for i, lbl in enumerate(y):
        X[i, :, :, lbl % 3] += (lbl + 1) / NUM_CLASSES
    return X, y


def _draws(seed):
    rng = np.random.RandomState(1000 + seed)
    h = IMG // 16
    return {"fake1": rng.uniform(0, 2, (B, h, h, M)), "pick1": rng.randint(0, M, (B, 2)).astype(np.int32),
            "fake2": rng.uniform(0, 2, (2 * B, h, h, M)), "pick2": rng.randint(0, M, (2 * B, 2)).astype(np.int32),
            "crop_theta": rng.uniform(0.4, 0.6, B), "drop_theta": rng.uniform(0.2, 0.5, B)}


def _port_draws(d, dtype):
    out = {}
    for k, v in d.items():
        t = torch.from_numpy(v)
        out[k] = t.permute(0, 3, 1, 2).to(dtype) if k.startswith("fake") else (t.to(dtype) if t.is_floating_point()
                                                                               else t)
    return out


def _configs():
    kw = dict(image_size=(IMG, IMG), net="resnet50", batch_size=B, num_attentions=M, compute_dtype="float32",
              learning_rate=LR)
    jc = j_train_config("planes").replace(donate_state=False, **kw)
    tc = t_train_config("planes").replace(**kw)
    return jc, tc


def jit_create_state(model, jc, num_classes, seed, img):
    """The JAX package's create_train_state under one jit: the same state,
    without the eager init's op-by-op dispatch of ResNet-50 (~15 s)."""
    return jax.jit(lambda k: j_create_state(model, jc, num_classes, 10, k,
                                            sample_input=np.zeros((1, img, img, 3), np.float32)))(
        jax.random.PRNGKey(seed))


class _Run:
    """One JAX jitted step and its initial state, for one dtype."""

    def __init__(self, f64: bool):
        self.f64 = f64
        jc, self.tc = _configs()
        with jax.enable_x64(f64):
            dt = jnp.float64 if f64 else jnp.float32
            self.model = JCAL(num_classes=NUM_CLASSES, M=M, net="resnet50", dtype=dt)
            state = jit_create_state(self.model, jc, NUM_CLASSES, 0, IMG)
            if f64:
                state = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt) if jnp.issubdtype(a.dtype, jnp.floating)
                                               else a, state)
            self.state0 = state
            self.step = j_make_step(self.model, jc, 10)

    def jax_steps(self, batches, draws):
        out = []
        with jax.enable_x64(self.f64):
            dt = np.float64 if self.f64 else np.float32
            state = self.state0
            for s, ((X, y), d) in enumerate(zip(batches, draws)):
                dj = {k: jnp.asarray(v.astype(dt) if v.dtype.kind == "f" else v) for k, v in d.items()}
                state, m = self.step(state, jnp.asarray(X.astype(dt)), jnp.asarray(y),
                                     jax.random.PRNGKey(s), draws=dj)
                out.append((jax.device_get(state), jax.device_get(m)))
        return out

    def port_state(self):
        dtype = torch.float64 if self.f64 else torch.float32
        model = TCAL(num_classes=NUM_CLASSES, M=M, net="resnet50", dtype=dtype, device="cpu", param_dtype=dtype)
        model = model.to(dtype)
        for p in model.parameters():
            p.requires_grad_(True)
        state = ttrain.TrainState(model=model, momentum={n: torch.zeros_like(p) for n, p in model.named_parameters()},
                                  feature_center=torch.zeros(NUM_CLASSES, M * 2048, dtype=dtype))
        s0 = jax.device_get(self.state0)
        load_train_state(state, train_state_from_flax(s0.params, s0.batch_stats, s0.opt_state, s0.feature_center,
                                                      s0.step))
        return state


@pytest.fixture(scope="module")
def run():
    return _Run(f64=True)


def _flax_sd(tree):
    """A flax tree as the port's state_dict keys and layouts, at its own precision."""
    out = {}
    for path, leaf in _flatten(jax.device_get(tree)).items():
        a = np.asarray(leaf)
        if path.endswith("kernel"):
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[path.replace("/", ".")] = a
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cos(got, want):
    a, b = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel() for t in tensors])


def check_three_steps(run, batches):
    """Three steps of both packages from one state; returns the per-step
    measures: loss error, top-k counts equal, and the error of params,
    batch_stats, momentum and feature centers (max |diff| / max |JAX|, a
    tensor at a time for f64, over all tensors at once for f32) and their
    cosines."""
    f64 = run.f64
    data = [_batch(s, BATCHES[batches]) for s in range(STEPS)]
    draws = [_draws(s) for s in range(STEPS)]
    want = run.jax_steps(data, draws)
    dtype = torch.float64 if f64 else torch.float32
    state = run.port_state()
    step = ttrain.make_train_step(run.tc, 10)
    out = []
    for s, ((X, y), d) in enumerate(zip(data, draws)):
        m = step(state, torch.from_numpy(X).permute(0, 3, 1, 2).to(dtype), torch.from_numpy(y),
                 np.asarray(jax.random.PRNGKey(s), np.uint32), draws=_port_draws(d, dtype))
        js, jm = want[s]
        assert state.step == int(js.step) == s + 1
        port_sd = state.model.state_dict()
        params, stats, moms = _flax_sd(js.params), _flax_sd(js.batch_stats), _flax_sd(js.opt_state[1].trace)
        row = {"loss": _rel(m["loss"].item(), jm["loss"]),
               "counts_equal": all(m[k].tolist() == np.asarray(jm[k]).tolist()
                                   for k in ("raw_correct", "aug_correct", "aux_correct")),
               "feature_center": _rel(state.feature_center, js.feature_center),
               "feature_center_cos": _cos(state.feature_center, js.feature_center)}
        for name, want_sd, got_sd in (("params", params, port_sd), ("batch_stats", stats, port_sd),
                                      ("momentum", moms, state.momentum)):
            got_flat, want_flat = _flat(got_sd[k] for k in want_sd), _flat(want_sd.values())
            if f64:
                row[name] = max(_rel(got_sd[k], v) for k, v in want_sd.items())
            else:
                row[name] = _rel(got_flat, want_flat)
            row[name + "_cos"] = _cos(got_flat, want_flat)
        out.append(row)
    return out


def test_train_step_matches_jax_over_three_steps(run):
    for row in check_three_steps(run, "duplicate_labels"):
        assert row["counts_equal"], row
        for k in ("loss", "batch_stats", "feature_center"):
            assert row[k] <= 1e-9, (k, row)
        assert row["params"] <= 1e-6 and row["momentum"] <= 1e-5, row
