"""The port's train step with CutMix's soft labels against the JAX
package's, on the CPU, in f64.

As tests/test_torch_train_step.py (ResNet-50, 64^2, batch 8, M 4, 8
classes, lr 1e-6, the same injected draws and the same flax state on both
sides), with y_soft: each sample's label mixed with another's at a seeded
weight, as CutMix's two mixes leave them.  Every cross-entropy term takes
the soft labels (the aug and aux views repeat them as they repeat y), the
metrics stay on the hard y.  With and without --dont_use_wsdan, over 3
steps: the loss within 1e-10 (relative), top-k counts equal, batch_stats
within 1e-9 of each tensor's largest entry, the params within 1e-6 and the
momentum within 1e-5, the bounds of the hard-label test; feature centers
within 1e-8 (measured 3.5e-9: they follow the features of params that
agree to 1e-6).

The CLIP teacher's blend (--use_target_soft_cross_entropy) the same way:
seeded (B, classes) teacher logits a step, hard labels, WSDAN on, 0.5 CE +
0.5 soft-target CE at T = 2 over the three views, within the same bounds;
with --dont_use_wsdan the port's step ignores the logits, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.fgvc.train import make_train_step as j_make_step
from saspa_tpu_torch.fgvc import train as ttrain
from tests.test_torch_train_step import (B, BATCHES, NUM_CLASSES, STEPS, _batch, _configs, _draws, _flax_sd,
                                         _port_draws, _rel, _Run)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _soft(seed, y):
    """Each label mixed with a permuted one at a seeded weight."""
    rng = np.random.RandomState(2000 + seed)
    lam = rng.uniform(0.2, 1.0, B)
    eye = np.eye(NUM_CLASSES)
    return lam[:, None] * eye[y] + (1 - lam)[:, None] * eye[y[rng.permutation(B)]]


@pytest.fixture(scope="module")
def run():
    return _Run(f64=True)


@pytest.mark.parametrize("dont_use_wsdan", [False, True])
def test_soft_label_step_matches_jax_over_three_steps(run, dont_use_wsdan):
    jc, tc = _configs()
    jc, tc = jc.replace(dont_use_wsdan=dont_use_wsdan), tc.replace(dont_use_wsdan=dont_use_wsdan)
    j_step = j_make_step(run.model, jc, 10)
    data = [_batch(s, BATCHES["duplicate_labels"]) for s in range(STEPS)]
    draws = [_draws(s) for s in range(STEPS)]
    softs = [_soft(s, y) for s, (_, y) in enumerate(data)]
    want = []
    with jax.enable_x64(True):
        state = run.state0
        for s, ((X, y), d, ys) in enumerate(zip(data, draws, softs)):
            dj = {k: jnp.asarray(v) for k, v in d.items()}
            state, m = j_step(state, jnp.asarray(X.astype(np.float64)), jnp.asarray(y), jax.random.PRNGKey(s),
                              y_soft=jnp.asarray(ys), draws=dj)
            want.append((jax.device_get(state), jax.device_get(m)))
    port = run.port_state()
    step = ttrain.make_train_step(tc, 10)
    for s, ((X, y), d, ys) in enumerate(zip(data, draws, softs)):
        m = step(port, torch.from_numpy(X).permute(0, 3, 1, 2).double(), torch.from_numpy(y),
                 np.asarray(jax.random.PRNGKey(s), np.uint32), y_soft=torch.from_numpy(ys),
                 draws=_port_draws(d, torch.float64))
        js, jm = want[s]
        assert _rel(m["loss"].item(), jm["loss"]) <= 1e-10, (s, m["loss"].item(), jm["loss"])
        assert all(m[k].tolist() == np.asarray(jm[k]).tolist() for k in ("raw_correct", "aug_correct", "aux_correct"))
        assert _rel(port.feature_center, js.feature_center) <= 1e-8
        sd = port.model.state_dict()
        for name, want_sd, got_sd, bound in (("params", _flax_sd(js.params), sd, 1e-6),
                                             ("batch_stats", _flax_sd(js.batch_stats), sd, 1e-9),
                                             ("momentum", _flax_sd(js.opt_state[1].trace), port.momentum, 1e-5)):
            err = max(_rel(got_sd[k], v) for k, v in want_sd.items())
            assert err <= bound, (s, name, err)


def _teacher(seed):
    return np.random.RandomState(3000 + seed).randn(B, NUM_CLASSES) * 3.0


def test_teacher_step_matches_jax_over_three_steps(run):
    """3 steps of the soft-target blend against JAX's from one state."""
    jc, tc = _configs()
    jc, tc = jc.replace(use_target_soft_cross_entropy=True), tc.replace(use_target_soft_cross_entropy=True)
    j_step = j_make_step(run.model, jc, 10)
    data = [_batch(s, BATCHES["duplicate_labels"]) for s in range(STEPS)]
    draws = [_draws(s) for s in range(STEPS)]
    teachers = [_teacher(s) for s in range(STEPS)]
    want = []
    with jax.enable_x64(True):
        state = run.state0
        for s, ((X, y), d, t) in enumerate(zip(data, draws, teachers)):
            dj = {k: jnp.asarray(v) for k, v in d.items()}
            state, m = j_step(state, jnp.asarray(X.astype(np.float64)), jnp.asarray(y), jax.random.PRNGKey(s),
                              clip_logits=jnp.asarray(t), draws=dj)
            want.append((jax.device_get(state), jax.device_get(m)))
    port = run.port_state()
    step = ttrain.make_train_step(tc, 10)
    plain = ttrain.make_train_step(tc.replace(use_target_soft_cross_entropy=False), 10)
    for s, ((X, y), d, t) in enumerate(zip(data, draws, teachers)):
        args = (torch.from_numpy(X).permute(0, 3, 1, 2).double(), torch.from_numpy(y),
                np.asarray(jax.random.PRNGKey(s), np.uint32))
        if s == 0:  # the blend moves the loss: the flag off ignores the teacher's logits
            other = run.port_state()
            m0 = plain(other, *args, draws=_port_draws(d, torch.float64), clip_logits=torch.from_numpy(t))
        m = step(port, *args, draws=_port_draws(d, torch.float64), clip_logits=torch.from_numpy(t))
        if s == 0:
            assert abs(m0["loss"].item() - m["loss"].item()) > 1e-3 * abs(m["loss"].item())
        js, jm = want[s]
        assert _rel(m["loss"].item(), jm["loss"]) <= 1e-10, (s, m["loss"].item(), jm["loss"])
        assert all(m[k].tolist() == np.asarray(jm[k]).tolist() for k in ("raw_correct", "aug_correct", "aux_correct"))
        assert _rel(port.feature_center, js.feature_center) <= 1e-8
        sd = port.model.state_dict()
        for name, want_sd, got_sd, bound in (("params", _flax_sd(js.params), sd, 1e-6),
                                             ("batch_stats", _flax_sd(js.batch_stats), sd, 1e-9),
                                             ("momentum", _flax_sd(js.opt_state[1].trace), port.momentum, 1e-5)):
            err = max(_rel(got_sd[k], v) for k, v in want_sd.items())
            assert err <= bound, (s, name, err)


def test_dont_use_wsdan_ignores_the_teacher(run):
    """Without WSDAN the step with the teacher's logits equals the step
    without them, bit for bit: loss, parameters, feature centers."""
    _, tc = _configs()
    tc = tc.replace(use_target_soft_cross_entropy=True, dont_use_wsdan=True)
    (X, y), d = _batch(0, BATCHES["duplicate_labels"]), _draws(0)
    states, losses = [], []
    for t in (torch.from_numpy(_teacher(0)), None):
        state = run.port_state()
        m = ttrain.make_train_step(tc, 10)(state, torch.from_numpy(X).permute(0, 3, 1, 2).double(),
                                           torch.from_numpy(y), np.asarray(jax.random.PRNGKey(0), np.uint32),
                                           draws=_port_draws(d, torch.float64), clip_logits=t)
        states.append(state)
        losses.append(m["loss"].item())
    assert losses[0] == losses[1]
    assert torch.equal(states[0].feature_center, states[1].feature_center)
    sd0, sd1 = states[0].model.state_dict(), states[1].model.state_dict()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
