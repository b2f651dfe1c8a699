"""The port's train step against the JAX package's in f32, on the CPU: the
f32 case of test_torch_train_step.py (its docstring gives the set-up), on
the batch with repeated labels and on one with random labels.

In f32 the two agree only as far as the seeded ResNet-50 lets rounding
differences grow: XLA and torch convolve and reduce in different orders,
and the train-mode BatchNorms (flax's fast variance E[x^2] - E[x]^2) turn
that into ~3e-5 after the first block and ~7e-4 at layer4.  Measured over
the 3 steps: loss within 3e-3 to 2.3e-2 relative, params within 1.3e-4 of
the largest, feature centers and running statistics at cosine >= 0.9956.
The bounds below are those with a margin.  The gradients (the momentum)
are not held here: theirs is the exploding backward of a randomly
initialised deep BatchNorm net, at cosine 0.3-0.75 between the packages in
f32 while f64 holds them to 4e-7 (test_torch_train_step.py).
"""

import pytest

from test_torch_train_step import BATCHES, _Run, _two_torch_threads, check_three_steps  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return _Run(f64=False)


@pytest.mark.parametrize("batches", sorted(BATCHES))
def test_train_step_matches_jax_over_three_steps_f32(run, batches):
    for row in check_three_steps(run, batches):
        assert row["loss"] <= 5e-2, row
        assert row["params"] <= 5e-4, row
        assert row["feature_center_cos"] >= 0.99 and row["batch_stats_cos"] >= 0.999, row
