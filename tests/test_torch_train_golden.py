"""The port's train step replays tests/fixtures/golden_train.npz, on the CPU.

The fixture (tests/test_golden_train.py) pins 3 f32 steps of the JAX
WSDAN-CAL train step from PRNGKey(1234)'s init (ResNet-50, 64^2, batch 8, M
4, 8 classes, the planes preset's lr 1e-3), batches from RandomState(7), step
keys PRNGKey(100 + i): the three losses and the sums of 8 parameter leaves.
Here the JAX init (under one jit: the same state as the eager init, which
replays the fixture bit for bit) is carried into the port by the bridge, and
the port takes the 3 steps with the same batches and keys: its step splits
each key as the JAX step does, so every draw is JAX's.

In f32 the two compute the same function only up to rounding, which the
seeded net's train-mode BatchNorms amplify (tests/test_torch_train_step_f32.py:
gradients at cosine 0.3-0.75), and from the first update on the port's own
trajectory moves with torch's thread count.  The bounds are set from
measured runs of the port against the fixture at 1, 2, 3, 4 and 8 threads:
the first step's loss (no update yet) 1.52e-2 relative at every count, held
within 2e-2; the next two steps' up to 3.71e-2 and 7.24e-2, held within
1.5e-1; each digest's distance from the fixture, over the L1 norm of the
port's leaf, at most 7.34e-4 for the seven leaves that start from a random
or unit init, held within 2e-3, and up to 0.61 for attentions_bn_bias,
which starts at 0 and holds only 3 updates of the scrambled gradient,
held within 1.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_golden_train import FIXTURE, IMG, NUM_CLASSES, STEPS

FIRST_LOSS_REL = 2e-2
LOSS_REL = 1.5e-1
DIGEST_L1 = 2e-3
ZERO_INIT_DIGEST_L1 = 1.0
ZERO_INIT = ("digest__attentions_bn_bias",)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_port_replays_golden_train():
    from saspa_tpu.fgvc.train import create_train_state
    from saspa_tpu.models.cal import WSDAN_CAL as JCAL
    from saspa_tpu.utils.config import get_train_config as j_train_config
    from saspa_tpu_torch.bridge import load_train_state, train_state_from_flax
    from saspa_tpu_torch.fgvc import train as ttrain
    from saspa_tpu_torch.models.cal import WSDAN_CAL as TCAL
    from saspa_tpu_torch.utils.config import get_train_config as t_train_config

    want = np.load(FIXTURE)
    kw = dict(image_size=(IMG, IMG), net="resnet50", batch_size=8, compute_dtype="float32", num_attentions=4)
    jc = j_train_config("planes").replace(donate_state=False, **kw)
    jmodel = JCAL(num_classes=NUM_CLASSES, M=4, net="resnet50")
    s0 = jax.device_get(jax.jit(lambda k: create_train_state(
        jmodel, jc, NUM_CLASSES, 10, k, sample_input=np.zeros((1, IMG, IMG, 3), np.float32)))(
        jax.random.PRNGKey(1234)))
    # the fixture's digest names of the first and last 4 leaves, and their port keys
    leaves = jax.tree_util.tree_leaves_with_path(s0.params)
    keys = {}
    for path, _ in leaves[:4] + leaves[-4:]:
        name = "digest_" + "".join(str(p) for p in path).replace("'", "").replace("[", "_").replace("]", "")
        keys[name] = ".".join(p.key for p in path)
    assert sorted(keys) == sorted(k for k in want.files if k.startswith("digest_"))

    model = TCAL(num_classes=NUM_CLASSES, M=4, net="resnet50", dtype=torch.float32, device="cpu",
                 param_dtype=torch.float32)
    for p in model.parameters():
        p.requires_grad_(True)
    state = ttrain.TrainState(model=model, momentum={n: torch.zeros_like(p) for n, p in model.named_parameters()},
                              feature_center=torch.zeros(NUM_CLASSES, 4 * model.num_features))
    load_train_state(state, train_state_from_flax(s0.params, s0.batch_stats, s0.opt_state, s0.feature_center,
                                                  s0.step))
    step = ttrain.make_train_step(t_train_config("planes").replace(**kw), 10)
    rng = np.random.RandomState(7)
    losses = []
    for i in range(STEPS):
        y = rng.randint(0, NUM_CLASSES, size=8).astype(np.int32)
        X = rng.rand(8, IMG, IMG, 3).astype(np.float32)
        m = step(state, torch.from_numpy(X).permute(0, 3, 1, 2), torch.from_numpy(y),
                 np.asarray(jax.random.PRNGKey(100 + i), np.uint32))
        losses.append(m["loss"].item())
    rel = np.abs(np.asarray(losses) - want["losses"]) / np.abs(want["losses"])
    assert rel[0] <= FIRST_LOSS_REL and (rel[1:] <= LOSS_REL).all(), (losses, want["losses"])
    sd = state.model.state_dict()
    for name, key in keys.items():
        leaf = sd[key].double()
        err = abs(float(leaf.sum()) - float(want[name])) / float(leaf.abs().sum())
        assert err <= (ZERO_INIT_DIGEST_L1 if name in ZERO_INIT else DIGEST_L1), (name, err)
