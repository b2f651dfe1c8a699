"""The train stage's model pieces against the JAX package's, on the CPU.

* eval_step (two-view TTA) against saspa_tpu.fgvc.train.make_eval_step (the
  file's one jitted JAX step) at tests/test_train_step.py's size: ResNet-50,
  64^2, batch 8, M 4, 8 classes, f32, BatchNorm statistics made
  non-trivial: logits-derived loss within 1e-4 relative, counts equal.
* WSDAN_CAL's training forward from an rng key on a ResNet of one block a
  stage: the fake attention and the map picks are drawn from the same key as
  the JAX module draws them; outputs within 1e-3 of the largest entry (f32;
  the train-mode BatchNorms' fast variance amplifies rounding: 2.5e-4
  measured), running statistics within 1e-4, picks equal.
* sample_attention_maps and BAP with fake_att on fixed inputs.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.fgvc.train import make_eval_step
from saspa_tpu.models import cal as jcal
from saspa_tpu.models import resnet as jresnet
from saspa_tpu.utils.config import get_train_config as j_train_config
from saspa_tpu_torch.bridge import state_dict_from_flax, state_dict_from_flax_variables
from saspa_tpu_torch.fgvc import train as ttrain
from saspa_tpu_torch.models import cal as tcal
from saspa_tpu_torch.models import resnet as tresnet
from saspa_tpu_torch.utils import rng as trng
from saspa_tpu_torch.utils.config import get_train_config as t_train_config
from test_torch_train_step import jit_create_state

NUM_CLASSES, IMG, M, B = 8, 64, 4, 8


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _stats(variables, seed):
    """Running statistics and affine parameters away from their init."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name, x = path[-1].key, np.asarray(x)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def eval_setup():
    jc = j_train_config("planes").replace(image_size=(IMG, IMG), net="resnet50", num_attentions=M,
                                          compute_dtype="float32", donate_state=False)
    model = jcal.WSDAN_CAL(num_classes=NUM_CLASSES, M=M, net="resnet50")
    state = jit_create_state(model, jc, NUM_CLASSES, 3, IMG)
    v = _stats({"params": state.params, "batch_stats": state.batch_stats}, 4)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    return state, make_eval_step(model, NUM_CLASSES)


@pytest.mark.parametrize("seed", [0])
def test_eval_step_matches_jax(eval_setup, seed):
    state, j_eval = eval_setup
    rng = np.random.RandomState(seed)
    X = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    y = rng.randint(0, NUM_CLASSES, B).astype(np.int32)
    key = trng.item_key(1, "attention_pick", 0, seed)
    want = jax.device_get(j_eval(state, jnp.asarray(X), jnp.asarray(y), jnp.asarray(key)))
    tc = t_train_config("planes").replace(net="resnet50", num_attentions=M, compute_dtype="float32")
    ts = ttrain.create_train_state(tc, NUM_CLASSES, device="cpu")
    ts.model.load_state_dict(state_dict_from_flax_variables({"params": state.params,
                                                             "batch_stats": state.batch_stats}))
    got = ttrain.eval_step(ts, torch.from_numpy(X).permute(0, 3, 1, 2), torch.from_numpy(y), key, NUM_CLASSES)
    assert _rel(got["loss"], want["loss"]) <= 1e-4
    for k in ("correct", "aux_correct", "class_corrects", "class_counts"):
        assert got[k].tolist() == np.asarray(want[k]).tolist(), k


@pytest.fixture()
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jresnet.BACKBONES, "resnet_tiny", partial(jresnet.ResNet, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setitem(tresnet.BACKBONES, "resnet_tiny", partial(tresnet.ResNet, stage_sizes=(1, 1, 1, 1)))
    return "resnet_tiny"


_APPLY = {}


def _train_apply(jm):
    if "fn" not in _APPLY:
        _APPLY["init"] = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))
        _APPLY["fn"] = jax.jit(lambda v, x, k: jm.apply(v, x, train=True, rngs_key=k, mutable=["batch_stats"]))
    return _APPLY["init"], _APPLY["fn"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_forward_from_a_key_matches_jax(tiny_backbone, seed):
    rng = np.random.RandomState(10 + seed)
    X = rng.randn(4, 64, 64, 3).astype(np.float32)
    jm = jcal.WSDAN_CAL(num_classes=5, M=16, net=tiny_backbone)
    init, apply = _train_apply(jm)
    v = _stats(init(jax.random.PRNGKey(seed), jnp.asarray(X)), 20 + seed)
    key = trng.item_key(1, "dropout", 0, seed)
    want, mut = apply(v, jnp.asarray(X), jnp.asarray(key))
    tm = tcal.WSDAN_CAL(num_classes=5, M=16, net=tiny_backbone)
    tm.load_state_dict(state_dict_from_flax_variables(v))
    got = tm(torch.from_numpy(X).permute(0, 3, 1, 2), train=True, rngs_key=key)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= 1e-3
    assert _rel(got[3], want[3]) <= 1e-3  # the two picked maps a sample: the picks agree
    stats = state_dict_from_flax(mut["batch_stats"])
    sd = tm.state_dict()
    for k, w in stats.items():
        assert _rel(sd[k], w.numpy()) <= 1e-4, k


def test_fake_attention_is_jax_uniform_in_nhwc_order():
    key = trng.split(trng.item_key(1, "dropout", 0, 0), 2)[0]
    want = np.asarray(jax.random.uniform(jnp.asarray(key), (3, 4, 5, 6), jnp.float32, 0.0, 2.0))
    got = tcal.fake_attention(key, (3, 6, 4, 5))
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_attention_maps_matches_jax(seed):
    rng = np.random.RandomState(seed)
    att = np.maximum(rng.randn(6, 7, 7, 32), 0).astype(np.float32) * rng.uniform(0.1, 3.0, 32).astype(np.float32)
    key = trng.item_key(1, "dropout", 2, seed)
    want = np.asarray(jcal.sample_attention_maps(jnp.asarray(att), jnp.asarray(key)))
    got, picks = tcal.sample_attention_maps(torch.from_numpy(att).permute(0, 3, 1, 2), key, return_picks=True)
    assert np.array_equal(got.numpy(), want)  # every pick equal, so the gathered maps are bit-equal
    inject = tcal.sample_attention_maps(torch.from_numpy(att).permute(0, 3, 1, 2), pick_idx=picks)
    assert torch.equal(inject, got)


def test_bap_with_fake_attention_matches_jax():
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 5, 6, 40).astype(np.float32)
    atts = np.maximum(rng.randn(2, 5, 6, 8), 0).astype(np.float32)
    fake = rng.uniform(0, 2, (2, 5, 6, 8)).astype(np.float32)
    want = jcal.bap(jnp.asarray(feats), jnp.asarray(atts), fake_att=jnp.asarray(fake))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    got = tcal.bap(nchw(feats), nchw(atts), nchw(fake))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
