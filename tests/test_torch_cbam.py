"""The port's CBAM and SPP blocks and the CBAM ResNets against the JAX
package, on the CPU.

* CBAMLayer (channel 32, reduction 16, spatial kernel 7) and SPPLayer (3
  levels) on seeded inputs and flax weights: in f32 within 1e-6 of the
  largest output (SPP exactly), and on a bf16 input, where the JAX layer,
  built without a dtype, promotes to its f32 parameters: the port's output
  is f32 too, within 1e-6 of JAX's (SPP: bf16, exactly).
* A tiny CBAM ResNet (stage_sizes (1, 1, 1, 1), registered in both
  packages' BACKBONES as tests/test_torch_train_model.py registers its tiny
  ResNet): the eval forward in f32 within 2e-5, and in bf16 its output
  dtype is JAX's (f32: the last block's gate).
* Its WSDAN-CAL train step against JAX's in f64, as
  tests/test_torch_train_step.py holds ResNet-50's (at 32^2, batch 4):
  both packages start from one seeded flax TrainState and take 2 steps on
  the same batches with the same injected draws; top-k counts equal, loss,
  batch_stats and feature centers within 1e-9 of each tensor's largest
  entry, params 1e-6 and momentum 1e-5.
* A reference-layout ResNet-50 CBAM WSDAN-CAL .pth (the ResNet layout of
  tools/synth_checkpoints.py with a CBAMLayer's keys a block): `cal_net`
  names resnet50_cbam and a strict load takes every key.
* `cli train --net resnet50_cbam` takes one step on a 2-class planes tree
  at 64^2.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.fgvc.train import create_train_state as j_create_state
from saspa_tpu.fgvc.train import make_train_step as j_make_step
from saspa_tpu.models import blocks as jblocks
from saspa_tpu.models import resnet as jresnet
from saspa_tpu.models.cal import WSDAN_CAL as JCAL
from saspa_tpu.utils.config import get_train_config as j_train_config
from saspa_tpu_torch import cli
from saspa_tpu_torch.bridge import load_train_state, state_dict_from_flax, state_dict_from_flax_variables, \
    train_state_from_flax
from saspa_tpu_torch.fgvc import train as ttrain
from saspa_tpu_torch.models import blocks as tblocks
from saspa_tpu_torch.models import resnet as tresnet
from saspa_tpu_torch.models.cal import WSDAN_CAL as TCAL
from saspa_tpu_torch.utils.config import get_train_config as t_train_config
from tests.test_torch_inception import (read_metrics, rel_err, seeded_variables, small_planes, tiny_planes_tree,
                                        train_argv)
from tests.test_torch_train_step import _flax_sd, _port_draws, _rel


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share a few cores: torch's thread a core would
    oversubscribe them (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _init(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x.shape, x.dtype)))
    return seeded_variables(shapes, seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cbam_layer_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 5, 32).astype(np.float32)
    jm = jblocks.CBAMLayer(32)
    v = _init(jm, x, 1)
    xj = jnp.asarray(x, dtype)
    want = jax.jit(jm.apply)(v, xj)
    tm = tblocks.CBAMLayer(32)
    tm.load_state_dict(state_dict_from_flax(v["params"]))
    got = tm(nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32  # JAX promotes to its f32 parameters
    assert rel_err(got.permute(0, 2, 3, 1), want) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(7, 9), (8, 8)])
def test_spp_layer_matches_jax(dtype, hw):
    x = np.random.RandomState(2).randn(2, *hw, 5).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jblocks.SPPLayer(3).apply({}, xj).astype(jnp.float32))
    got = tblocks.SPPLayer(3)(nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == dtype
    assert np.array_equal(got.float().numpy(), want)


@pytest.fixture()
def tiny_cbam(monkeypatch):
    monkeypatch.setitem(jresnet.BACKBONES, "resnet_tiny_cbam", partial(jresnet.ResNet, stage_sizes=(1, 1, 1, 1),
                                                                      use_cbam=True))
    monkeypatch.setitem(tresnet.BACKBONES, "resnet_tiny_cbam", partial(tresnet.ResNet, stage_sizes=(1, 1, 1, 1),
                                                                      use_cbam=True))
    return "resnet_tiny_cbam"


def test_tiny_cbam_resnet_forward_matches_and_keeps_jax_dtypes(tiny_cbam):
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jm = jresnet.BACKBONES[tiny_cbam]()
    v = _init(jm, x, 4)
    tm = tresnet.BACKBONES[tiny_cbam]()
    assert len(tm.state_dict()) == len(jax.tree_util.tree_leaves(v))
    tm.load_state_dict(state_dict_from_flax_variables(v))
    assert rel_err(tm(nchw(x)).permute(0, 2, 3, 1), jax.jit(jm.apply)(v, x)) <= 2e-5
    jb = jresnet.BACKBONES[tiny_cbam](dtype=jnp.bfloat16)
    want = jax.eval_shape(lambda: jb.apply(v, jnp.zeros((1, 64, 64, 3))))
    tb = tresnet.BACKBONES[tiny_cbam](dtype=torch.bfloat16)
    tb.load_state_dict(state_dict_from_flax_variables(v))
    assert str(want.dtype) == "float32" and tb(nchw(x[:1])).dtype == torch.float32
    assert tb.layer1_0.cbam.mlp_down.kernel.dtype == torch.float32


NUM_CLASSES, IMG, M, B, STEPS, LR = 8, 32, 4, 4, 2, 1e-6  # lr: tests/test_torch_train_step.py's


def step_inputs(s: int):
    """Step s's batch (labels repeating class 3, which pins the feature
    centers' accumulating scatter) and injected draws, as
    tests/test_torch_train_step.py makes them."""
    rng = np.random.RandomState(s)
    y = np.array([3, 3, 1, 3], np.int32)
    X = rng.rand(B, IMG, IMG, 3) * 0.1
    for i, lbl in enumerate(y):
        X[i, :, :, lbl % 3] += (lbl + 1) / NUM_CLASSES
    h = IMG // 16
    d = {"fake1": rng.uniform(0, 2, (B, h, h, M)), "pick1": rng.randint(0, M, (B, 2)).astype(np.int32),
         "fake2": rng.uniform(0, 2, (2 * B, h, h, M)), "pick2": rng.randint(0, M, (2 * B, 2)).astype(np.int32),
         "crop_theta": rng.uniform(0.4, 0.6, B), "drop_theta": rng.uniform(0.2, 0.5, B)}
    return X, y, d


def seeded_train_state(model, jc, seed: int):
    """The JAX TrainState's structure (eval_shape of its create_train_state)
    with seeded f64 params and batch_stats, zero momentum, centers and step:
    no init to compile."""
    shapes = jax.eval_shape(lambda: j_create_state(model, jc, NUM_CLASSES, 10, jax.random.PRNGKey(0),
                                                   sample_input=np.zeros((1, IMG, IMG, 3), np.float32)))
    v = seeded_variables({"params": shapes.params, "batch_stats": shapes.batch_stats}, seed)

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    def zeros(s):
        return np.zeros(s.shape, np.float64 if jnp.issubdtype(s.dtype, jnp.floating) else s.dtype)

    return shapes.replace(params=f64(v["params"]), batch_stats=f64(v["batch_stats"]),
                          opt_state=jax.tree_util.tree_map(zeros, shapes.opt_state),
                          feature_center=zeros(shapes.feature_center), step=np.zeros((), np.int32))


def test_tiny_cbam_train_step_matches_jax_in_f64(tiny_cbam):
    kw = dict(image_size=(IMG, IMG), net=tiny_cbam, batch_size=B, num_attentions=M, compute_dtype="float32",
              learning_rate=LR)
    jc = j_train_config("planes").replace(donate_state=False, **kw)
    tc = t_train_config("planes").replace(**kw)
    inputs = [step_inputs(s) for s in range(STEPS)]
    with jax.enable_x64(True):
        model = JCAL(num_classes=NUM_CLASSES, M=M, net=tiny_cbam, dtype=jnp.float64)
        state = s0 = seeded_train_state(model, jc, 6)
        step = j_make_step(model, jc, 10)
        want = []
        for s, (X, y, d) in enumerate(inputs):
            state, m = step(state, jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(s),
                            draws={k: jnp.asarray(v) for k, v in d.items()})
            want.append((jax.device_get(state), jax.device_get(m)))
    f64 = torch.float64
    tm = TCAL(num_classes=NUM_CLASSES, M=M, net=tiny_cbam, dtype=f64, device="cpu", param_dtype=f64).to(f64)
    for p in tm.parameters():
        p.requires_grad_(True)
    port = ttrain.TrainState(model=tm, momentum={n: torch.zeros_like(p) for n, p in tm.named_parameters()},
                             feature_center=torch.zeros(NUM_CLASSES, M * 2048, dtype=f64))
    load_train_state(port, train_state_from_flax(s0.params, s0.batch_stats, s0.opt_state, s0.feature_center, s0.step))
    assert any(".cbam." in k for k in port.momentum)
    t_step = ttrain.make_train_step(tc, 10)
    for s, (X, y, d) in enumerate(inputs):
        m = t_step(port, nchw(X), torch.from_numpy(y), np.asarray(jax.random.PRNGKey(s), np.uint32),
                   draws=_port_draws(d, f64))
        js, jm = want[s]
        for k in ("raw_correct", "aug_correct", "aux_correct"):
            assert m[k].tolist() == np.asarray(jm[k]).tolist(), (s, k)
        assert _rel(m["loss"].item(), jm["loss"]) <= 1e-9
        assert _rel(port.feature_center, js.feature_center) <= 1e-9
        sd = tm.state_dict()
        for tree, tol in ((js.params, 1e-6), (js.batch_stats, 1e-9)):
            assert max(_rel(sd[k], v) for k, v in _flax_sd(tree).items()) <= tol, s
        assert max(_rel(port.momentum[k], v) for k, v in _flax_sd(js.opt_state[1].trace).items()) <= 1e-5, s


def cbam_cal_state_dict(fill) -> dict:
    """The reference's WSDAN-CAL ResNet-50 state_dict with a CBAMLayer's
    keys (weights/convert.py CBAM_KEYS) in every block, 3 classes, M 4."""
    from saspa_tpu_torch.weights.convert import CBAM_KEYS
    from tools import synth_checkpoints as synth

    sd = synth.cal_checkpoint_state_dict(depth=50, num_classes=3, M=4, fill=fill)
    for li, blocks in enumerate((3, 4, 6, 3), start=4):
        out = 256 * 2 ** (li - 4)
        for bi in range(blocks):
            pre = f"features.{li}.{bi}.cbam"
            sd[f"{pre}.{CBAM_KEYS['mlp_down']}.weight"] = fill.randn(out // 16, out, 1, 1).astype(np.float32)
            sd[f"{pre}.{CBAM_KEYS['mlp_up']}.weight"] = fill.randn(out, out // 16, 1, 1).astype(np.float32)
            sd[f"{pre}.{CBAM_KEYS['spatial_conv']}.weight"] = fill.randn(1, 2, 7, 7).astype(np.float32)
    return dict(sd)


def test_cbam_reference_pth_loads_every_key(tmp_path):
    from saspa_tpu_torch.weights.convert import cal_net
    from saspa_tpu_torch.weights.load import load_file

    sd = cbam_cal_state_dict(np.random.RandomState(5))
    assert cal_net(sd) == "resnet50_cbam"
    path = tmp_path / "cbam.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    model = TCAL(num_classes=3, M=4, net="resnet50_cbam")
    report = load_file(path, "cal", model, sd=sd)[0]
    assert report["skipped"] == [] and report["params"] == report["module_params"]
    key = "features.layer2_1.cbam.spatial_conv.kernel"
    assert torch.equal(model.state_dict()[key], torch.from_numpy(sd["features.5.1.cbam.conv.weight"]))


def test_cli_train_resnet50_cbam_one_step(tmp_path, monkeypatch):
    root = tiny_planes_tree(tmp_path / "data")
    small_planes(monkeypatch, root, 64)
    logs = cli.cmd_train(cli.build_parser().parse_args(train_argv(tmp_path / "logs", "resnet50_cbam")), device="cpu")
    lines = read_metrics(logs["save_dir"])
    assert lines[0]["steps"] == 1 and np.isfinite(lines[0]["train_loss"])
    ckpt = torch.load(logs["ckpt_path"], weights_only=True)
    assert "features.layer4_2.cbam.mlp_up.kernel" in ckpt["params"]
