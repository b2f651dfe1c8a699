"""The port's Inception-v3 backbone and its WSDAN-CAL nets against the JAX
package, on the CPU.

* InceptionV3Features truncated at mixed_6e and mixed_7c, at 75^2
  (Inception's smallest input) and batch 2, loaded through the bridge from
  one seeded flax tree a net (BatchNorm statistics and affine parameters
  non-trivial): the eval forward in f32, within 2e-5 of the largest output
  (XLA and torch convolve and sum in different orders), and the train-mode
  forward with the running statistics it leaves, in f64 (jax's x64 mode,
  the port's modules in f64), within 1e-8 of the largest output and 1e-6 of
  the largest statistic (the bridge rounds JAX's statistics to f32).  Train
  mode is held in f64 because in f32 the batch's statistics amplify
  rounding without bound at this size: mixed_7c's maps are 1x1, so its last
  BatchNorms normalise over 2 values, and the two packages' f32 outputs
  differ by up to 21% (3e-4 at mixed_6e's 3x3) where the f64 ones agree to
  1e-10.
* WSDAN_CAL on both nets, in eval (f32), and in train (f64) with the fake
  attention and the picks injected: logits, p - p_counterfactual (a
  difference of near-equal logits: 2e-4 in f32), feature matrix, attention
  map and the running statistics.  inception_mixed_7c owns no attention
  head, as the flax module: its maps are the first M feature channels.
* One gradient of inception_mixed_6e in f64: jax.grad of a fixed scalar of
  the train-mode forward against autograd, every parameter within 1e-8 of
  its tensor's largest JAX entry.
* The converter: a reference-layout WSDAN-CAL .pth of each net (the index
  names of the reference's Sequential, torchvision's Inception layout from
  tools/synth_checkpoints.py) gives the JAX converter's trees exactly,
  `cal_net` names the net, and a strict load takes every key but 7c's
  attention head (reported as skipped).
* `cli train --net inception_mixed_6e` takes one step on a 2-class planes
  tree at 80^2 and writes its checkpoint; `cli eval-biased --net
  inception_mixed_6e` scores that checkpoint on a stub planes_biased split.
Each net's JAX side is two jitted calls (f32 and f64) on one module-scoped
seeded tree; the backbone's outputs are taken inside WSDAN_CAL's apply
(flax's captured intermediates), its statistics from the WSDAN_CAL's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import cal as jcal
from saspa_tpu.models.inception import InceptionV3Features as JInception
from saspa_tpu_torch import cli
from saspa_tpu_torch.bridge import _flatten, state_dict_from_flax, state_dict_from_flax_variables
from saspa_tpu_torch.gen.image_io import write_png
from saspa_tpu_torch.models import cal as tcal
from saspa_tpu_torch.models.inception import InceptionV3Features as TInception
from saspa_tpu_torch.utils import config as tconfig

NETS = ("inception_mixed_6e", "inception_mixed_7c")
IMG, B, M, NUM_CLASSES = 75, 2, 8, 5
MAP_HW = {"inception_mixed_6e": 3, "inception_mixed_7c": 1}  # the feature map's side at 75^2


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share a few cores: torch's thread a core would
    oversubscribe them (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seeded_variables(shapes, seed: int):
    """Numpy values for a flax variables tree of ShapeDtypeStructs: kernels
    N(0, 1/fan_in), BatchNorm scales U(0.5, 1.5), biases and means N(0, 0.1),
    variances U(0.5, 2)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def stats_sd(batch_stats) -> dict:
    return state_dict_from_flax(batch_stats)


class JaxRun:
    """One net's seeded flax tree, inputs, injected draws and every JAX
    output the tests compare: the eval forwards from one jitted f32 call,
    the train-mode forwards (and for mixed_6e the gradient) from one jitted
    f64 call."""

    def __init__(self, net: str, seed: int):
        self.net = net
        truncate = net[len("inception_"):]
        jm = jcal.WSDAN_CAL(num_classes=NUM_CLASSES, M=M, net=net)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
        self.v = seeded_variables(shapes, seed)
        rng = np.random.RandomState(seed + 1)
        self.x = rng.randn(B, IMG, IMG, 3).astype(np.float32)
        hw = MAP_HW[net]
        self.fake = rng.uniform(0, 2, (B, hw, hw, M))
        self.pick = rng.randint(0, M, (B, 2)).astype(np.int32)
        self.r1, self.r2 = rng.randn(B, NUM_CLASSES), rng.randn(B, M * tcal.cal_num_features(net))

        def with_features(apply, *a, mutable=(), **kw):
            """apply's output, its mutated collections, and the backbone's
            output (flax's captured intermediates)."""
            out, mut = apply(*a, **kw, mutable=[*mutable, "intermediates"],
                             capture_intermediates=lambda mdl, _: isinstance(mdl, JInception))
            return out, mut, mut.pop("intermediates")["features"]["__call__"][0]

        self.out = jax.device_get(jax.jit(lambda v, x: (lambda o: {"c_eval": o[0], "f_eval": o[2]})(
            with_features(jm.apply, v, x, train=False)))(self.v, self.x))

        with jax.enable_x64(True):
            jm64 = jcal.WSDAN_CAL(num_classes=NUM_CLASSES, M=M, net=net, dtype=jnp.float64)
            v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), self.v)

            def cal_train(params, x, fake, pick):
                return with_features(jm64.apply, {"params": params, "batch_stats": v64["batch_stats"]}, x,
                                     train=True, fake_att=fake, pick_idx=pick, mutable=["batch_stats"])

            def scalar(params, x, fake, pick):
                out = cal_train(params, x, fake, pick)
                p, _, fm, _ = out[0]
                return jnp.sum(p * self.r1) + jnp.sum(fm * self.r2), out

            def run64(v, x, fake, pick):
                if net == "inception_mixed_6e":  # the gradient's forward gives the outputs too
                    (_, (c_train, c_mut, f_train)), grad = jax.value_and_grad(scalar, has_aux=True)(
                        v["params"], x, fake, pick)
                else:
                    c_train, c_mut, f_train = cal_train(v["params"], x, fake, pick)
                out = {"f_train": f_train, "c_train": c_train, "c_stats": c_mut["batch_stats"],
                       "f_stats": c_mut["batch_stats"]["features"]}
                if net == "inception_mixed_6e":
                    out["grad"] = grad
                return out

            self.out.update(jax.device_get(jax.jit(run64)(v64, self.x.astype(np.float64), self.fake, self.pick)))

    def features(self, dtype=torch.float32):
        fv = {"params": self.v["params"]["features"], "batch_stats": self.v["batch_stats"]["features"]}
        m = TInception(self.net[len("inception_"):], dtype=dtype)
        m.load_state_dict(state_dict_from_flax_variables(fv))
        return m.to(dtype)

    def cal(self, dtype=torch.float32):
        m = tcal.WSDAN_CAL(num_classes=NUM_CLASSES, M=M, net=self.net, dtype=dtype)
        m.load_state_dict(state_dict_from_flax_variables(self.v))
        return m.to(dtype)


@pytest.fixture(scope="module", params=NETS)
def run(request):
    return JaxRun(request.param, seed=NETS.index(request.param))


def test_features_eval_match(run):
    got = run.features()(nchw(run.x))
    want = run.out["f_eval"]
    assert tuple(got.shape) == (B, tcal.cal_num_features(run.net), MAP_HW[run.net], MAP_HW[run.net])
    assert rel_err(got.permute(0, 2, 3, 1), want) <= 2e-5


def test_features_train_and_running_statistics_match(run):
    m = run.features(torch.float64)
    got = m(nchw(run.x).double(), train=True)
    assert rel_err(got.permute(0, 2, 3, 1), run.out["f_train"]) <= 1e-8
    own, want = m.state_dict(), stats_sd(run.out["f_stats"])
    assert len(want) == 2 * sum(1 for k in own if k.endswith(".bn.scale"))
    assert max(rel_err(own[k], v) for k, v in want.items()) <= 1e-6


def test_wsdan_cal_eval_matches(run):
    m = run.cal()
    n_flax = len(jax.tree_util.tree_leaves(run.v))
    assert len(m.state_dict()) == n_flax
    assert hasattr(m, "attentions_conv") == (run.net == "inception_mixed_6e")
    got = m(nchw(run.x))
    want = run.out["c_eval"]
    assert rel_err(got[0], want[0]) <= 2e-5
    assert rel_err(got[1], want[1]) <= 2e-4  # p - p_counterfactual: a difference of near-equal logits
    assert rel_err(got[2], want[2]) <= 2e-5
    assert rel_err(got[3], want[3]) <= 2e-5
    assert got[3].dtype == torch.float32


def test_wsdan_cal_train_matches_with_injected_draws(run):
    m = run.cal(torch.float64)
    got = m(nchw(run.x).double(), train=True, fake_att=nchw(run.fake), pick_idx=torch.from_numpy(run.pick))
    want = run.out["c_train"]
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-8
    assert tuple(got[3].shape) == (B, 2, MAP_HW[run.net], MAP_HW[run.net])
    own, stats = m.state_dict(), stats_sd(run.out["c_stats"])
    assert max(rel_err(own[k], v) for k, v in stats.items()) <= 1e-6


@pytest.mark.parametrize("run", ["inception_mixed_6e"], indirect=True)
def test_mixed_6e_gradient_matches_jax(run):
    """jax.grad of sum(p * r1) + sum(feature_matrix * r2) over the params,
    in train mode, against autograd through the port's module, in f64."""
    want = {k: v for k, v in _flatten(run.out["grad"]).items()}
    m = run.cal(torch.float64)
    for p in m.parameters():
        p.requires_grad_(True)
    p, _, fm, _ = m(nchw(run.x).double(), train=True, fake_att=nchw(run.fake), pick_idx=torch.from_numpy(run.pick))
    ((p * torch.from_numpy(run.r1)).sum() + (fm * torch.from_numpy(run.r2)).sum()).backward()
    got = dict(m.named_parameters())
    assert set(got) == {k.replace("/", ".") for k in want}
    errs = {}
    for k, v in want.items():
        g = got[k.replace("/", ".")].grad
        if k.endswith("kernel"):
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        errs[k] = rel_err(g, v)
    assert max(errs.values()) <= 1e-8, sorted(errs.items(), key=lambda kv: -kv[1])[:5]


# ---- the reference's .pth ---------------------------------------------------------
def inception_cal_state_dict(net: str, num_classes: int, m: int, fill=None) -> dict:
    """The reference's WSDAN-CAL state_dict of an Inception net: torchvision's
    Inception layout (tools/synth_checkpoints.py) under the index names of
    get_features_mixed_6e/7c's Sequential, the BasicConv2d attention head
    and the bias-free fc."""
    from saspa_tpu_torch.weights.convert import INCEPTION_SEQUENTIAL
    from tools import synth_checkpoints as synth

    index = {name: i for i, name in enumerate(INCEPTION_SEQUENTIAL) if name}
    last = "Mixed_6e" if net == "inception_mixed_6e" else "Mixed_7c"
    sd = synth._SD(fill)
    for k, v in synth.torchvision_inception_state_dict(fill=fill, with_aux=False).items():
        block, rest = k.split(".", 1)
        if block in index and index[block] <= index[last]:
            sd[f"features.{index[block]}.{rest}"] = v
    sd.conv("attentions.conv", m, tcal.cal_num_features(net), 1, bias=False)
    sd.bn("attentions.bn", m)
    sd.linear("fc", num_classes, m * tcal.cal_num_features(net), bias=False)
    return dict(sd)


def _trees_equal(got, want, what):
    g, w = _flatten(got), _flatten(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w))[:5])
    for k in w:
        assert g[k].shape == w[k].shape and np.array_equal(g[k], w[k]), (what, k)


@pytest.mark.parametrize("net", NETS)
def test_convert_cal_matches_the_jax_converter_and_loads_strictly(net, tmp_path):
    from saspa_tpu_torch.utils.checkpoint import load_checkpoint
    from saspa_tpu_torch.weights import convert as tconvert
    from saspa_tpu_torch.weights.load import load_file
    from tools import convert_weights as jconvert

    sd = inception_cal_state_dict(net, 3, 4, fill=np.random.RandomState(3))
    assert tconvert.cal_net(sd) == net
    got, want = tconvert.convert_cal(sd), jconvert.convert_cal(sd, net=net)
    _trees_equal(got[0], want[0], "params")
    _trees_equal(got[1], want[1], "batch_stats")
    path = tmp_path / "model_bestacc.pth"
    torch.save({"logs": {"epoch": 1}, "state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "feature_center": torch.zeros(3, 4 * tcal.cal_num_features(net))}, path)
    model = tcal.WSDAN_CAL(num_classes=3, M=4, net=net)
    report = load_file(path, "cal", model, sd=sd)[0]
    dropped = sorted(k for k in sd if k.startswith("attentions.")) if net == "inception_mixed_7c" else []
    assert report["skipped"] == dropped and report["params"] == report["module_params"]
    assert len(dropped) in (0, 6)
    ckpt = load_checkpoint(str(path))
    assert ckpt["net"] == net and ckpt["report"]["skipped"] == dropped
    assert ckpt["report"]["read"] == sum(1 for k in sd if "num_batches_tracked" not in k and k not in dropped)
    restored = tcal.WSDAN_CAL(num_classes=3, M=4, net=net)
    from saspa_tpu_torch.utils.checkpoint import restore_into

    assert restore_into(restored, ckpt, strict=True) == []
    for k, v in model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k


@pytest.mark.parametrize("net,size,side", [("inception_mixed_6e", 224, 12), ("inception_mixed_7c", 224, 5),
                                           ("inception_mixed_6e", 299, 17), ("inception_mixed_7c", 299, 8)])
def test_feature_map_sides(net, size, side):
    m = TInception(net[len("inception_"):], device="meta")
    out = m(torch.zeros(1, 3, size, size, device="meta"))
    assert tuple(out.shape) == (1, tcal.cal_num_features(net), side, side)


# ---- cli train and eval-biased ------------------------------------------------------
PLANES = ["737-800", "A320"]  # two classes: a checkpoint planes_biased's 2-class WSDAN-CAL takes
TINY_SPLITS = {"train": 2, "val": 4, "test": 4}  # at batch 2: one train step, one val and one test batch


def tiny_planes_tree(root: Path, seed: int = 0) -> Path:
    """FGVC-Aircraft layout with PNG bytes under .jpg names, 2 variants."""
    rng = np.random.RandomState(seed)
    data = root / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    (data / "variants.txt").write_text("".join(c + "\n" for c in PLANES))
    k = 0
    for split, n in TINY_SPLITS.items():
        lines = []
        for i in range(n):
            image_id = f"{1100000 + 100 * k:07d}"
            k += 1
            h, w = rng.randint(80, 100), rng.randint(90, 130)
            write_png(data / "images" / f"{image_id}.jpg", rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            lines.append(f"{image_id} {PLANES[i % len(PLANES)]}\n")
        (data / f"images_variant_{split}.txt").write_text("".join(lines))
    return root


def train_argv(logdir: Path, net: str, *extra) -> list:
    return ["train", "--dataset", "planes", "--epochs", "1", "--batch_size", "2", "--net", net, "--seed", "1",
            "--logdir", str(logdir), *extra]


def small_planes(monkeypatch, tree_root: Path, size: int) -> None:
    """The data root at the tiny tree, and the planes preset at size^2."""
    monkeypatch.setenv("SASPA_DATA_ROOT", str(tree_root))
    monkeypatch.setitem(tconfig._TRAIN_PRESETS, "planes", {**tconfig._TRAIN_PRESETS["planes"],
                                                           "image_size": (size, size)})


def read_metrics(save_dir) -> list:
    return [json.loads(ln) for ln in (Path(save_dir) / "metrics.jsonl").read_text().splitlines()]


def test_cli_train_inception_one_step_then_eval_biased(tmp_path, monkeypatch):
    import saspa_tpu_torch.fgvc.val_biased as TVB
    from tests.test_torch_val_biased import StubBiasedFiles

    root = tiny_planes_tree(tmp_path / "data")
    small_planes(monkeypatch, root, 80)
    logs = cli.cmd_train(cli.build_parser().parse_args(train_argv(tmp_path / "logs", "inception_mixed_6e")),
                         device="cpu")
    lines = read_metrics(logs["save_dir"])
    assert lines[0]["steps"] == 1 and np.isfinite(lines[0]["train_loss"])
    assert np.isfinite(next(ln for ln in lines if "val_loss" in ln)["val_loss"])
    assert Path(logs["ckpt_path"]).is_file()

    files = StubBiasedFiles(tmp_path)
    monkeypatch.setattr(TVB, "PlanesBiasedFiles", lambda split: files)
    evaluate = TVB.evaluate_checkpoint
    monkeypatch.setattr(TVB, "evaluate_checkpoint", lambda path, **kw: evaluate(path, image_size=(80, 80), **kw))
    args = cli.build_parser().parse_args(["eval-biased", "--ckpt_folder", str(logs["save_dir"]), "--net",
                                          "inception_mixed_6e", "--batch_size", "4"])
    results = cli.cmd_eval_biased(args, device="cpu")
    assert list(results) == [logs["ckpt_path"]]
    res = results[logs["ckpt_path"]]
    assert (res["n_id"], res["n_ood"]) == (4, 2) and 0 <= res["overall_acc"] <= 100
