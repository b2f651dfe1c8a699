"""The train stage's data, configuration, checkpoint and entry point, on the
CPU, against the JAX package where it has a counterpart.

* AugSampler and FGVCDataset (subset, few-shot, the ratio-1 drop, stop_aug):
  the path sequences equal the JAX package's for the same seed.
* InputPipeline on a tiny FGVC-Aircraft tree of PNG files: its first train
  batch and its eval batches equal the JAX pipeline's (the file's jitted JAX
  functions are the pipeline's transforms), bit for bit.
* TrainConfig presets and the lr schedule equal the JAX package's.
* A checkpoint round trip, size-tolerant restore, and what raises.
* `cli train` for 1 epoch on the tree (ResNet-50, the planes preset patched
  to 64^2) writes metrics.jsonl and a checkpoint, and the checkpoint
  restored through --ckpt gives the run's test metrics again.
* The CLIP soft-target teacher (--use_target_soft_cross_entropy): its
  prompts equal the JAX teacher's, in label-id order; its logits are
  logit_scale * unit image features of the batch as it is @ the unit text
  features; it raises off the tower's image size, as the JAX teacher does;
  `cli train` with it takes every step with the teacher's logits (towers
  narrowed, at 64^2).  The step's blend is held against JAX's in
  tests/test_torch_train_step_soft.py.
"""

import json
import logging
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.data import datasets as jds
from saspa_tpu.data.pipeline import InputPipeline as JPipeline
from saspa_tpu.fgvc.train import make_lr_schedule
from saspa_tpu.native import native_available
from saspa_tpu.utils import config as jconfig
from saspa_tpu_torch import cli
from saspa_tpu_torch.data import datasets as tds
from saspa_tpu_torch.data.pipeline import InputPipeline as TPipeline
from saspa_tpu_torch.fgvc import runner
from saspa_tpu_torch.fgvc import train as ttrain
from saspa_tpu_torch.gen.image_io import write_png
from saspa_tpu_torch.utils import checkpoint as tckpt
from saspa_tpu_torch.utils import config as tconfig

CLASSES = ["737-800", "A320", "E-190", "172"]
SPLITS = {"train": 8, "val": 4, "test": 4}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (a 1-epoch run went from 3 s alone to 234 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tree(root: Path, seed: int = 0) -> Path:
    """FGVC-Aircraft layout: PNG bytes under .jpg names at sizes around
    the dataset's aspect, plus an aug-JSON of 2 PNG augs a train image."""
    rng = np.random.RandomState(seed)
    data = root / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    (data / "variants.txt").write_text("".join(c + "\n" for c in CLASSES))
    aug_dir = root / "augs"
    aug_dir.mkdir()
    augs, k = {}, 0
    for split, n in SPLITS.items():
        lines = []
        for i in range(n):
            image_id = f"{1000000 + 100 * k:07d}"
            k += 1
            h, w = rng.randint(60, 90), rng.randint(80, 120)
            write_png(data / "images" / f"{image_id}.jpg", rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            lines.append(f"{image_id} {CLASSES[i % len(CLASSES)]}\n")
            if split == "train":
                augs[f"{image_id}.jpg"] = []
                for j in range(2):
                    p = aug_dir / f"{image_id}_aug_{j}.png"
                    write_png(p, rng.randint(0, 256, (64, 64, 3)).astype(np.uint8))
                    augs[f"{image_id}.jpg"].append(str(p))
        (data / f"images_variant_{split}.txt").write_text("".join(lines))
    (root / "aug.json").write_text(json.dumps(augs))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("fgvc"))


def _files(pkg, root, split):
    return pkg.FGVCAircraftFiles(root=str(root / "FGVC-Aircraft"), split=split)


def _quiet(*a):
    pass


def test_aug_sampler_sequence_equals_jax(tree):
    paths = _files(tds, tree, "train").image_files
    for ratio, limit in ((0.4, 2), (1.0, 1), (0.7, None)):
        js = jds.AugSampler(str(tree / "aug.json"), ratio, limit, seed=3, print_func=_quiet)
        ts = tds.AugSampler(str(tree / "aug.json"), ratio, limit, seed=3, print_func=_quiet)
        seq = [paths[i % len(paths)] for i in range(300)]
        assert [ts(p, i) for i, p in enumerate(seq)] == [js(p, i) for i, p in enumerate(seq)]
        assert (ts.times_used_aug_images, ts.times_used_orig_images) == (js.times_used_aug_images,
                                                                        js.times_used_orig_images)


@pytest.mark.parametrize("kw", [dict(aug_sample_ratio=0.4, limit_aug_per_image=2), dict(aug_sample_ratio=1.0),
                                dict(train_sample_ratio=0.5), dict(few_shot=2), dict(aug_sample_ratio=0.4,
                                                                                     stop_aug=True)])
def test_fgvc_dataset_paths_equal_jax(tree, kw):
    kw = dict(kw)
    stop = kw.pop("stop_aug", False)
    if "aug_sample_ratio" in kw:
        kw["aug_json"] = str(tree / "aug.json")
    jd = jds.FGVCDataset(_files(jds, tree, "train"), "train", seed=5, print_func=_quiet, **kw)
    td = tds.FGVCDataset(_files(tds, tree, "train"), "train", seed=5, print_func=_quiet, **kw)
    jd.stop_aug = td.stop_aug = stop
    assert len(td) == len(jd) and td.labels == jd.labels
    order = np.random.RandomState(1).permutation(len(td)).tolist() * 3
    assert [td.item_path(i) for i in order] == [jd.item_path(i) for i in order]


def test_input_pipeline_batches_equal_jax(tree):
    def datasets(pkg):
        train = pkg.FGVCDataset(_files(pkg, tree, "train"), "train", aug_json=str(tree / "aug.json"),
                                aug_sample_ratio=0.4, limit_aug_per_image=2, seed=1, print_func=_quiet)
        test = pkg.FGVCDataset(_files(pkg, tree, "test"), "test", seed=1, print_func=_quiet)
        return train, test

    # load the JAX package's native resize before its pipeline's threads do: its loader has no lock, and a
    # thread that finds the load in flight resizes with PIL instead (other pixels)
    assert native_available()
    jtrain, jtest = datasets(jds)
    ttrain_ds, ttest = datasets(tds)
    kw = dict(batch_size=4, resize=(64, 64), seed=1, num_threads=2)
    jp, tp = JPipeline(jtrain, train_transform="classic", **kw), TPipeline(ttrain_ds, train_transform="classic",
                                                                          device="cpu", **kw)
    jx, jy, _ = next(iter(jp.iter_train(0)))
    tx, ty, tsoft = next(iter(tp.iter_train(0)))
    assert tx.shape == (4, 3, 64, 64) and ty.tolist() == np.asarray(jy).tolist() and tsoft is None
    assert np.array_equal(tx.permute(0, 2, 3, 1).numpy(), np.asarray(jx))
    je = list(JPipeline(jtest, batch_size=2, resize=(64, 64), num_threads=2).iter_eval())
    te = list(TPipeline(ttest, batch_size=2, resize=(64, 64), num_threads=2, device="cpu").iter_eval())
    assert len(te) == len(je) == 2
    for (a, ay), (b, by) in zip(te, je):
        assert np.array_equal(a.permute(0, 2, 3, 1).numpy(), np.asarray(b)) and ay.tolist() == list(by)


def test_input_pipeline_reraises_producer_errors(tree, tmp_path):
    bad = tmp_path / "aug.json"
    bad.write_text(json.dumps({k: [str(tmp_path / "missing.png")] for k in json.loads((tree / "aug.json")
                                                                                      .read_text())}))
    ds = tds.FGVCDataset(_files(tds, tree, "train"), "train", aug_json=str(bad), aug_sample_ratio=1.0, seed=1,
                         print_func=_quiet)
    with pytest.raises(RuntimeError, match="producer failed"):
        list(TPipeline(ds, batch_size=4, resize=(64, 64), num_threads=2, device="cpu").iter_train(0))


@pytest.mark.parametrize("dataset", tconfig.DATASETS_SUPPORTED)
def test_train_config_presets_equal_jax(dataset):
    for preset in (None, "original_cal"):
        want = jconfig.get_train_config(dataset, preset=preset, epochs=7, few_shot=None)
        got = tconfig.get_train_config(dataset, preset=preset, epochs=7, few_shot=None)
        for f in tconfig.TrainConfig.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), (dataset, preset, f)
    assert tconfig.get_train_config(dataset, few_shot=4).epochs == 100


def test_weight_decay_override_warns(caplog):
    with caplog.at_level(logging.WARNING):
        cfg = tconfig.get_train_config("planes", weight_decay=5e-4)
    assert cfg.weight_decay == 5e-4 and cfg.optimizer_weight_decay == 1e-5
    assert "optimizer_weight_decay" in caplog.text


@pytest.mark.parametrize("batches", [1, 17, 400])
def test_lr_schedule_equals_jax(batches):
    jc, tc = jconfig.get_train_config("planes"), tconfig.get_train_config("planes")
    sched = make_lr_schedule(jc, batches)
    for step in (0, 1, 5, batches, 3 * batches + 7, 140 * batches - 1):
        want = float(sched(jnp.asarray(step, jnp.int32)))
        assert abs(ttrain.lr_at(tc, batches, step) - want) <= 2e-7 * want, step


def test_checkpoint_round_trip(tmp_path):
    cfg = tconfig.get_train_config("planes", net="resnet50", num_attentions=4, compute_dtype="float32")
    a = ttrain.create_train_state(cfg, 5, device="cpu", init_seed=1)
    with torch.no_grad():
        a.model.attentions_bn.mean.add_(0.5)
        a.feature_center.normal_()
    path = tmp_path / "model.ckpt"
    tckpt.save_checkpoint(str(path), a.model, feature_center=a.feature_center, logs={"val_loss": np.float32(1.5)})
    assert json.loads(Path(str(path) + ".logs.json").read_text()) == {"val_loss": 1.5}
    ck = tckpt.load_checkpoint(str(path))
    b = ttrain.create_train_state(cfg, 5, device="cpu", init_seed=2)
    assert tckpt.restore_into(b.model, ck, strict=True) == []
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(ck["feature_center"], a.feature_center) and ck["logs"] == {"val_loss": 1.5}
    # size-tolerant: another class count keeps the new head, loads the rest
    c = ttrain.create_train_state(cfg, 7, device="cpu", init_seed=2)
    fc_before = c.model.fc.kernel.detach().clone()
    assert tckpt.restore_into(c.model, ck) == ["fc.kernel"]
    assert torch.equal(c.model.fc.kernel, fc_before)
    assert torch.equal(c.model.attentions_bn.mean, a.model.attentions_bn.mean)
    with pytest.raises(ValueError, match="strict"):
        tckpt.restore_into(c.model, ck, strict=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_checkpoint(str(tmp_path))


def _train_args(tree, tmp_path, *extra):
    return cli.build_parser().parse_args(
        ["train", "--dataset", "planes", "--aug_json", str(tree / "aug.json"), "--aug_sample_ratio", "0.4",
         "--limit_aug_per_image", "2", "--special_aug", "classic", "--epochs", "1", "--batch_size", "2",
         "--net", "resnet50", "--seed", "1", "--gpu_id", "3", "--logdir", str(tmp_path / "logs"), *extra])


def _small_planes(monkeypatch, tree):
    """The data root at the tiny tree, and the planes preset at 64^2."""
    monkeypatch.setenv("SASPA_DATA_ROOT", str(tree))
    monkeypatch.setitem(tconfig._TRAIN_PRESETS, "planes", {**tconfig._TRAIN_PRESETS["planes"], "image_size": (64, 64)})


@pytest.mark.parametrize("extra", [[], ["--dont_use_wsdan"]])
def test_cli_train_one_epoch_writes_metrics_and_a_checkpoint_that_restores(tree, tmp_path, monkeypatch, extra):
    _small_planes(monkeypatch, tree)
    logs = cli.cmd_train(_train_args(tree, tmp_path, *extra), device="cpu")
    save_dir = Path(logs["save_dir"])
    lines = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(ln)[:2] for ln in lines][0] == ["epoch", "epoch_time"] and lines[0]["steps"] == 4
    test = next(ln for ln in lines if "test_loss" in ln)
    assert {"val_loss", "val_topk_accuracy"} <= set(next(ln for ln in lines if "val_loss" in ln))
    assert np.isfinite(lines[0]["train_loss"]) and Path(logs["ckpt_path"]).exists()
    assert logs["pipeline_timings"]["train"]["batches"] == 4
    again = runner.evaluate_checkpoint(_train_args(tree, tmp_path, *extra, "--ckpt", logs["ckpt_path"]), device="cpu")
    assert again["test_loss"] == test["test_loss"]
    assert again["test_topk_accuracy"][0] == test["test_topk_accuracy"]
    assert again["test_mean_class_acc"] == test["test_mean_class_acc"]


@pytest.mark.parametrize("flag", ["--wandb", "--plot_per_class_acc"])
def test_cli_train_options_not_ported_raise(tree, tmp_path, monkeypatch, flag):
    """--wandb is not ported (wandb is installed on neither machine);
    --plot_per_class_acc raises where matplotlib is missing, as on the
    card's machine (tests/test_torch_plots.py runs it with matplotlib)."""
    _small_planes(monkeypatch, tree)
    if flag == "--plot_per_class_acc":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(NotImplementedError if flag == "--wandb" else ImportError):
        cli.cmd_train(_train_args(tree, tmp_path, flag), device="cpu")


def _narrow_clip(monkeypatch, size=64):
    """The teacher's CLIP RN50 towers narrowed (layers 1 a stage, width 16)
    with their attention pool sized for size^2 batches."""
    from saspa_tpu_torch.filters import clip_filters as tclip_filters
    from saspa_tpu_torch.models.clip import CLIPVisionRNConfig
    from saspa_tpu_torch.models.text_encoder import CLIPTextConfig

    monkeypatch.setattr(tclip_filters, "VISION_CFG", CLIPVisionRNConfig(layers=(1, 1, 1, 1), width=16, output_dim=32,
                                                                        image_size=size))
    monkeypatch.setattr(tclip_filters, "TEXT_CFG", CLIPTextConfig(width=32, layers=2, heads=2, projection_dim=32))


def test_clip_teacher_prompts_logits_and_refusals(monkeypatch):
    """The prompts of both packages' teachers, one per class in label-id
    order ("a photo of a {name}, a type of aircraft." for planes, "... car."
    for cars); cub is refused by both; the port's logits on a batch, as
    they are, against logit_scale * unit(image) @ unit(text)^T; a batch off
    the tower's image size raises (flax's ScopeParamShapeError in the JAX
    teacher at 448^2)."""
    import saspa_tpu.filters.clip_filters as jclip_filters

    seen = {}

    class Recorder:
        def __init__(self, kind, *a, **k):
            assert kind == "rn50"

        def text_features(self, prompts):
            seen["jax"] = list(prompts)
            return np.zeros((len(prompts), 4), np.float32)

    monkeypatch.setattr(jclip_filters, "CLIPScorer", Recorder)
    from saspa_tpu.fgvc.runner import _make_clip_teacher as jax_teacher

    _narrow_clip(monkeypatch)
    names = ["Boeing 737-800", "Airbus A320", "Cessna 172"]
    for dataset, kind in (("planes", "aircraft"), ("cars", "car")):
        jax_teacher(dataset, names)
        teacher = runner.make_clip_teacher(dataset, names, device="cpu")
        scorer = teacher.scorer
        assert seen["jax"] == [f"a photo of a {n}, a type of {kind}." for n in names]
        want_txt = torch.from_numpy(scorer.text_features(seen["jax"]))
        assert torch.equal(teacher.text_features, want_txt)
    for make in (lambda: jax_teacher("cub", names), lambda: runner.make_clip_teacher("cub", names, device="cpu")):
        with pytest.raises(AssertionError, match="planes/cars"):
            make()
    X = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32))
    got = teacher(X)
    with torch.no_grad():
        img = scorer.model.visual(X)
        img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-8)
    want = scorer.logit_scale * img @ want_txt.T
    assert got.shape == (2, 3) and got.dtype == torch.float32
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="positional embedding"):
        teacher(torch.zeros(1, 3, 128, 128))


def test_cli_train_with_the_clip_teacher(tree, tmp_path, monkeypatch):
    """`cli train --use_target_soft_cross_entropy` for 1 epoch: every step
    gets the teacher's (B, 4) logits of its own batch, the loss is finite."""
    _small_planes(monkeypatch, tree)
    _narrow_clip(monkeypatch)
    seen = []
    step = ttrain.make_train_step

    def recording_step(cfg, n, mesh=None):
        inner = step(cfg, n, mesh)

        def run(state, X, y, key, y_soft=None, draws=None, clip_logits=None):
            seen.append((cfg.use_target_soft_cross_entropy, tuple(X.shape), tuple(clip_logits.shape)))
            return inner(state, X, y, key, y_soft=y_soft, draws=draws, clip_logits=clip_logits)

        return run

    monkeypatch.setattr(ttrain, "make_train_step", recording_step)
    logs = cli.cmd_train(_train_args(tree, tmp_path, "--use_target_soft_cross_entropy"), device="cpu")
    assert seen == [(True, (2, 3, 64, 64), (2, 4))] * 4
    assert np.isfinite(logs["train_train_loss"])
