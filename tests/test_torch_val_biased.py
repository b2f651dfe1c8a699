"""Parity of the port's contextual-bias evaluation (`cli eval-biased`,
fgvc/val_biased.py) with the JAX package's, on the CPU.

A stub planes_biased test split of six 64^2 images (tests/test_val_biased.py's
four ground/plane pairs and two more), one WSDAN-CAL ResNet-50 (M 32, 2
classes) seeded in flax with non-trivial BatchNorm statistics, saved as the
JAX package's checkpoint and, carried over by the bridge, as the port's.
Both evaluate it at 64^2 in f32 (the JAX function's bf16 model is swapped
for f32, so that no near-tied logit can round to another top-1 class),
batch 4, the last batch partial: the accuracies, n_id and n_ood are equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import saspa_tpu.fgvc.val_biased as JVB
import saspa_tpu_torch.fgvc.val_biased as TVB
from saspa_tpu_torch import cli

PAIRS = [("Boeing", "grass"), ("Boeing", "road"), ("Airbus", "road"), ("Airbus", "grass"), ("Boeing", "air"),
         ("Airbus", "air")]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class StubBiasedFiles:
    """A planes_biased split as both packages read it: rows (the port), a
    pandas frame of them (the JAX package), files, labels, classes."""

    dataset_name = "planes-biased"
    num_classes = 2

    def __init__(self, root, pairs=PAIRS):
        import pandas as pd

        rng = np.random.RandomState(0)
        self.rows, self.image_files, self.labels = [], [], []
        for i, (plane, ground) in enumerate(pairs):
            p = root / f"bi{i}.png"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(p)
            self.rows.append({"Plane": plane, "Ground": ground, "Filename": str(p),
                              "Label": str(int(plane == "Boeing")), "Split": "test"})
            self.image_files.append(str(p))
            self.labels.append(int(plane == "Boeing"))
        self.df = pd.DataFrame(self.rows)
        self.classes = ["airbus", "boeing"]


def test_ood_flags_rule(tmp_path):
    """Boeing on road and Airbus on grass are out of domain, as the JAX rule."""
    files = StubBiasedFiles(tmp_path, PAIRS[:4])
    assert TVB._ood_flags(files).tolist() == [0, 1, 0, 1] == JVB._ood_flags(files).tolist()
    files = StubBiasedFiles(tmp_path)
    assert TVB._ood_flags(files).tolist() == JVB._ood_flags(files).tolist()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX orbax dir, port checkpoint file) of one seeded WSDAN-CAL ResNet-50."""
    import jax
    import jax.numpy as jnp

    from saspa_tpu.models.cal import WSDAN_CAL as JaxCAL
    from saspa_tpu.utils.checkpoint import save_checkpoint as jax_save
    from saspa_tpu_torch.bridge import state_dict_from_flax_variables
    from saspa_tpu_torch.models.cal import WSDAN_CAL
    from saspa_tpu_torch.utils.checkpoint import save_checkpoint
    from tests.test_torch_clip_cal import _stats

    root = tmp_path_factory.mktemp("vb_ckpts")
    model = JaxCAL(num_classes=2, M=32, net="resnet50", dtype=jnp.float32)
    v = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    v = _stats(v, 3)
    jax_save(str(root / "jax" / "ckpt"), v["params"], batch_stats=v["batch_stats"])
    port = WSDAN_CAL(num_classes=2, M=32, net="resnet50")
    port.load_state_dict(state_dict_from_flax_variables(v))
    save_checkpoint(str(root / "port" / "run_a" / "model.ckpt"), port)
    return root / "jax" / "ckpt", root / "port"


def _f32_jax_cal(monkeypatch):
    from saspa_tpu.models.cal import WSDAN_CAL as JaxCAL

    monkeypatch.setattr(JVB, "WSDAN_CAL", lambda **kw: JaxCAL(**{**kw, "dtype": np.float32}))


def test_evaluate_checkpoint_matches_jax(tmp_path, monkeypatch, checkpoints):
    """Accuracies, n_id and n_ood of one checkpoint through both functions,
    raw logits only, the last of two batches partial."""
    files = StubBiasedFiles(tmp_path)
    monkeypatch.setattr(JVB, "PlanesBiasedFiles", lambda split: files)
    monkeypatch.setattr(TVB, "PlanesBiasedFiles", lambda split: files)
    _f32_jax_cal(monkeypatch)
    jax_ckpt, port_dir = checkpoints
    kw = dict(net="resnet50", batch_size=4, image_size=(64, 64))
    want = JVB.evaluate_checkpoint(str(jax_ckpt), **kw)
    got = TVB.evaluate_checkpoint(str(port_dir / "run_a" / "model.ckpt"), device="cpu", **kw)
    assert (got["n_id"], got["n_ood"]) == (want["n_id"], want["n_ood"]) == (4, 2)
    for k in ("mean_class_acc", "overall_acc", "id_acc", "ood_acc"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-9), (k, got, want)


def test_sweep_skips_a_mismatched_checkpoint(tmp_path, monkeypatch, checkpoints, capsys):
    """`cli eval-biased --ckpt_folder`: the sweep finds each run's checkpoint
    one level down; a ResNet-50 checkpoint read as the CLI's default
    ResNet-101 prints "Failed to load model" and is skipped; as resnet50 it
    is scored; an orbax directory raises."""
    files = StubBiasedFiles(tmp_path)
    monkeypatch.setattr(TVB, "PlanesBiasedFiles", lambda split: files)
    _, port_dir = checkpoints
    args = cli.build_parser().parse_args(["eval-biased", "--ckpt_folder", str(port_dir)])
    assert (args.net, args.batch_size) == ("resnet101", 16)
    assert cli.cmd_eval_biased(args, device="cpu") == {}
    assert "Failed to load model" in capsys.readouterr().out
    args.net, args.batch_size = "resnet50", 4
    monkeypatch.setattr(TVB, "evaluate_checkpoint", _eval64)
    results = cli.cmd_eval_biased(args, device="cpu")
    assert list(results) == [str(port_dir / "run_a" / "model.ckpt")]
    assert (results[str(port_dir / "run_a" / "model.ckpt")]["n_ood"]) == 2
    orbax = tmp_path / "orbax_run"
    (orbax / "ckpt").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        TVB.main(str(orbax), device="cpu")


_EVAL = TVB.evaluate_checkpoint


def _eval64(path, **kw):
    return _EVAL(path, image_size=(64, 64), **kw)
