"""The train stage's per-class accuracy plot against the JAX package's, on
the CPU.

* plot_samples_per_class_vs_accuracy: the same file name under the output
  folder, and the same scatter data (fig.axes[0].collections[0]
  .get_offsets()) and axis labels as the JAX figure, for dicts given in
  unsorted key order.
* `cli train --plot_per_class_acc` on a 2-class planes tree writes the val
  and test plots of its one validation, as tests/test_full_pipeline.py
  checks for the JAX CLI; the val plot's scatter is the run's train counts
  against its val per-class accuracy.
* Without matplotlib (sys.modules["matplotlib"] = None) the flag fails in
  `train_config`, before the trainer is built and before the first step,
  with an ImportError that names matplotlib.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from saspa_tpu.fgvc import plots as jplots
from saspa_tpu_torch import cli
from saspa_tpu_torch.fgvc import plots as tplots
from saspa_tpu_torch.fgvc import train as ttrain
from tests.test_torch_inception import read_metrics, small_planes, tiny_planes_tree, train_argv

NAME = "num_samples_per_class_vs_class_accuracy_epoch_{}.png"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share a few cores: torch's thread a core would
    oversubscribe them (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _scatter(fig):
    ax = fig.axes[0]
    return np.asarray(ax.collections[0].get_offsets()), ax.get_xlabel(), ax.get_ylabel()


def test_plot_matches_jax(tmp_path):
    import matplotlib.pyplot as plt

    counts = {2: 5, 0: 3, 3: 0, 1: 7}
    accs = {1: 100.0, 3: 0.0, 0: 50.0, 2: 12.5}
    want = jplots.plot_samples_per_class_vs_accuracy(counts, accs, 7, str(tmp_path / "jax"))
    got = tplots.plot_samples_per_class_vs_accuracy(counts, accs, 7, str(tmp_path / "port"))
    try:
        assert [p.name for p in (tmp_path / "port").iterdir()] == [p.name for p in (tmp_path / "jax").iterdir()] \
            == [NAME.format(7)]
        (g_xy, *g_labels), (w_xy, *w_labels) = _scatter(got), _scatter(want)
        assert np.array_equal(g_xy, w_xy) and g_labels == w_labels
        assert g_xy.tolist() == [[3, 50.0], [7, 100.0], [5, 12.5], [0, 0.0]]
    finally:
        plt.close(got)
        plt.close(want)


def test_cli_train_writes_the_plots(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    plt.close("all")  # a figure another test of this worker left open (tests/test_metrics.py's plot)
    root = tiny_planes_tree(tmp_path / "data")
    small_planes(monkeypatch, root, 64)
    figs = []
    plot = tplots.plot_samples_per_class_vs_accuracy
    monkeypatch.setattr(tplots, "plot_samples_per_class_vs_accuracy", lambda *a: figs.append(a) or plot(*a))
    args = cli.build_parser().parse_args(train_argv(tmp_path / "logs", "resnet50", "--plot_per_class_acc"))
    logs = cli.cmd_train(args, device="cpu")
    save_dir = logs["save_dir"]
    for tag in ("val", "test"):
        assert [p.name for p in Path(save_dir).glob(f"plots/{tag}/*.png")] == [NAME.format(0)]
    counts, accs, epoch, folder = figs[0]
    assert folder.endswith("plots/val") and folder.startswith(save_dir) and epoch == 0
    assert counts == {0: 1, 1: 1}  # the tree's two train images, one a class
    val = next(ln for ln in read_metrics(save_dir) if "val_loss" in ln)
    assert 100 * np.mean(list(accs.values())) == pytest.approx(val["val_mean_class_acc"])  # fractions vs percent
    assert plt.get_fignums() == []  # the runner closes its figures


def test_plot_flag_without_matplotlib_fails_before_the_first_step(tmp_path, monkeypatch):
    root = tiny_planes_tree(tmp_path / "data")
    small_planes(monkeypatch, root, 64)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_trainer(*a, **kw):
        raise AssertionError("the trainer was built")

    monkeypatch.setattr(ttrain.Trainer, "__init__", no_trainer)
    args = cli.build_parser().parse_args(train_argv(tmp_path / "logs", "resnet50", "--plot_per_class_acc"))
    with pytest.raises(ImportError, match="matplotlib"):
        cli.cmd_train(args, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["data"]  # no run's log directory
