"""`cli train` on 2 real ranks, on the CPU: the runner and the Trainer's
epoch loop under a mesh.

One planes epoch (ResNet-50 at 64^2, global batch 2, lr 1e-6, classic
augmentation with AugSampler swaps, validation and test at batch 4) through
tests/torch_parallel_worker.py `cli_train`, once with 2 ranks under gloo
and once alone.  Every value the host reads is reduced over the ranks, so
both ranks return the same logs, bit for bit, and take the same decisions;
rank 0 alone makes the log directory, writes metrics.jsonl and the best
checkpoint, and the other rank learns the directory's name from it.  In f32
the global batch's BatchNorm statistics (here over 2 images, E[x^2] -
E[x]^2) are summed in another order than one process sums them, and the
seeded net amplifies that rounding (tests/test_torch_parallel_keyed.py
holds the same steps to 1e-9 in f64): against the one-process run the
steps, the files and the metric names are held equal, and the train loss
within 1e-2 (measured: 4.2e-3).
"""

import json
from pathlib import Path

import numpy as np

from tests.test_torch_train_data import _tree
from tests.torch_parallel_worker import Ranks


def test_cli_train_over_two_ranks(tmp_path):
    _tree(tmp_path / "tree")
    env = {"SASPA_DATA_ROOT": str(tmp_path / "tree")}
    two, one = Ranks("cli_train", tmp_path, world=2, env=env), Ranks("cli_train", tmp_path, world=1, env=env)
    got, (want,) = two.results(), one.results()

    def scalars(logs):
        return {k: v for k, v in logs.items() if k not in ("pipeline_timings", "train_epoch_time")}

    assert scalars(got[0]) == scalars(got[1])
    save_dir = Path(got[0]["save_dir"])
    assert [p.name for p in (tmp_path / "logs_w2").iterdir()] == [save_dir.name]
    lines = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
    want_lines = [json.loads(ln) for ln in (Path(want["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(ln) for ln in lines] == [sorted(ln) for ln in want_lines] and lines[0]["steps"] == 4
    assert Path(got[0]["ckpt_path"]).exists() and sorted(p.name for p in save_dir.iterdir()) == sorted(
        p.name for p in Path(want["save_dir"]).iterdir())
    for rank, res in enumerate(got):  # each rank loaded its half of every batch
        assert res["pipeline_timings"]["train"]["batches"] == want["pipeline_timings"]["train"]["batches"] == 4
    assert np.isfinite(got[0]["train_train_loss"])
    assert abs(got[0]["train_train_loss"] - want["train_train_loss"]) <= 1e-2 * abs(want["train_train_loss"])
