"""The port's data-parallel training on 2 real ranks against its own
one-process run, with keyed draws and a CutMix recipe, on the CPU in f64.

Both runs (tests/torch_parallel_worker.py `train_keyed`, one with
WORLD_SIZE 1, one with 2 ranks under gloo on 127.0.0.1) read 3 global
batches of 8 from InputPipeline with `classic-cutmix` (random crop, flip,
ColorJitter, two chained CutMix mixes) and the AugSampler swapping half the
originals for augs, then take the keyed train step (the model's fake
attention and picks, the crop and drop thetas all drawn from the step's
key) from one seeded f64 state at tests/test_torch_train_step.py's size.
Each rank loads and transforms only its rows and those its CutMix mixes
from, and makes every draw for the global batch.  So each rank's batches
are bit-equal to the one-process batches' rows, and the steps keep that
file's bounds: equal top-k counts, loss, batch_stats and feature centers
within 1e-9 of each tensor's largest entry at every step, params within
1e-6 and momentum within 1e-5 after the last; rank 1's state equals rank
0's bit for bit.
"""

import json

import numpy as np
import torch
from PIL import Image

from tests.test_torch_train_step import _rel
from tests.torch_parallel_worker import Ranks

B, CLASSES, N = 8, 5, 26  # 3 full batches, 2 images dropped


def _tree(d):
    rng = np.random.RandomState(7)
    files, labels, mapping = [], [], {}
    for i in range(N):
        p = d / "orig" / f"{3000000 + i}.jpg"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (70 + i % 3 * 9, 84, 3), np.uint8)).save(p, "PNG")
        files.append(str(p))
        labels.append(i % CLASSES)
        augs = []
        for k in range(2):
            a = d / "augs" / f"{3000000 + i}_prompt_x_{k}.png"
            a.parent.mkdir(exist_ok=True)
            Image.fromarray(rng.randint(0, 255, (80, 80, 3), np.uint8)).save(a)
            augs.append(str(a))
        mapping[p.name] = augs
    (d / "aug.json").write_text(json.dumps(mapping))
    return files, labels


def test_two_ranks_with_cutmix_and_keyed_draws_match_one_process(tmp_path):
    files, labels = _tree(tmp_path)
    torch.save({"files": files, "labels": labels, "classes": [f"c{k}" for k in range(CLASSES)],
                "aug_json": str(tmp_path / "aug.json"), "batch_size": B, "resize": (64, 64),
                "preset": "classic", "epoch": 1, "num_classes": CLASSES, "M": 4, "net": "resnet50", "init_seed": 0,
                "cfg": dict(image_size=(64, 64), net="resnet50", batch_size=B, num_attentions=4,
                            compute_dtype="float32", learning_rate=1e-6)},
               tmp_path / "keyed_in.pt")
    two = Ranks("train_keyed", tmp_path, world=2)
    one = Ranks("train_keyed", tmp_path, world=1)
    got, (want,) = two.results(), one.results()

    assert len(want["steps"]) == 3 and got[1]["max_diff_from_rank0"] == 0.0
    for rank, res in enumerate(got):
        assert res["swaps"] == want["swaps"] and 0 < want["swaps"][0] < 3 * B
        rows = slice(4 * rank, 4 * rank + 4)
        for i, (b, wb) in enumerate(zip(res["batches"], want["batches"])):
            for k in ("X", "y", "y_soft"):
                assert torch.equal(b[k], wb[k][rows]), (rank, i, k)
        for s, (row, wrow) in enumerate(zip(res["steps"], want["steps"])):
            m, wm = row["metrics"], wrow["metrics"]
            for k in ("raw_correct", "aug_correct", "aux_correct"):
                assert m[k].tolist() == wm[k].tolist(), (rank, s, k)
            assert _rel(m["loss"].item(), wm["loss"].item()) <= 1e-9, (rank, s)
            assert _rel(row["feature_center"], wrow["feature_center"]) <= 1e-9, (rank, s)
            assert max(_rel(v, wrow["batch_stats"][k]) for k, v in row["batch_stats"].items()) <= 1e-9, (rank, s)
    assert max(_rel(v, want["params"][k]) for k, v in got[0]["params"].items()) <= 1e-6
    assert max(_rel(v, want["momentum"][k]) for k, v in got[0]["momentum"].items()) <= 1e-5
    loaded = [n for res in got for n in res["loaded"]]  # rows a rank loaded a batch: its 4, and its mixes' sources
    assert min(loaded) >= 4 and max(loaded) > 4 and want["loaded"] == [B] * 3
