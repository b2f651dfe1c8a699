"""The port's filter stage on 2 real ranks against one process, on the CPU.

Ranks run tests/torch_parallel_worker.py under gloo on 127.0.0.1, with the
scorers' towers cut narrow (tests/test_torch_filters.py's tiny_scorers) and
seeded weights:
  * `score_in_batches` through both scorers (CLIP RN50's image features,
    the WSDAN-CAL baseline's logits): 13 files in batches of 8, so the tail
    batch is padded and split unevenly; every rank returns all 13 rows,
    within 1e-6 of the largest of the one-process scores, each rank having
    read and scored only its rows;
  * `cli filter` over a folder holding one corrupt file: rank 0 deletes it
    once, and writes the aug-JSON once, byte-equal to the one-process run's;
    both ranks score half the rows in both scorers.
"""

import json
from pathlib import Path

import numpy as np
from PIL import Image

from tests.test_torch_filters import _aug_folder, _planes_tree
from tests.torch_parallel_worker import Ranks

ENV_NO_WEIGHTS = {"SASPA_STRICT_WEIGHTS": "", "SASPA_WEIGHTS_DIR": ""}


def _env(tmp_path, **kw):
    return {**ENV_NO_WEIGHTS, "SASPA_CHECKPOINTS": str(tmp_path / "no_checkpoints"), **kw}


def test_score_in_batches_over_two_ranks_equals_one(tmp_path):
    rng = np.random.RandomState(5)
    (tmp_path / "imgs").mkdir()
    for i in range(13):
        Image.fromarray(rng.randint(0, 255, (60 + 7 * (i % 4), 72, 3), np.uint8)).save(tmp_path / "imgs" / f"{i:02d}.png")
    env = _env(tmp_path)
    two, one = Ranks("score", tmp_path, world=2, env=env), Ranks("score", tmp_path, world=1, env=env)
    got, (want,) = two.results(), one.results()
    for name, width in (("clip", 32), ("cal", 5)):
        w = want[name]
        assert w.shape == (13, width) and np.isfinite(w).all()
        for rank, res in enumerate(got):
            assert res[name].shape == w.shape
            assert np.abs(res[name] - w).max() <= 1e-6 * np.abs(w).max(), (name, rank)
            t = res["timings"][name]
            assert t["batches"] == 2 and t["images"] == (8 if rank == 0 else 5)  # rows 0-3 and 8-11 / 4-7 and 12
        assert want["timings"][name]["images"] == 13


def test_cli_filter_over_two_ranks_writes_the_one_process_json_once(tmp_path):
    data, ids = _planes_tree(tmp_path / "tree")
    folder = _aug_folder(data, ids)
    (tmp_path / "aug_folder.txt").write_text(str(folder))
    corrupt = folder / f"{ids[1]}_prompt_a plane_7.png"
    env = _env(tmp_path, SASPA_DATA_ROOT=str(tmp_path / "tree"))

    corrupt.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    (one,) = Ranks("cli_filter", tmp_path, world=1, env=env).results()
    json_path = Path(one["path"])
    want = json_path.read_bytes()
    assert not corrupt.exists() and sum(len(v) for v in json.loads(want).values()) > 0
    for p in folder.parent.glob(json_path.stem + "*"):
        p.unlink()

    corrupt.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    ranks = Ranks("cli_filter", tmp_path, world=2, env=env)
    got = ranks.results()
    logs = ranks.log_texts()
    assert got[0]["path"] == got[1]["path"] == str(json_path)
    assert json_path.read_bytes() == want and not corrupt.exists()
    assert [log.count("is corrupted, deleting") for log in logs] == [1, 0]
    assert [log.count("Finished writing") for log in logs] == [1, 0]
    assert len(list(folder.parent.glob(json_path.stem + "_*.log"))) == 1  # the builder's log, rank 0's
    assert one["scored"] == [{"paths": 6, "scored": 6, "batches": 3, "sharded": False}] * 2
    for res in got:  # the CAL baseline, then CLIP: half the rows each
        assert res["scored"] == [{"paths": 6, "scored": 3, "batches": 3, "sharded": True}] * 2
