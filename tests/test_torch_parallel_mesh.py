"""The port's data-parallel helpers on one process, on the CPU.

`saspa_tpu_torch.parallel` against `saspa_tpu.parallel` where both have the
name (pad_to_multiple), the one-rank mesh and what the helpers refuse; the
row-sliced draws every rank of a data-parallel step makes (each draws for
the global batch and keeps its rows: the transforms, CutMix, the model's
fake attention and picks, the crop and drop thetas) bit-equal to the same
rows of the whole batch's; and `utils/profiling.py` against the JAX
package's.  The multi-process runs are tests/test_torch_parallel_*.py.
"""

import json

import numpy as np
import pytest
import torch

from saspa_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from saspa_tpu.utils import profiling as jprof
from saspa_tpu_torch import parallel
from saspa_tpu_torch.models import cal as tcal
from saspa_tpu_torch.ops import augment as taug
from saspa_tpu_torch.ops import batch_augment as tba
from saspa_tpu_torch.parallel import mesh as tmesh
from saspa_tpu_torch.utils import profiling as tprof
from saspa_tpu_torch.utils import rng as rngs

B = 8
ROWS = {"first_half": np.arange(0, 4), "second_half": np.arange(4, 8), "scattered": np.array([1, 2, 6])}


def test_pad_to_multiple_equals_jax():
    for n, m in [(13, 8), (16, 8), (1, 8), (8, 2), (9, 2), (64, 3), (0, 4)]:
        assert parallel.pad_to_multiple(n, m) == j_pad_to_multiple(n, m)


def test_one_rank_mesh_and_the_shapes_it_refuses():
    mesh = parallel.make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.rank, mesh.size) == ((1, 1), ("data", "model"), 0, 1)
    assert parallel.local_device_count() == 1
    assert parallel.DATA_AXIS == "data" and parallel.MODEL_AXIS == "model"
    for shape in [(2, 1), (2,), (1, 2)]:
        with pytest.raises(ValueError, match="ranks"):
            parallel.make_mesh(shape)
    x = {"X": np.arange(24.0).reshape(B, 3), "y": torch.arange(B)}
    got = parallel.shard_batch(tmesh.Mesh((1, 1), ("data", "model"), 0, torch.device("cpu")), x)
    assert np.array_equal(got["X"].numpy(), x["X"]) and torch.equal(got["y"], x["y"])
    assert parallel.replicated(mesh, [torch.nn.Linear(2, 2), {"a": torch.ones(3)}]) is not None


def test_shard_batch_takes_the_ranks_contiguous_rows_and_refuses_a_ragged_batch():
    X, y = np.arange(24.0).reshape(B, 3), torch.arange(B)
    for rank in (0, 1):
        mesh = tmesh.Mesh((2, 1), ("data", "model"), rank, torch.device("cpu"))
        got = parallel.shard_batch(mesh, (X, {"y": y, "none": None}))
        assert np.array_equal(got[0].numpy(), X[4 * rank:4 * rank + 4])
        assert got[1]["y"].tolist() == list(range(4 * rank, 4 * rank + 4)) and got[1]["none"] is None
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(tmesh.Mesh((2, 1), ("data", "model"), 0, torch.device("cpu")), {"X": X[:7]})


def test_init_distributed_is_a_noop_without_a_world_and_refuses_a_missing_card(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.init_distributed() == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.init_distributed() == 1
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no CUDA device"):
        parallel.init_distributed()
    assert not torch.distributed.is_initialized()


# ---- a shard's draws are the global batch's -----------------------------------
@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("preset", ["classic", "classic_no_color", "randaug", "autoaug", None])
def test_transform_of_rows_equals_the_batchs_rows(preset, rows):
    idx = ROWS[rows]
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (B, 40, 44, 3), np.uint8))
    key = rngs.item_key(1, "augment", 2, 3)
    full = taug.train_transform_batch(u8, key, preset, 32, 32)
    part = taug.train_transform_batch(u8[idx], key, preset, 32, 32, rows=rngs.Rows(idx, B))
    assert torch.equal(part, full[idx])


@pytest.mark.parametrize("rows", list(ROWS))
def test_cutmix_of_rows_loads_only_its_sources_and_equals_the_batchs_rows(rows):
    idx = ROWS[rows]
    X = torch.from_numpy(np.random.RandomState(1).randn(B, 3, 16, 16).astype(np.float32))
    y = torch.arange(B) % 5
    found = False
    for i in range(8):
        key = rngs.item_key(1, "cutmix", 0, i)
        fx, fy, fsoft = taug.cutmix_batch(X, y, key, 5)
        src = taug.cutmix_sources(key, rngs.Rows(idx, B), 16, 16)
        assert set(idx) <= set(src.tolist()) and list(src) == sorted(set(src.tolist()))
        found |= len(src) < B
        px, py, psoft = taug.cutmix_batch(X[src], y[src], key, 5, rows=rngs.Rows(idx, B))
        assert torch.equal(px, fx[idx]) and torch.equal(py, fy[idx]) and torch.equal(psoft, fsoft[idx])
    assert found  # some batch of the 8 needs fewer than all its rows


@pytest.mark.parametrize("rows", list(ROWS))
def test_model_and_crop_drop_draws_of_rows_equal_the_batchs_rows(rows):
    idx = ROWS[rows]
    r = rngs.Rows(idx, B)
    key = rngs.item_key(1, "dropout", 0, 4)
    assert torch.equal(tcal.fake_attention(key, (len(idx), 4, 3, 5), rows=r),
                       tcal.fake_attention(key, (B, 4, 3, 5))[idx])
    att = torch.from_numpy(np.random.RandomState(2).rand(B, 4, 3, 5).astype(np.float32))
    _, picks = tcal.sample_attention_maps(att, key, return_picks=True)
    _, part = tcal.sample_attention_maps(att[idx], key, return_picks=True, rows=r)
    assert torch.equal(part, picks[idx])
    imgs = torch.from_numpy(np.random.RandomState(3).rand(B, 3, 24, 20).astype(np.float32))
    amap = torch.from_numpy(np.random.RandomState(4).rand(B, 3, 5).astype(np.float32))
    for mode, theta in (("crop", (0.4, 0.6)), ("drop", (0.2, 0.5))):
        full = tba.batch_augment(imgs, amap, key, mode=mode, theta=theta)
        assert torch.equal(tba.batch_augment(imgs[idx], amap[idx], key, mode=mode, theta=theta, rows=r), full[idx])


# ---- utils/profiling.py --------------------------------------------------------
def test_throughput_meter_summary_equals_jax(monkeypatch):
    """Both meters on one fake clock; the JAX meter's chip count is set to
    the port's one device a process."""
    import jax

    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    for warmup, ticks in ((1, [(4, 0.5), (4, 1.25), (8, 2.0), (3, 3.5)]), (2, [(5, 0.1), (5, 0.2), (7, 0.9)]),
                          (1, [(2, 0.3)])):
        clock = {"t": 10.0}
        monkeypatch.setattr("time.perf_counter", lambda: clock["t"])
        metres = [tprof.ThroughputMeter("images", warmup), jprof.ThroughputMeter("images", warmup)]
        for n, t in ticks:
            clock["t"] = 10.0 + t
            for m in metres:
                m.tick(n)
        clock["t"] += 0.75
        got, want = (m.summary() for m in metres)
        assert got == want and set(got) == {"images_per_sec", "images_per_sec_per_chip", "seconds", "count"}


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(16, 16) @ torch.ones(16, 16)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
