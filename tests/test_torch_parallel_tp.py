"""The (data, model) grid on 4 real ranks: the port's column-parallel
classifier head and its dry run, on the CPU.

Four processes under gloo on 127.0.0.1 (tests/torch_parallel_worker.py
`tp`) start once for the file and make the (2, 2) mesh: rank r at data
index r // 2 and model index r % 2, as JAX's make_mesh lays 4 devices.
They take 2 f64 steps at lr 1e-6 on tests/test_torch_train_step.py's
batches and injected global draws (ResNet-50, 64^2, M 4, 8 classes, global
batch 8: 4 rows a data index), from one flax TrainState, with fc's 8
classes split 4 and 4 over the model axis (parallel/head.py::shard_head).
Rank 0 then takes the same steps in one process.  Bounds:
  * against the port's one process, every step: loss, batch stats, feature
    centers and the reassembled fc and its momentum within 1e-9 of each
    tensor's largest entry, the gradient sgd_update takes within 1e-9
    (relative norm of the flat gradient, fc's reassembled, as the smoke's
    dp phase reads it);
  * after the last step, every rank's replicated params, momentum, buffers
    and feature centers bit-equal to rank 0's, and each fc shard (and its
    momentum) bit-equal over the two data ranks of its model index;
  * step 1 against JAX's step with the dry run's sharding
    (__graft_entry__.py:103-108: fc/kernel on P(None, "model"), everything
    else replicated, the batch on P("data")) applied here on a (2, 2) mesh
    of 4 of conftest's CPU devices: the top-k counts equal, loss, stats and
    centers within 1e-9, params 1e-6 and momentum 1e-5
    (tests/test_torch_parallel_train.py's bounds).
Then Trainer(mesh=(2, 2)) in f64, every rank but rank 0 from another seed:
one epoch of one global batch of 4 through InputPipeline(mesh=...), its
evaluation and its best checkpoint, against the same in one process on
rank 0: each rank's batch the one-process batch's rows of its data index,
the epoch's and the evaluation's loss within 1e-9 and their accuracies
equal (the counts over the data group, over 4 images), feature centers and
stats within 1e-9, params 1e-6 and momentum 1e-5, the state bit-equal on
all 4 ranks (replicated() over the model axis too), and only rank 0's
checkpoint written, holding its params.
Then dryrun_multichip(4) on the ranks: JAX's three "dryrun_multichip OK"
lines on rank 0, stage 2's gathered images byte-equal to one process's (2
rows a data index), stage 3's logits of 13 images within 1e-6 of the
largest of one process's (batches of 8 on the (4, 1) mesh: 4, 4, 3 and 2
rows scored by ranks 0-3).  Last, `python -m saspa_tpu_torch.dryrun --device
cpu --skip_entry` under torchrun's launcher on 4 CPU ranks (≈ 12 s) prints
the same three lines once.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

from saspa_tpu.parallel import make_mesh, shard_batch
from tests.test_torch_train_step import (BATCHES, IMG, LR, M, NUM_CLASSES, B, _batch, _draws, _flax_sd, _port_draws,
                                         _rel, _Run)
from tests.torch_parallel_worker import REPO, Ranks

STEPS = 2
TRAINER_B, TRAINER_CLASSES = 4, 4


def _trainer_files(d: Path) -> dict:
    """One global batch of 4 images (2 rows a data index) for the Trainer's
    epoch, evaluated on the same files."""
    rng = np.random.RandomState(11)
    files = []
    for i in range(TRAINER_B):
        p = d / "trainer_imgs" / f"{i}.png"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (70 + i % 3 * 9, 84, 3), np.uint8)).save(p)
        files.append(str(p))
    return {"files": files, "labels": [i % TRAINER_CLASSES for i in range(TRAINER_B)],
            "classes": [f"c{k}" for k in range(TRAINER_CLASSES)],
            "cfg": dict(image_size=(IMG, IMG), net="resnet50", batch_size=TRAINER_B, num_attentions=M,
                        compute_dtype="float32", learning_rate=LR)}


def _dryrun_sharding(mesh, state):
    """__graft_entry__.py:100-116's shard_param and replication, on `state`."""
    rep = NamedSharding(mesh, P())

    def shard_param(path, x):
        name = "/".join(str(p.key) for p in path if hasattr(p, "key"))
        if name.endswith("fc/kernel") and x.shape[-1] % 2 == 0:
            return jax.device_put(x, NamedSharding(mesh, P(None, "model")))
        return jax.device_put(x, rep)

    return state.replace(params=jtu.tree_map_with_path(shard_param, state.params),
                         batch_stats=jax.device_put(state.batch_stats, rep),
                         opt_state=jax.device_put(state.opt_state, rep),
                         feature_center=jax.device_put(state.feature_center, rep),
                         step=jax.device_put(state.step, rep))


def _jax_step_one(run, data, draws):
    with jax.enable_x64(True):
        mesh = make_mesh((2, 2), devices=jax.devices()[:4])
        state = _dryrun_sharding(mesh, run.state0)
        fc = state.params["fc"]["kernel"]
        assert fc.sharding.spec == P(None, "model") and fc.addressable_shards[0].data.shape == (fc.shape[0], 4)
        (X, y), d = data, draws
        sharded = shard_batch(mesh, {"X": X.astype(np.float64), "y": y})
        dj = {k: jnp.asarray(v.astype(np.float64) if v.dtype.kind == "f" else v) for k, v in d.items()}
        state, m = run.step(state, sharded["X"], sharded["y"], jax.random.PRNGKey(0), draws=dj)
        return jax.device_get(state), jax.device_get(m)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    run = _Run(f64=True)
    data = [_batch(s, BATCHES["duplicate_labels"]) for s in range(STEPS)]
    draws = [_draws(s) for s in range(STEPS)]
    state = run.port_state()
    f64 = torch.float64
    torch.save({"state_dict": state.model.state_dict(), "feature_center": state.feature_center,
                "num_classes": NUM_CLASSES, "M": M, "net": "resnet50",
                "cfg": dict(image_size=(IMG, IMG), net="resnet50", batch_size=B, num_attentions=M,
                            compute_dtype="float32", learning_rate=LR),
                "batches": [(torch.from_numpy(X).permute(0, 3, 1, 2).to(f64).contiguous(), torch.from_numpy(y).long(),
                             _port_draws(dr, f64)) for (X, y), dr in zip(data, draws)],
                "keys": [np.asarray(jax.random.PRNGKey(s), np.uint32) for s in range(STEPS)],
                "trainer": _trainer_files(d)},
               d / "train_in.pt")
    del state
    ranks = Ranks("tp", d, world=4, timeout=240)  # runs while JAX steps
    want = _jax_step_one(run, data[0], draws[0])
    return {"ranks": ranks.results(), "logs": ranks.log_texts(), "jax": want, "dir": d}


def test_ranks_sit_on_jaxs_grid(tp):
    assert [r["coords"] for r in tp["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_head_steps_match_the_one_process_step(tp):
    ranks = tp["ranks"]
    one = ranks[0]["one_steps"]
    assert len(ranks[0]["grad_rel"]) == STEPS and max(ranks[0]["grad_rel"]) <= 1e-9, ranks[0]["grad_rel"]
    for r, got in enumerate(ranks):
        for s, (row, want) in enumerate(zip(got["steps"], one)):
            assert row["step"] == want["step"] == s + 1
            for k in ("raw_correct", "aug_correct", "aux_correct"):
                assert row["metrics"][k].tolist() == want["metrics"][k].tolist(), (r, s, k)
            assert _rel(row["metrics"]["loss"].item(), want["metrics"]["loss"].item()) <= 1e-9, (r, s)
            for k in ("feature_center", "fc", "fc_momentum"):
                assert _rel(row[k], want[k]) <= 1e-9, (r, s, k)
            assert row["fc"].shape == (NUM_CLASSES, M * 2048)
            assert max(_rel(row["batch_stats"][k], v) for k, v in want["batch_stats"].items()) <= 1e-9, (r, s)


def test_replicated_state_is_bit_equal_and_fc_shards_equal_over_the_data_ranks(tp):
    ranks = tp["ranks"]
    assert all(r["bit_diffs"] == {"replicated": 0.0, "shard": 0.0} for r in ranks), [r["bit_diffs"] for r in ranks]
    shards = [r["shard"] for r in ranks]
    assert all(s.shape == (NUM_CLASSES // 2, M * 2048) for s in shards)
    assert torch.equal(shards[0], shards[2]) and torch.equal(shards[1], shards[3])
    assert not torch.equal(shards[0], shards[1])
    assert torch.equal(torch.cat([shards[0], shards[1]]), ranks[0]["steps"][-1]["fc"])


def test_step_one_matches_jaxs_step_under_the_dry_runs_sharding(tp):
    js, jm = tp["jax"]
    params, moms = _flax_sd(js.params), _flax_sd(js.opt_state[1].trace)
    for r, got in enumerate(tp["ranks"]):
        row = got["steps"][0]
        assert row["step"] == int(js.step) == 1
        for k in ("raw_correct", "aug_correct", "aux_correct"):
            assert row["metrics"][k].tolist() == np.asarray(jm[k]).tolist(), (r, k)
        assert _rel(row["metrics"]["loss"].item(), jm["loss"]) <= 1e-9, r
        assert _rel(row["feature_center"], js.feature_center) <= 1e-9, r
        stats = _flax_sd(js.batch_stats)
        assert max(_rel(row["batch_stats"][k], v) for k, v in stats.items()) <= 1e-9, r
        assert _rel(row["fc"], params["fc.kernel"]) <= 1e-6, r
    row = tp["ranks"][0]["steps"][0]
    assert max(_rel(row["params"][k], v) for k, v in params.items()) <= 1e-6
    assert max(_rel(row["momentum"][k], v) for k, v in moms.items()) <= 1e-5


def test_trainer_on_the_grid_matches_one_process(tp):
    ranks, one = tp["ranks"], tp["ranks"][0]["trainer_one"]
    assert one["step"] == 1 and one["saved"] and tuple(one["X"].shape) == (TRAINER_B, 3, IMG, IMG)
    for r, got in enumerate(ranks):
        t = got["trainer"]
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)  # the data index's rows, the same on its model ranks
        assert torch.equal(t["X"], one["X"][rows]) and torch.equal(t["y"], one["y"][rows]), r
        assert t["step"] == 1 and t["train"]["steps"] == 1 and t["saved"], r
        assert t["max_diff_from_rank0"] == 0.0, r  # replicated() over different seeds, then bit-equal steps
        assert _rel(t["train"]["train_loss"], one["train"]["train_loss"]) <= 1e-9, r
        for k in ("train_raw_acc", "train_aug_acc", "train_aux_acc"):
            assert t["train"][k] == one["train"][k], (r, k)
        assert _rel(t["val"]["val_loss"], one["val"]["val_loss"]) <= 1e-9, r
        for k in ("val_topk_accuracy", "val_mean_class_acc", "val_acc_per_class"):
            assert t["val"][k] == one["val"][k], (r, k)
        assert _rel(t["feature_center"], one["feature_center"]) <= 1e-9, r
        assert max(_rel(v, one["batch_stats"][k]) for k, v in t["batch_stats"].items()) <= 1e-9, r
    got = ranks[0]["trainer"]
    assert max(_rel(v, one["params"][k]) for k, v in got["params"].items()) <= 1e-6
    assert max(_rel(v, one["momentum"][k]) for k, v in got["momentum"].items()) <= 1e-5
    d = tp["dir"]
    assert sorted(p.name for p in d.glob("trainer_best_*.pt")) == ["trainer_best_0.pt"]  # rank 0 alone writes
    ckpt = torch.load(d / "trainer_best_0.pt", weights_only=True)
    assert all(torch.equal(ckpt["params"][k], v.float()) for k, v in got["params"].items())


def test_dry_run_prints_jaxs_lines_and_its_stages_match_one_process(tp):
    ranks, logs = tp["ranks"], tp["logs"]
    for line in ("dryrun_multichip OK (train): mesh=(2, 2) loss=",
                 "dryrun_multichip OK (generation): mesh=(2, 2) batch=4 -> uint8 (4, 64, 64, 3)",
                 "dryrun_multichip OK (filter): mesh=(4, 1) scored=(13, 8) keep_conf="):
        assert [log.count(line) for log in logs] == [1, 0, 0, 0], line
    runs = [r["dryrun"] for r in ranks]
    losses = [run["train"]["loss"] for run in runs]
    assert np.isfinite(losses).all() and len(set(losses)) == 1 and all(run["train"]["step"] == 1 for run in runs)
    one = ranks[0]["one"]
    assert [run["generation"]["rows"] for run in runs] == [2, 2, 2, 2] and one["generation"]["rows"] == 4
    for run in runs:
        assert torch.equal(run["generation"]["images"], one["generation"]["images"])
    assert [run["filter"]["scored"] for run in runs] == [4, 4, 3, 2] and one["filter"]["scored"] == 13
    want = one["filter"]["logits"]
    for run in runs:
        assert np.abs(run["filter"]["logits"] - want).max() <= 1e-6 * np.abs(want).max()
        assert np.array_equal(run["filter"]["keep_conf"], one["filter"]["keep_conf"])
        assert np.array_equal(run["filter"]["keep_sem"], one["filter"]["keep_sem"])


def test_the_dryrun_module_under_torchrun_prints_jaxs_lines():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4", "-m",
                          "saspa_tpu_torch.dryrun", "--device", "cpu", "--skip_entry"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    for line in ("dryrun_multichip OK (train): mesh=(2, 2) loss=",
                 "dryrun_multichip OK (generation): mesh=(2, 2) batch=4 -> uint8 (4, 64, 64, 3)",
                 "dryrun_multichip OK (filter): mesh=(4, 1) scored=(13, 8) keep_conf="):
        assert run.stdout.count(line) == 1, (line, run.stdout[-2000:])
    assert "entry OK" not in run.stdout
