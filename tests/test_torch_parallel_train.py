"""The port's data-parallel train step on 2 real ranks against the JAX
package's step sharded over its 8-device CPU mesh, in f64.

tests/test_train_step.py's sharded setup (make_mesh(), replicated,
shard_batch) on JAX's side; on the port's, two processes under gloo on
127.0.0.1 (tests/torch_parallel_worker.py), each taking its 4 rows of the
global batch of 8.  Both start from one flax TrainState and take 3 steps at
lr 1e-6 on tests/test_torch_train_step.py's batches (labels repeated:
class 3 four times, across both ranks) with the same injected global draws,
at its size (ResNet-50, 64^2, M 4, 8 classes): ≈ 65-70 s, nearly all of
it JAX's three f64 steps on 8 virtual devices (≈ 11 s each) and their
first trace, which the ranks overlap.  Smaller images do not hold the
bounds: at 32^2 the feature centers reach 1.1e-9 of the largest, and at
48^2 the one-process port against JAX's one-device step already reaches
2e-8 at the third step.  Bounds are that file's:
over every step the top-k counts are equal and loss, batch_stats and
feature centers agree to 1e-9 of each tensor's largest entry; after the
last step the params agree to 1e-6 and the momentum to 1e-5 (an earlier
step's error would carry into them: both integrate every gradient), and
rank 1's params, momentum and buffers equal rank 0's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from saspa_tpu.parallel import make_mesh, replicated, shard_batch
from tests.test_torch_train_step import (BATCHES, IMG, LR, M, NUM_CLASSES, STEPS, B, _batch, _draws, _flax_sd,
                                         _port_draws, _rel, _Run)
from tests.torch_parallel_worker import Ranks


def _jax_sharded_steps(run, data, draws):
    out = []
    with jax.enable_x64(True):
        mesh = make_mesh()
        assert mesh.devices.size == 8
        state = jax.device_put(run.state0, replicated(mesh))
        for s, ((X, y), d) in enumerate(zip(data, draws)):
            sharded = shard_batch(mesh, {"X": X.astype(np.float64), "y": y})
            dj = {k: jnp.asarray(v.astype(np.float64) if v.dtype.kind == "f" else v) for k, v in d.items()}
            state, m = run.step(state, sharded["X"], sharded["y"], jax.random.PRNGKey(s), draws=dj)
            out.append((jax.device_get(state), jax.device_get(m)))
    return out


def test_two_ranks_match_jaxs_step_on_its_8_device_mesh(tmp_path):
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
                             _port_draws(d, f64)) for (X, y), d in zip(data, draws)],
                "keys": [np.asarray(jax.random.PRNGKey(s), np.uint32) for s in range(STEPS)]},
               tmp_path / "train_in.pt")
    ranks = Ranks("train_injected", tmp_path, world=2)  # runs while JAX steps
    want = _jax_sharded_steps(run, data, draws)
    got = ranks.results()

    assert got[1]["max_diff_from_rank0"] == 0.0
    for rank in (0, 1):
        for s, (row, (js, jm)) in enumerate(zip(got[rank]["steps"], want)):
            assert row["step"] == int(js.step) == s + 1
            m = row["metrics"]
            for k in ("raw_correct", "aug_correct", "aux_correct"):
                assert m[k].tolist() == np.asarray(jm[k]).tolist(), (rank, s, k)
            assert _rel(m["loss"].item(), jm["loss"]) <= 1e-9, (rank, s)
            assert _rel(row["feature_center"], js.feature_center) <= 1e-9, (rank, s)
            stats = _flax_sd(js.batch_stats)
            assert max(_rel(row["batch_stats"][k], v) for k, v in stats.items()) <= 1e-9, (rank, s)
    js = want[-1][0]
    params, moms = _flax_sd(js.params), _flax_sd(js.opt_state[1].trace)
    assert max(_rel(got[0]["params"][k], v) for k, v in params.items()) <= 1e-6
    assert max(_rel(got[0]["momentum"][k], v) for k, v in moms.items()) <= 1e-5
