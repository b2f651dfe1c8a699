"""The port's (data, model) grid and dry-run entry points on one process,
on the CPU (the 4-rank runs are tests/test_torch_parallel_tp.py).

The grid's coordinates and rows against JAX's make_mesh((2, 2)) on 4 of
conftest's CPU devices; what make_mesh refuses; where shard_head shards
(JAX's rule: a model axis above 1 and a class count it divides) and that
replicated() refuses a sharded model; `make_denoise_step`, entry()'s
helper, at the tiny UNet config of tests/test_torch_pipeline.py against
JAX's denoise_step (__graft_entry__.py:41-50, copied here: it is local to
entry()) with the tiny pipeline's params carried over by the bridge, f32,
within 1e-4 of the largest output (tests/test_torch_models.py's UNet
tolerance); the entry points' refusal without a card; and `python -m
saspa_tpu_torch.dryrun` on one CPU process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from saspa_tpu.parallel import make_mesh as j_make_mesh
from saspa_tpu_torch import dryrun, parallel
from saspa_tpu_torch.bridge import params_from_flax
from saspa_tpu_torch.models.layers import Dense
from saspa_tpu_torch.parallel import ColumnParallelDense, Mesh, shard_head
from tests.test_torch_pipeline import P_UNET, _close, pipes  # noqa: F401  (pipes: fixture)

AXES = ("data", "model")
CPU = torch.device("cpu")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_grid_coordinates_and_rows_equal_jaxs_device_grid(shape):
    devices = jax.devices()[:4]
    jmesh = j_make_mesh(shape, devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jmesh.devices)
    rows = NamedSharding(jmesh, P("data")).devices_indices_map((8,))
    for r in range(4):
        mesh = Mesh(shape, AXES, r, CPU)
        assert (mesh.data_size, mesh.model_size) == shape
        assert [tuple(c) for c in np.argwhere(ids == r)] == [(mesh.data_index, mesh.model_index)]
        assert range(8)[mesh.rows(8)] == range(8)[rows[devices[r]][0]]


def test_make_mesh_refuses_a_shape_that_is_not_the_group():
    for shape in [(2, 2), (4, 1), (1, 3), ()]:
        with pytest.raises(ValueError, match="ranks"):
            parallel.make_mesh(shape)
    mesh = parallel.make_mesh((1, 1))
    assert (mesh.data_index, mesh.model_index, mesh.rows(5)) == (0, 0, slice(0, 5))
    assert parallel.data_group(mesh) is None and parallel.model_group(mesh) is None
    with pytest.raises(RuntimeError, match="make_mesh"):  # a grid's groups come from make_mesh only
        parallel.data_group(Mesh((2, 2), AXES, 1, CPU))


def _head(classes, features=16):
    model = torch.nn.Module()
    model.fc = Dense(features, classes, bias=False, param_dtype=torch.float32)
    with torch.no_grad():
        model.fc.kernel.copy_(torch.arange(classes * features, dtype=torch.float32).view(classes, features))
    return model


def test_shard_head_shards_where_jax_does():
    # dtd's 47 classes stay whole on 2 model ranks, and any head on a model axis of 1
    for classes, shape in [(47, (2, 2)), (8, (4, 1)), (100, (1, 1))]:
        model = _head(classes)
        fc = model.fc
        assert shard_head(model, Mesh(shape, AXES, shape[0] * shape[1] - 1, CPU)).fc is fc
    for rank, rows in [(0, slice(0, 24)), (1, slice(24, 48)), (2, slice(0, 24)), (3, slice(24, 48))]:
        model = _head(48)
        whole = model.fc.kernel.detach().clone()
        momentum = {"fc.kernel": whole + 1.0, "other": torch.ones(3)}
        shard_head(model, Mesh((2, 2), AXES, rank, CPU), momentum)
        assert isinstance(model.fc, ColumnParallelDense) and model.fc.out_features == 48
        assert dict(model.named_parameters()).keys() == {"fc.kernel"}
        assert torch.equal(model.fc.kernel, whole[rows]) and torch.equal(momentum["fc.kernel"], whole[rows] + 1.0)
        assert momentum["other"].shape == (3,)
        with pytest.raises(ValueError, match="replicate before shard_head"):
            parallel.replicated(Mesh((2, 2), AXES, rank, CPU), model)
    biased = torch.nn.Module()
    biased.fc = Dense(16, 48)
    with pytest.raises(ValueError, match="without a bias"):
        shard_head(biased, Mesh((2, 2), AXES, 0, CPU))


def _jax_denoise_step(jp, params, latents, t, ctx, cond_img):
    """__graft_entry__.py:41-50."""
    down_res, mid_res = jp.controlnet.apply({"params": params["controlnet"]}, latents, t, ctx, cond_img, 0.75)
    return jp.unet.apply({"params": params["unet"]}, latents, t, ctx, down_block_additional_residuals=down_res,
                         mid_block_additional_residual=mid_res)


def test_denoise_step_matches_jaxs_at_a_tiny_unet(pipes):
    jp, _, params = pipes
    fn, (mods, latents, t, ctx, cond) = dryrun.make_denoise_step(P_UNET, torch.float32, "cpu", latent_hw=16,
                                                                 control_hw=128)
    assert (tuple(latents.shape), tuple(t.shape), tuple(ctx.shape), tuple(cond.shape)) == \
        ((2, 16, 16, 4), (2,), (2, 77, 16), (2, 128, 128, 3))
    assert not any(a.any() for a in (latents, t, ctx, cond))  # zeros, as JAX's
    sds = params_from_flax({"unet": params["unet"], "controlnet": params["controlnet"]})
    for name in ("unet", "controlnet"):
        mods[name].load_state_dict(sds[name], strict=True)
    rng = np.random.RandomState(5)
    lat = rng.randn(2, 16, 16, 4).astype(np.float32)
    steps = np.array([501, 301], np.int32)
    text = rng.randn(2, 77, 16).astype(np.float32)
    cimg = (rng.rand(2, 128, 128, 3) > 0.9).astype(np.float32)
    jparams = {"unet": jp.params["unet"], "controlnet": jp.params["controlnet"]}
    want = jax.jit(lambda p, *a: _jax_denoise_step(jp, p, *a))(jparams, jnp.asarray(lat), jnp.asarray(steps),
                                                                jnp.asarray(text), jnp.asarray(cimg))
    got = fn(mods, torch.from_numpy(lat), torch.from_numpy(steps).long(), torch.from_numpy(text),
             torch.from_numpy(cimg))
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1)


def test_dryrun_module_on_one_cpu_process_prints_jaxs_three_lines(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        assert dryrun.main(["--device", "cpu", "--skip_entry"]) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    for line in ("dryrun_multichip OK (train): mesh=(1, 1) loss=",
                 "dryrun_multichip OK (generation): mesh=(1, 1) batch=1 -> uint8 (1, 64, 64, 3)",
                 "dryrun_multichip OK (filter): mesh=(1, 1) scored=(4, 8) keep_conf="):
        assert out.count(line) == 1, (line, out)
    assert "entry OK" not in out
