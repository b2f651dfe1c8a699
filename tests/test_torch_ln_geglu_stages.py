"""K2 (LayerNorm + GEGLU feed-forward) as three stages, and the launch plans
of K2 and K4, on the CPU.

On the card K2 runs as K4's row-normalize writing xn, xn W1^T with the GEGLU
epilogue writing hid, and hid W2^T with the residual epilogue.  Here the
plain mirror of those stages (`ln_geglu_staged_plain`) is held bit-equal to
the plain K2 and close to the JAX Pallas kernel in interpret mode, and the
host-side launch plans are checked by replaying the kernels' index
arithmetic: every column and row is covered exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.ops import geglu as jgeglu
from saspa_tpu_torch.ops import geglu as tgeglu
from saspa_tpu_torch.ops import layernorm as tln

H100_SMS = 132
GG_BM, GG_BN_UP = 128, 64  # csrc/ln_geglu.cu: rows a block of either product, hidden columns of the first


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _inputs(b, l, c, seed):
    rng = np.random.RandomState(seed)
    f = 4 * c
    return dict(
        x=rng.randn(b, l, c).astype(np.float32),
        lns=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
        lnb=(0.1 * rng.randn(c)).astype(np.float32),
        w1=(rng.randn(c, 2 * f) / np.sqrt(c)).astype(np.float32),  # flax (in, out)
        b1=(0.1 * rng.randn(2 * f)).astype(np.float32),
        w2=(rng.randn(f, c) / np.sqrt(f)).astype(np.float32),
        b2=(0.1 * rng.randn(c)).astype(np.float32),
    )


def _torch_args(p, dtype):
    t = torch.from_numpy
    return (t(p["x"]).to(dtype), t(p["lns"]), t(p["lnb"]), t(p["w1"].T.copy()).to(dtype), t(p["b1"]).to(dtype),
            t(p["w2"].T.copy()).to(dtype), t(p["b2"]).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,c", [(2, 64, 64), (1, 96, 128), (1, 37, 320), (3, 5, 64)])
def test_staged_plain_is_bit_equal_to_fused_plain(dtype, b, l, c):
    """The three stages round where the fused plain version rounds: equal
    bit for bit, ragged row counts (37, 15) included."""
    args = _torch_args(_inputs(b, l, c, seed=c + l), dtype)
    staged = tgeglu.ln_geglu_staged_plain(*args)[2]
    fused = tgeglu.fused_ln_geglu_plain(*args)
    assert staged.dtype == fused.dtype == dtype and staged.shape == fused.shape
    assert torch.equal(staged, fused)


def test_stage_wrapper_on_cpu_runs_the_plain_stages():
    """ln_geglu_stages on CPU tensors launches nothing and returns the plain
    stages in the kernels' layout: xn (M, C) is K4's plain normalize, hid
    (M, F) the plain hidden of xn, out like x."""
    args = _torch_args(_inputs(2, 20, 64, seed=3), torch.bfloat16)
    before = tgeglu.launches
    xn, hid, out = tgeglu.ln_geglu_stages(*args)
    assert tgeglu.launches == before
    assert xn.shape == (40, 64) and hid.shape == (40, 256) and out.shape == (2, 20, 64)
    assert torch.equal(xn, tln.layer_norm_one_pass_plain(*args[:3]).reshape(40, 64))
    assert torch.equal(hid, tgeglu.geglu_hidden_plain(xn, args[3], args[4]))
    assert torch.equal(out, tgeglu.fused_ln_geglu_plain(*args))


@pytest.mark.parametrize("b,l,c", [(2, 128, 64), (1, 64, 128), (1, 100, 64)])
def test_staged_plain_matches_pallas_interpret_bf16(b, l, c):
    """bf16, with the tolerance of the fused plain version's own test
    (tests/test_torch_ops.py): same rounding points, f32 summation order of
    the products differs, which can flip a bf16 rounding of the hidden or
    the output: max |diff| <= 2 bf16 ulps of the output's range (0.0625 at
    |out| < 8) and mean |diff| < 2e-3."""
    p = _inputs(b, l, c, seed=c + 1)
    got = _np(tgeglu.ln_geglu_staged_plain(*_torch_args(p, torch.bfloat16))[2])
    j = {k: jnp.asarray(v) for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        want = _np(jgeglu.fused_ln_geglu(j["x"].astype(jnp.bfloat16), j["lns"], j["lnb"], j["w1"], j["b1"],
                                         j["w2"], j["b2"]))
    assert np.abs(want).max() < 8
    assert np.abs(got - want).max() <= 0.0625
    assert np.abs(got - want).mean() < 2e-3


# ---- launch plans -----------------------------------------------------------------

ROWS = sorted(set(range(1, 300)) | {511, 512, 513, 1000, 1024, 4095, 4096, 4097, 16383, 16384, 16385, 65535,
                                    65536, 65537, 69999, 70000})


def _ln_plan_rows(plan, m):
    """How many times the kernel's grid-stride loop visits each of m rows."""
    nwarps = plan.blocks * tln.LN_THREADS // 32
    rpw = 32 // plan.lanes
    sweeps = -(-m // (nwarps * rpw))
    r0 = (np.arange(nwarps)[:, None] + nwarps * np.arange(sweeps)[None, :]).ravel() * rpw
    r0 = r0[r0 < m]  # the loop's condition
    rows = (r0[:, None] + np.arange(rpw)[None, :]).ravel()
    return np.bincount(rows[rows < m], minlength=m)  # the `on` mask


def test_ln_plan_covers_every_column_once():
    """Every C % 8 == 0 up to 2048: lane li of a row holds vectors li + j *
    lanes (j < vecs) below C / 8, every vector of the row is held by exactly
    one lane, no lane is without one, and only the last round has idle
    slots.  At the UNet's 320, 640, 1280: 5 vectors on 8, 16, 32 lanes."""
    for c in range(8, tln.LN_MAX_C + 1, 8):
        nv = c // 8
        plan = tln.ln_plan(1000, c, H100_SMS)
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and 1 <= plan.vecs <= tln.LN_MAXV, (c, plan)
        idx = np.arange(plan.lanes)[:, None] + plan.lanes * np.arange(plan.vecs)[None, :]
        assert np.array_equal(np.sort(idx[idx < nv]), np.arange(nv)), (c, plan)
        assert (idx[:, 0] < nv).all(), (c, plan)  # every lane holds a vector
        assert plan.lanes * plan.vecs - nv < plan.lanes, (c, plan)
    for c, lanes in ((320, 8), (640, 16), (1280, 32)):
        assert tln.ln_plan(1000, c, H100_SMS)[:2] == (lanes, 5)


@pytest.mark.parametrize("c", [8, 64, 320, 640, 1000, 1280, 2048])
def test_ln_plan_covers_every_row_once(c):
    """Rows 1-70,000: the grid-stride loop visits every row exactly once,
    with at most LN_BLOCKS_PER_SM blocks an SM and no block without rows."""
    for m in ROWS:
        plan = tln.ln_plan(m, c, H100_SMS)
        assert (_ln_plan_rows(plan, m) == 1).all(), (m, plan)
        rows_per_block = tln.LN_THREADS // 32 * (32 // plan.lanes)
        assert 1 <= plan.blocks <= H100_SMS * tln.LN_BLOCKS_PER_SM
        assert (plan.blocks - 1) * rows_per_block < m


def test_geglu_plan_tiles_cover_every_column_once():
    """Every C % 64 == 0 up to 2048, F = 4C: the first product's 64-column
    tiles read W1's value rows n0.. and gate rows F + n0.. so that each of
    the 2F rows is read by exactly one tile; the second product's N tile
    (160 where it divides C, else 64) covers C's columns exactly once; the
    128-row blocks cover M's rows, the ragged last block masked; the
    persistent blocks (two an SM, no more than tiles) visit every tile of
    either product once, block b the `mine` tiles b, b + grid, ..."""
    for c in range(64, tln.LN_MAX_C + 1, 64):
        f = 4 * c
        plan = tgeglu.geglu_plan(1000, c, H100_SMS)
        assert plan.ln == tln.ln_plan(1000, c, H100_SMS)
        assert plan.bn_down == (160 if c % 160 == 0 else 64), c
        n0 = np.arange(0, f, GG_BN_UP)
        w1_rows = np.concatenate([n0[:, None] + np.arange(GG_BN_UP), f + n0[:, None] + np.arange(GG_BN_UP)])
        assert np.array_equal(np.sort(w1_rows.ravel()), np.arange(2 * f)), c
        out_cols = (np.arange(c // plan.bn_down)[:, None] * plan.bn_down + np.arange(plan.bn_down)).ravel()
        assert np.array_equal(np.sort(out_cols), np.arange(c)), c
        for m in (1, 96, 127, 128, 129, 200, 4096, 65536, 70000):
            blocks = -(-m // GG_BM)
            rows = (np.arange(blocks)[:, None] * GG_BM + np.arange(GG_BM)).ravel()
            assert np.array_equal(rows[rows < m], np.arange(m)), (c, m)
            for nt in (f // GG_BN_UP, c // plan.bn_down):
                ntiles = nt * blocks
                grid = min(ntiles, 2 * H100_SMS)
                walks = [range(b, ntiles, grid) for b in range(grid)]
                assert all(len(w) == (ntiles - b + grid - 1) // grid for b, w in enumerate(walks)), (c, m, nt)
                assert np.array_equal(np.sort(np.concatenate(walks)), np.arange(ntiles)), (c, m, nt)
