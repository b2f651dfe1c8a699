"""Parity of the port's norm kernels' plain versions (K3 GroupNorm(+SiLU),
K4 one-pass LayerNorm) with the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX
Pallas kernels run in interpret mode (`pltpu.force_tpu_interpret_mode()`),
as the JAX package's own tests run them; the port's wrappers run their plain
versions on CPU tensors.  The port keeps the channels-first layout, JAX
channels-last: a permute between them moves no value.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.ops import groupnorm as jgn
from saspa_tpu.ops.layernorm import layer_norm_one_pass as j_layer_norm_one_pass
from saspa_tpu_torch.models import controlnet as t_cn
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.ops import groupnorm as tgn
from saspa_tpu_torch.ops import layernorm as tln


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _gn_inputs(b, hw, c, seed):
    rng = np.random.RandomState(seed)
    x = (0.5 + 3.0 * rng.randn(b, hw, c)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.2 * rng.randn(c)).astype(np.float32)
    return x, gamma, beta


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude (8 bits of mantissa)."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    return np.abs(got - want) / (2.0 ** (np.floor(np.log2(mag)) - 7))


# ---- K3: the TPU kernel's numerics ----------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,n_split", [(64, 1), (320, 1), (256, 2)])
def test_group_norm_tpu_plain_matches_pallas_interpret(dtype, act, c, n_split):
    """group_norm_tpu_plain vs _gn_pallas(bf16_norm=True), 32 groups, whole
    groups per channel split.  f32: to 2e-5 of the largest output (sum order
    of the statistics).  bf16: the same bf16 rounding after every op; a
    different f32 sum order of the statistics or rsqrt's last bit can move
    bf16(scale) or bf16(shift) by one ulp, which moves the outputs of that
    channel by an ulp or two: >= 99.9% of elements equal, all within 2 ulps
    (all equal at these inputs)."""
    b, hw, groups = 2, 64, 32
    x, gamma, beta = _gn_inputs(b, hw, c, seed=c + n_split)
    jdt = getattr(jnp, dtype)
    cblk, gblk = c // n_split, groups // n_split
    onehot = jnp.asarray(np.repeat(np.eye(gblk, dtype=np.float32), c // groups, axis=0))
    with pltpu.force_tpu_interpret_mode():
        want = jgn._gn_pallas(jnp.asarray(x).astype(jdt), jnp.asarray(gamma).reshape(1, c),
                              jnp.asarray(beta).reshape(1, c), onehot, groups, 1e-5, act,
                              jgn._pick_chunk(hw, cblk), n_split, True)
    want = _np(want)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 2, 1).reshape(b, c, 8, 8)
    got = tgn.group_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5, act, tpu_numerics=True)
    assert got.dtype == xt.dtype
    got = _np(got.reshape(b, c, hw).permute(0, 2, 1))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
        return
    assert np.mean(got == want) >= 0.999
    assert _bf16_ulps(got, want).max() <= 2


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("n_split", [1, 2])
@pytest.mark.parametrize("c", [320, 640, 960, 256])
def test_group_norm_tpu_f32norm_plain_matches_pallas_interpret(c, n_split, act):
    """group_norm_tpu_plain(bf16_norm=False) vs _gn_pallas(bf16_norm=False)
    (SASPA_GN_FP32_NORM=1) on bf16 input, 32 groups (C/G = 10, 20, 30, 8),
    one or two programs a sample: the f32 normalize and SiLU round once, at
    the end.  The statistics' f32 sum order, rsqrt's and exp's last bits
    move the f32 result by a few f32 ulps of its terms, (|x| + |mean|)
    |gamma rstd| + |beta|, which can flip that rounding, or, where the terms
    cancel, move a small result by more of its own ulps: >= 99.9% of
    elements equal, all within 2 bf16 ulps of the terms' magnitude (SiLU's
    slope reaches 1.1)."""
    b, hw, groups = 2, 64, 32
    x, gamma, beta = _gn_inputs(b, hw, c, seed=3 * c + n_split)
    gblk = groups // n_split
    onehot = jnp.asarray(np.repeat(np.eye(gblk, dtype=np.float32), c // groups, axis=0))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jgn._gn_pallas(xj, jnp.asarray(gamma).reshape(1, c), jnp.asarray(beta).reshape(1, c), onehot,
                                  groups, 1e-5, act, jgn._pick_chunk(hw, c // n_split), n_split, False))
    xt = torch.from_numpy(_np(xj)).to(torch.bfloat16).permute(0, 2, 1).reshape(b, c, 8, 8)
    args = (torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5, act)
    got = tgn.group_norm(xt, *args, tpu_numerics=True, bf16_norm=False)
    assert got.dtype == torch.bfloat16
    got = _np(got.reshape(b, c, hw).permute(0, 2, 1))
    assert np.mean(got == want) >= 0.999
    xg = _np(xj).reshape(b, hw, groups, -1)
    mean = xg.mean((1, 3))
    rstd = 1.0 / np.sqrt((xg * xg).mean((1, 3)) - mean * mean + 1e-5)
    cg = c // groups
    mag = (np.abs(_np(xj)) + np.abs(np.repeat(mean, cg, 1))[:, None]) * np.abs(gamma * np.repeat(rstd, cg, 1))[:, None] \
        + np.abs(beta)
    m = np.maximum(np.maximum(mag, np.abs(want)), 2.0 ** -126)
    assert (np.abs(got - want) / 2.0 ** (np.floor(np.log2(m)) - 7)).max() <= 2
    bf16 = _np(tgn.group_norm(xt, *args, tpu_numerics=True).reshape(b, c, hw).permute(0, 2, 1))
    assert np.mean(bf16 != want) > 0.05  # the bf16 normalize is another function


def test_group_norm_tpu_numerics_differ_from_xla_order():
    """The two epilogues are different functions: the TPU numerics round the
    normalize in bf16, the default order rounds once."""
    x, gamma, beta = _gn_inputs(1, 64, 64, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 2, 1).reshape(1, 64, 8, 8)
    args = (torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5, "silu")
    tpu = tgn.group_norm(xt, *args, tpu_numerics=True)
    xla = tgn.group_norm(xt, *args)
    assert torch.equal(xla, tgn.group_norm_plain(xt, *args))
    assert not torch.equal(tpu, xla)
    assert (tpu.float() - xla.float()).abs().max() <= 0.05 * xla.float().abs().max()


# ---- K3: which sites the TPU numerics take (the split plan) ---------------------

def _gn_sites(monkeypatch):
    """(module, C, HW) of every GroupNorm call of one UNet step, one
    ControlNet step and one VAE decode at 512^2 (64^2 latents), traced on the
    meta device with every kernel wrapper replaced by a shape-only stand-in."""
    sites = []

    def gn_forward(self, x):
        sites.append((owner[0], x.shape[1], math.prod(x.shape[2:])))
        return x

    def same_shape(x, *args, **kwargs):
        return torch.empty_like(x)

    monkeypatch.setattr(t_unet.GroupNorm32, "forward", gn_forward)
    for mod, name in ((t_unet, "layer_norm_one_pass"), (t_unet, "fused_ln_geglu"),
                      (t_unet, "flash_attention_packed"), (t_vae, "flash_attention_packed")):
        monkeypatch.setattr(mod, name, same_shape)
    meta, bf = "meta", torch.bfloat16
    owner = ["controlnet"]
    lat = torch.empty(1, 4, 64, 64, device=meta)
    ctx = torch.empty(2, 77, 768, device=meta)
    down, mid = t_cn.ControlNet(dtype=bf, device=meta)(lat, 1, ctx, torch.empty(1, 320, 64, 64, device=meta))
    owner[0] = "unet"
    t_unet.UNet2DCondition(dtype=bf, device=meta)(lat, 1, ctx, down, mid)
    owner[0] = "vae"
    t_vae.AutoencoderKL(dtype=bf, device=meta).decode(lat)
    return sites


def test_split_plan_copy_matches_jax_on_every_512_site(monkeypatch):
    """The port's split_plan equals JAX's _split_plan (given shape and
    itemsize through jax.ShapeDtypeStruct) at every GroupNorm of the 512^2
    path, bf16; it refuses exactly the 7 GroupNorms of the VAE's 512^2 tail.
    Per step the UNet runs 61 GroupNorms and the ControlNet 27; a decode 30."""
    monkeypatch.delenv("SASPA_GN_MIN_SPLIT", raising=False)
    sites = _gn_sites(monkeypatch)
    counts = {k: sum(1 for s in sites if s[0] == k) for k in ("unet", "controlnet", "vae")}
    assert counts == {"unet": 61, "controlnet": 27, "vae": 30}
    refused = []
    for owner, c, hw in sites:
        for itemsize, jdt in ((2, jnp.bfloat16), (4, jnp.float32)):
            want = jgn._split_plan(jax.ShapeDtypeStruct((1, hw, c), jdt), 32)
            assert tgn.split_plan(hw, c, 32, itemsize) == want, (owner, c, hw, itemsize)
        if tgn.split_plan(hw, c, 32, 2) is None:
            refused.append((owner, c, hw))
    assert sorted(refused) == sorted([("vae", 256, 512 * 512)] + [("vae", 128, 512 * 512)] * 6)
    for hw, c in ((4, 64), (48, 64), (1, 8), (64 * 64, 320 * 64)):  # not a power of two, too small, too big
        assert tgn.split_plan(hw, c, 32, 2) == jgn._split_plan(jax.ShapeDtypeStruct((1, hw, c), jnp.bfloat16), 32)


def test_group_norm32_takes_tpu_numerics_where_the_plan_admits():
    """GroupNorm32(tpu_numerics=True) runs the TPU numerics at an admitted
    site and the default order where the plan refuses (HW not a power of two)."""
    m = t_unet.GroupNorm32(64, act="silu", tpu_numerics=True)
    torch.nn.init.normal_(m.GroupNorm_0.scale, 1.0, 0.2)
    for hw, tpu in (((8, 8), True), ((6, 6), False)):
        x = (2 + 3 * torch.randn(2, 64, *hw, generator=torch.Generator().manual_seed(0))).to(torch.bfloat16)
        p = m.GroupNorm_0
        plain = tgn.group_norm_tpu_plain if tpu else tgn.group_norm_plain
        assert torch.equal(m(x), plain(x, p.scale, p.bias, 32, 1e-5, "silu"))


# ---- K4: one-pass LayerNorm ----------------------------------------------------

@pytest.mark.parametrize("c", [320, 640, 1280])
def test_layer_norm_plain_matches_pallas_interpret(c):
    """layer_norm_one_pass (plain on the CPU) vs the JAX one-pass kernel.
    f32: rtol 2e-6 as the JAX package's own test.  bf16: the same bf16
    rounding after each op; XLA's rsqrt and f32 sum order differ from
    torch's in the last f32 bit, which flips a bf16 rounding on rare
    elements: >= 99.9% equal, the rest within 1 ulp.  C = 320 runs here
    too (the JAX predicate admits only multiples of 128, the function is
    the same)."""
    rng = np.random.RandomState(c)
    x = (0.5 + 3.0 * rng.randn(2, 64, c)).astype(np.float32)
    s = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.2 * rng.randn(c)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        with pltpu.force_tpu_interpret_mode():
            want = _np(j_layer_norm_one_pass(xj, jnp.asarray(s), jnp.asarray(b), 1e-5))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        out = tln.layer_norm_one_pass(xt, torch.from_numpy(s), torch.from_numpy(b), 1e-5)
        assert out.dtype == xt.dtype
        got = _np(out)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
        else:
            assert np.mean(got == want) >= 0.999
            assert _bf16_ulps(got, want).max() <= 1


def test_layer_norm32_is_the_one_pass_function():
    """The default path's _ln32_forward is K4's plain version, and
    LayerNorm32 goes through the K4 wrapper."""
    assert t_unet._ln32_forward is tln.layer_norm_one_pass_plain
    m = t_unet.LayerNorm32(64)
    torch.nn.init.normal_(m.scale, 1.0, 0.2)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    assert torch.equal(m(x), tln.layer_norm_one_pass_plain(x, m.scale, m.bias, 1e-5))


def test_norm_inputs_are_in_a_layout_the_kernels_take():
    """The kernels take dense inputs and raise on others; on the CPU the plain
    versions take any layout, so this test holds the layout: every GroupNorm
    input of a tiny canny generation and of a canny SDEdit generation (the
    VAE encoder's norms too, behind its bottom/right padding), in both
    kernel configurations, is a 4-d channels-last tensor (the UNet,
    ControlNet and VAE run channels-last from the latents and the image on),
    and every LayerNorm input is contiguous."""
    from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _ids, _inputs
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline

    seen, encoder_norms = [], set()

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, t_unet.GroupNorm32):
            dense = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        else:
            dense = x.is_contiguous()
        seen.append(dense)
        encoder_norms.discard(id(mod))

    src, lat = _inputs(5)
    ids, neg = _ids()
    for options in ({}, {"pallas_group_norm": True, "attention_megakernel": True}):
        tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=3,
                               unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT, **options)
        for key in ("unet", "controlnet", "vae"):
            for m in tp.params[key].modules():
                if isinstance(m, (t_unet.GroupNorm32, t_unet.LayerNorm32)):
                    m.register_forward_pre_hook(hook)
        encoder_norms |= {id(m) for m in tp.params["vae"].encoder.modules() if isinstance(m, t_unet.GroupNorm32)}
        tp.make_fused_generate(32, 32, 2, 7.5)(tp.params, ids, neg, src, lat)
        tp.generate(["a", "b"], height=32, width=32, num_inference_steps=2, control_image=tp.control_from_src(
            src, 32, 32), init_image=torch.from_numpy(src).float() / 255.0, sdedit_strength=0.5, latents=lat,
            token_ids=ids, negative_token_ids=neg)
    assert len(seen) > 100 and all(seen) and not encoder_norms


# ---- K3 on the card: its launch plan and its sum order, replayed here --------

H100_SMS = 132
# HW of every GroupNorm on the main path: the UNet's and ControlNet's levels
# (8^2 .. 64^2 latents at 512^2, up to 128^2 at 1024^2) and the VAE's up to
# 512^2 and 1024^2
MAIN_PATH_HW = [s * s for s in (8, 16, 32, 64, 128, 256, 512, 1024)]


def test_gn_plan_covers_every_channel_once():
    """gn_plan for every C <= 4096 that is a whole number of 16-byte vectors
    (C % 8 == 0), with the callers' G = groups_for(C, 32): the block is whole
    warps, at most GN_MAX_THREADS, holds rows * C/8 threads that each own one
    vector (8 channels) of a row, and its statistics fit 32 KB of shared
    memory; replaying the kernel's slot arithmetic (s = tid % (C/8), row
    offset tid // (C/8)), every channel of every row offset is covered by
    exactly one thread, and gn_fold's (thread tid = g * L + l of L lanes a
    group, the most up to 32 with G * L <= threads; lane l takes the group's
    channels l, l + L, ...) puts each channel c into group c // (C/G) exactly
    once, with each group's lanes inside one warp.  At SD1.5's widths no
    thread idles."""
    for c in range(8, tgn.GN_MAX_C + 1, 8):
        g = tgn.groups_for(c, 32)
        cg, nv = c // g, c // 8
        threads, rows, _ = tgn.gn_plan(16, 4096, c, H100_SMS)
        assert threads % 32 == 0 and threads <= tgn.GN_MAX_THREADS and rows * nv <= threads
        assert rows * c * 8 <= 32 * 1024
        tid = np.arange(rows * nv)
        chan = (tid % nv)[:, None] * 8 + np.arange(8)[None, :]
        cover = np.zeros((rows, c), np.int64)
        np.add.at(cover, (np.repeat(tid // nv, 8), chan.ravel()), 1)
        assert (cover == 1).all(), c
        lanes = 32
        while lanes > 1 and g * lanes > threads:
            lanes //= 2
        folded = np.zeros(c, np.int64)
        for t in range(g * lanes):
            grp, lane = divmod(t, lanes)
            assert t // 32 == (grp * lanes + lanes - 1) // 32  # the group's lanes share a warp
            chans = grp * cg + np.arange(lane, cg, lanes)
            assert (chans // cg == grp).all()
            folded[chans] += 1
        assert (folded == 1).all(), c
        if c in (128, 256, 320, 512, 640, 960, 1280, 1920, 2560):
            assert threads == rows * nv, (c, threads, rows)


@pytest.mark.parametrize("b", [1, 2, 8, 16])
def test_gn_plan_walks_every_row_once(b):
    """The grid-stride walk of gn_walk at every main-path HW and SD1.5 width:
    block k of a sample takes rows k * rows + ro + i * blocks * rows (ro <
    rows, i >= 0); every pixel row is taken by exactly one (block, row
    offset), and the grid of blocks * b blocks fits one wave of
    GN_THREADS_PER_SM threads an SM."""
    for c in (128, 256, 320, 512, 640, 960, 1280, 1920, 2560):
        for hw in MAIN_PATH_HW:
            threads, rows, blocks = tgn.gn_plan(b, hw, c, H100_SMS)
            step = blocks * rows
            starts = (np.arange(blocks)[:, None] * rows + np.arange(rows)[None, :]).ravel()
            taken = np.zeros(hw, np.int64)
            for st in starts:
                taken[st::step] += 1
            assert (taken == 1).all(), (b, c, hw)
            per_sm = max(1, tgn.GN_THREADS_PER_SM // threads)
            assert blocks * b <= H100_SMS * per_sm, (b, c, hw, blocks)


def _fold(terms, lanes):
    """gn_fold: terms (..., n) f32; lane l sums terms l, l + lanes, ... in
    order, then the lanes add up in a butterfly; returns lane 0's sum."""
    n = terms.shape[-1]
    pad = torch.zeros(*terms.shape[:-1], -(-n // lanes) * lanes)
    pad[..., :n] = terms  # zero terms add nothing: s + 0 == s in f32
    acc = pad[..., 0:lanes]
    for i in range(1, pad.shape[-1] // lanes):
        acc = acc + pad[..., lanes * i:lanes * (i + 1)]
    off = lanes // 2
    while off:
        acc = acc + acc[..., torch.arange(lanes) ^ off]
        off //= 2
    return acc[..., 0]


def _kernel_moments(x, groups, plan):
    """K3's statistics in its own f32 sum order, in torch: x (B, HW, C) f32
    (bf16 values).  A thread sums its 8 channels' moments over its rows in row
    order (s2 as fma(f, f, s2), modelled as the exact f64 sum rounded once);
    the block adds its row offsets per channel in order, then folds channels
    into groups (gn_fold: L lanes a group, the most up to 32 with G * L <=
    threads); the normalize's prologue folds a group's block partials the
    same way.  Returns (sum, sum of squares) per (B, G), f32."""
    b, hw, c = x.shape
    threads, rows, blocks = plan
    lanes = 32
    while lanes > 1 and groups * lanes > threads:
        lanes //= 2
    step = blocks * rows
    k = -(-hw // step)
    xp = torch.zeros(b, k * step, c)
    xp[:, :hw] = x  # zero rows add nothing: x + 0 == x in f32
    xp = xp.reshape(b, k, blocks, rows, c)
    s1 = torch.zeros(b, blocks, rows, c)
    s2 = torch.zeros(b, blocks, rows, c)
    for i in range(k):
        f = xp[:, i]
        s1 = s1 + f
        s2 = (s2.double() + f.double() * f.double()).float()
    c1, c2 = s1[:, :, 0], s2[:, :, 0]
    for ro in range(1, rows):
        c1, c2 = c1 + s1[:, :, ro], c2 + s2[:, :, ro]
    cg = c // groups
    parts = [_fold(t.reshape(b, blocks, groups, cg), lanes) for t in (c1, c2)]  # (B, blocks, G)
    return [_fold(t.transpose(1, 2), lanes) for t in parts]


def _kernel_group_norm(x, gamma, beta, groups, eps, act, tpu, plan):
    """K3's function on x (B, HW, C) bf16 in its own sum order
    (_kernel_moments) and its three epilogues (gn_coef, gn_elem), in torch:
    tpu False (the xla order), True (the TPU numerics), "f32norm" (the TPU
    numerics with the f32 normalize)."""
    b, hw, c = x.shape
    s1, s2 = _kernel_moments(x.float(), groups, plan)
    n = float(c // groups * hw)
    mean = s1 / n
    var = s2 / n - mean * mean
    if not tpu:
        var = var.clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    cg = c // groups
    mean_c, rstd_c = mean.repeat_interleave(cg, 1)[:, None], rstd.repeat_interleave(cg, 1)[:, None]
    xf = x.float()
    bf = torch.bfloat16

    def r(t):
        return t.to(bf).float()

    if tpu:
        if tpu == "f32norm":  # every op in f32, one rounding at the store
            def r(t):
                return t
        sc = gamma * rstd_c
        a, sh = r(sc), r(beta - mean_c * sc)
        y = r(r(xf * a) + sh)
        if act == "silu":
            y = y * r(1.0 / r(1.0 + r(torch.exp(-y))))
    else:
        y = r((xf - mean_c) * (rstd_c * gamma) + beta)
        if act == "silu":
            y = y / (1.0 + torch.exp(-y))
    return y.to(bf)


@pytest.mark.parametrize("c", [320, 640, 960, 256])
@pytest.mark.parametrize("tpu", [False, True, "f32norm"])
@pytest.mark.parametrize("sms", [4, H100_SMS])
def test_kernel_sum_order_matches_plain_and_jax(c, tpu, sms):
    """K3's per-channel-then-group f32 sum order and its epilogues, emulated
    in torch at C/G = 10, 20, 30 and 8 (vectors of 8 channels that span
    group boundaries at 10, 20, 30), with the plan for an H100 (one row
    group a thread) and for 4 SMs (many rows a thread, a ragged last row
    group), against group_norm_plain / group_norm_tpu_plain (with its bf16
    or f32 normalize) and against the JAX package's _xla_group_norm /
    _gn_pallas(bf16_norm=True / False) in interpret mode, bf16, with
    SiLU and without (HW 256: the TPU kernel takes power-of-two HW only).
    Only f32 sum orders differ; a flipped bf16 rounding of the mean or a
    folded scale moves an element by 2 ulps of its terms' magnitude and
    each later rounding adds one: >= 99.9% equal and all within 8 ulps of
    (|x| + |mean|) |gamma rstd| + |beta|, as chip_smoke.py holds the
    kernel.  XLA's SiLU in bf16 rounds sigmoid to bf16 before the product
    (tests/test_torch_ops.py), which changes some 40% of the activated
    outputs by an ulp: there only the 8 ulps hold."""
    b, h, w, groups, eps = 2, 16, 16, 32, 1e-5
    hw = h * w
    x, gamma, beta = _gn_inputs(b, hw, c, seed=c + sms)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    plan = tgn.gn_plan(b, hw, c, sms)
    xf = xb.float().reshape(b, hw, groups, -1)
    mean = xf.mean((1, 3))
    rstd = torch.rsqrt(((xf * xf).mean((1, 3)) - mean * mean).clamp_min(0.0) + eps)
    mag = _np((xb.float().abs() + mean.repeat_interleave(c // groups, 1)[:, None].abs())
              * (gt * rstd.repeat_interleave(c // groups, 1)[:, None]).abs() + bt.abs())
    x4 = xb.permute(0, 2, 1).reshape(b, c, h, w)
    onehot = jnp.asarray(np.repeat(np.eye(groups, dtype=np.float32), c // groups, axis=0))
    for act in (None, "silu"):
        got = _np(_kernel_group_norm(xb, gt, bt, groups, eps, act, tpu, plan))
        bf16_norm = tpu != "f32norm"
        ref = tgn.group_norm(x4, gt, bt, groups, eps, act, tpu_numerics=bool(tpu), bf16_norm=bf16_norm)
        ref = _np(ref.reshape(b, c, hw).permute(0, 2, 1))
        xj = jnp.asarray(_np(xb)).astype(jnp.bfloat16)
        if tpu:
            with pltpu.force_tpu_interpret_mode():
                want = _np(jgn._gn_pallas(xj, jnp.asarray(gamma).reshape(1, c), jnp.asarray(beta).reshape(1, c),
                                          onehot, groups, eps, act, jgn._pick_chunk(hw, c), 1, bf16_norm))
        else:
            want = _np(jgn._xla_group_norm(xj, jnp.asarray(gamma), jnp.asarray(beta), groups, eps, act))
        for other in (ref, want):
            u = np.abs(got - other) / 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(mag, np.abs(other)),
                                                                           2.0 ** -126))) - 7)
            assert u.max() <= 8, (act, u.max())
            if tpu or act is None or other is ref:
                assert np.mean(got == other) >= 0.999, (act, np.mean(got == other))
