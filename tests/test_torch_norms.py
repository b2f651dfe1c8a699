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
    input of a tiny canny generation, in both kernel configurations, is a
    4-d channels-last tensor (the UNet, ControlNet and VAE run channels-last
    from the latents on), and every LayerNorm input is contiguous."""
    from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _ids, _inputs
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline

    seen = []

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, t_unet.GroupNorm32):
            dense = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        else:
            dense = x.is_contiguous()
        seen.append(dense)

    src, lat = _inputs(5)
    ids, neg = _ids()
    for options in ({}, {"pallas_group_norm": True, "attention_megakernel": True}):
        tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=3,
                               unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT, **options)
        for key in ("unet", "controlnet", "vae"):
            for m in tp.params[key].modules():
                if isinstance(m, (t_unet.GroupNorm32, t_unet.LayerNorm32)):
                    m.register_forward_pre_hook(hook)
        tp.make_fused_generate(32, 32, 2, 7.5)(tp.params, ids, neg, src, lat)
    assert len(seen) > 100 and all(seen)
