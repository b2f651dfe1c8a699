"""The JAX package's kernel route and numerics switches in the port, on the CPU.

The JAX package reads SASPA_PALLAS_GN, SASPA_DISABLE_PALLAS_GN,
SASPA_GN_FP32_NORM, SASPA_ATTN_MEGAKERNEL, SASPA_DISABLE_PALLAS,
SASPA_PALLAS_GEGLU, SASPA_LN_FP32_NORM, SASPA_CFG_FULL_BATCH and
SASPA_SPLIT_SKIP_CONCAT at trace time; the port resolves them once into
`KernelSwitches` where a pipeline is built.  Each test sets the variables,
and where the JAX side picks a Pallas kernel only on a TPU backend, answers
`jax.default_backend()` with "tpu" while the kernels run in interpret mode
(as tests/test_torch_attention_block.py does).  Inputs are numpy arrays
from a seed, handed to both packages; the port's wrappers run their plain
versions on CPU tensors.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from saspa_tpu.diffusion import sampler as jsampler
from saspa_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from saspa_tpu.models import unet as junet
from saspa_tpu.ops import attention as jatt
from saspa_tpu.ops import geglu as jgeglu
from saspa_tpu.ops import groupnorm as jgn
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.diffusion import pipelines as tpipelines
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.diffusion.sampler import make_sample_loop
from saspa_tpu_torch.diffusion.schedulers import SchedulerConfig, get_scheduler
from saspa_tpu_torch.models import unet as t_unet
from saspa_tpu_torch.models import vae as t_vae
from saspa_tpu_torch.ops import attention as tatt
from saspa_tpu_torch.ops import groupnorm as tgn
from saspa_tpu_torch.ops import layernorm as tln
from saspa_tpu_torch.ops.switches import KernelSwitches
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_driver import stub_tree  # noqa: F401 (a fixture)
from tests.test_torch_norms import _bf16_ulps
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _ids, _inputs, _PresetJaxPipeline, tiny_params

VARIABLES = ("SASPA_PALLAS_GN", "SASPA_DISABLE_PALLAS_GN", "SASPA_GN_FP32_NORM", "SASPA_ATTN_MEGAKERNEL",
             "SASPA_DISABLE_PALLAS", "SASPA_PALLAS_GEGLU", "SASPA_LN_FP32_NORM", "SASPA_CFG_FULL_BATCH",
             "SASPA_SPLIT_SKIP_CONCAT", "SASPA_PALLAS_LN", "SASPA_GN_MIN_SPLIT", "SASPA_PACKED_BLOCK_Q",
             "SASPA_ATTN_BLOCK_Q", "SASPA_ATTN_BLOCK_KV")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them (tests/test_torch_train_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _environment(monkeypatch, env):
    for k in VARIABLES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# ---- the record --------------------------------------------------------------

ENVIRONMENTS = [
    {}, {"SASPA_PALLAS_GN": "1"}, {"SASPA_PALLAS_GN": "0"}, {"SASPA_PALLAS_GN": "1", "SASPA_DISABLE_PALLAS_GN": "1"},
    {"SASPA_DISABLE_PALLAS_GN": "1"}, {"SASPA_PALLAS_GN": "1", "SASPA_GN_FP32_NORM": "1"},
    {"SASPA_GN_FP32_NORM": "1"}, {"SASPA_ATTN_MEGAKERNEL": "1"}, {"SASPA_ATTN_MEGAKERNEL": "true"},
    {"SASPA_ATTN_MEGAKERNEL": "1", "SASPA_DISABLE_PALLAS": "1"}, {"SASPA_DISABLE_PALLAS": "1"},
    {"SASPA_PALLAS_GEGLU": "0"}, {"SASPA_PALLAS_GEGLU": "1"}, {"SASPA_PALLAS_GEGLU": ""},
    {"SASPA_LN_FP32_NORM": "1"}, {"SASPA_LN_FP32_NORM": "1", "SASPA_PALLAS_GEGLU": "1"},
    {"SASPA_CFG_FULL_BATCH": "1"}, {"SASPA_CFG_FULL_BATCH": "0"}, {"SASPA_SPLIT_SKIP_CONCAT": "1"},
    {"SASPA_SPLIT_SKIP_CONCAT": "yes"},
    {"SASPA_PALLAS_GN": "1", "SASPA_GN_FP32_NORM": "1", "SASPA_ATTN_MEGAKERNEL": "1", "SASPA_PALLAS_GEGLU": "0",
     "SASPA_CFG_FULL_BATCH": "1", "SASPA_SPLIT_SKIP_CONCAT": "1"},
]


@pytest.mark.parametrize("env", ENVIRONMENTS, ids=lambda e: "-".join(f"{k[6:]}={v}" for k, v in e.items()) or "none")
def test_record_resolves_as_the_jax_predicates(env, monkeypatch):
    """KernelSwitches.from_env against what the JAX package itself does
    under the same variables on a TPU backend: its GroupNorm, attention and
    GEGLU predicates, the normalize `_ln32_forward` runs on bf16 (f32 or
    bf16, told apart by which of the port's two functions it equals), the
    batch its sampler hands the UNet under CFG (and the port's sampler
    built with the record), and the split-skip predicate."""
    _environment(monkeypatch, env)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rec = KernelSwitches.from_env()
    assert rec == KernelSwitches.from_env(dict(env))
    assert rec.pallas_group_norm == (not jgn._disabled())
    assert rec.gn_fp32_norm == (not jgn._bf16_norm())
    assert rec.disable_pallas == jatt._disabled()
    assert (rec.attention_megakernel and not rec.disable_pallas) == jatt.attention_block_eligible(
        4096, 4096, 8, 40, 320, jnp.bfloat16)
    assert rec.pallas_geglu == jgeglu._enabled()
    assert rec.fused_ff == jgeglu.ln_geglu_eligible(4096, 320, 4, jnp.bfloat16)
    assert rec.split_skip_concat == junet._split_skip_eligible(320, 320, 32)

    rng = np.random.RandomState(0)
    x = (0.5 + 3.0 * rng.randn(2, 16, 64)).astype(np.float32)
    s, b = (1.0 + 0.2 * rng.randn(64)).astype(np.float32), (0.2 * rng.randn(64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout = _np(junet._ln32_forward(jx, jnp.asarray(s), jnp.asarray(b), 1e-5))
    xt, st, bt = torch.tensor(_np(jx)).to(torch.bfloat16), torch.from_numpy(s), torch.from_numpy(b)
    f32_equal = np.mean(jout == _np(tln.layer_norm_fp32_norm(xt, st, bt, 1e-5)))
    bf16_equal = np.mean(jout == _np(tln.layer_norm_one_pass_plain(xt, st, bt, 1e-5)))
    assert (f32_equal > bf16_equal) == rec.ln_fp32_norm, (f32_equal, bf16_equal)

    seen = {}

    def unet(kind):
        def apply(p, lat, t, ctx, ac, dr, mr):
            seen[kind] = lat.shape[0]
            zeros = jnp.zeros if kind == "jax" else torch.zeros
            return zeros((ctx.shape[0],) + tuple(lat.shape[1:]))
        return apply

    lat, ctx = np.zeros((1, 2, 2, 4), np.float32), np.zeros((1, 3, 8), np.float32)
    jsampler.make_sample_loop(unet("jax"), JaxDDIM())({"unet": None}, jnp.asarray(lat), jnp.asarray(ctx),
                                                     jnp.asarray(ctx), jnp.asarray([500], jnp.int32), 7.5)
    port = make_sample_loop(unet("port"), get_scheduler("ddim", SchedulerConfig(), "cpu"),
                            cfg_full_batch=rec.cfg_full_batch)
    port({"unet": None}, torch.from_numpy(lat), torch.from_numpy(ctx), torch.from_numpy(ctx), [500], 7.5)
    assert seen["port"] == seen["jax"] == (2 if rec.cfg_full_batch else 1)


# ---- the tiny canny pipeline under each switch set ------------------------------

# (SASPA_PALLAS_GN=1 SASPA_ATTN_MEGAKERNEL=1, configuration (b), is
# tests/test_torch_attention_block.py's)
SWITCH_SETS = {
    "gn_fp32_norm": {"SASPA_PALLAS_GN": "1", "SASPA_GN_FP32_NORM": "1"},
    "disable_pallas": {"SASPA_DISABLE_PALLAS": "1"},
    "pallas_geglu_off": {"SASPA_PALLAS_GEGLU": "0"},
    "ln_fp32_norm": {"SASPA_LN_FP32_NORM": "1"},
    "cfg_full_batch": {"SASPA_CFG_FULL_BATCH": "1"},
    "split_skip_concat": {"SASPA_SPLIT_SKIP_CONCAT": "1"},
}


def _counting(monkeypatch, counts, module, name, key=None):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        k = key(*args, **kwargs) if key else name
        counts[k] = counts.get(k, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("name", list(SWITCH_SETS))
def test_fused_generate_under_each_switch_set_matches_jax(name, monkeypatch):
    """The tiny canny configuration (tests/test_torch_pipeline.py's params
    and inputs), f32, 2 DDIM steps, CFG 7.5: the JAX pipeline under the
    switch set with its Pallas kernels in interpret mode against the port's
    pipeline built under the same variables.  uint8 outputs agree to 1
    level, >= 99% exactly, as in configuration (a).  The port's record and
    its routes, counted through its wrappers and modules: K3's TPU numerics
    with the f32 normalize at every GroupNorm the split plan admits; no K1,
    K5 or K6 and every attention plain; no K2; no K2 and no K4; a 2B model
    input; the split-skip resnets.  No set runs K2 here: JAX's
    ln_geglu_eligible refuses f32 blocks, and so does the port's copy."""
    env = SWITCH_SETS[name]
    _environment(monkeypatch, env)
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(params)
    assert tp.switches == KernelSwitches.from_env(env)
    src, lat = _inputs(5)
    ids, neg = _ids()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.make_fused_generate(32, 32, 2, 7.5)(
            jp.params, jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(src), jnp.asarray(lat)))

    counts, batches = {}, []
    _counting(monkeypatch, counts, tgn, "group_norm_tpu_plain",
              key=lambda *a, **k: "k3_tpu_" + ("f32norm" if a[6:7] == (False,) else "bf16norm"))
    _counting(monkeypatch, counts, tgn, "group_norm_plain", key=lambda *a, **k: "k3_xla")
    for module, fn in ((t_unet, "flash_attention_packed"), (t_unet, "attention_block_fused"),
                       (t_vae, "flash_attention_packed"), (tatt, "flash_attention"), (tatt, "plain_attention"),
                       (t_unet, "fused_ln_geglu"), (t_unet, "layer_norm_one_pass"),
                       (t_unet, "layer_norm_fp32_norm")):
        _counting(monkeypatch, counts, module, fn, key=lambda *a, _n=f"{module.__name__}.{fn}", **k: _n)
    monkeypatch.setattr(t_unet.ResnetBlock2D, "forward", _recording_forward(counts))
    tp.params["unet"].register_forward_pre_hook(lambda m, a: batches.append(a[0].shape[0]))
    got = tp.make_fused_generate(32, 32, 2, 7.5)(tp.params, ids, neg, src, lat).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 32, 32, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.99, (diff.max(), np.mean(diff == 0))

    sw = tp.switches
    k1 = counts.get("saspa_tpu_torch.models.unet.flash_attention_packed", 0) \
        + counts.get("saspa_tpu_torch.models.vae.flash_attention_packed", 0)
    k5 = counts.get("saspa_tpu_torch.models.unet.attention_block_fused", 0)
    k2 = counts.get("saspa_tpu_torch.models.unet.fused_ln_geglu", 0)
    k4 = counts.get("saspa_tpu_torch.models.unet.layer_norm_one_pass", 0)
    plain_attention = counts.get("saspa_tpu_torch.ops.attention.plain_attention", 0)
    if sw.pallas_group_norm:
        mode = "k3_tpu_f32norm" if sw.gn_fp32_norm else "k3_tpu_bf16norm"
        assert counts.get(mode, 0) > 0 and counts.get("k3_tpu_" + ("bf16norm" if sw.gn_fp32_norm else "f32norm"),
                                                      0) == 0, counts
    else:
        assert counts["k3_xla"] > 0 and not any(k.startswith("k3_tpu") for k in counts), counts
    if sw.disable_pallas:
        assert k1 == k5 == counts.get("saspa_tpu_torch.ops.attention.flash_attention", 0) == 0, counts
        assert plain_attention > 0
    else:
        assert k1 + k5 > 0, counts
    assert (k5 > 0) == (sw.attention_megakernel and not sw.disable_pallas)
    # K2 only where the switch and JAX's ln_geglu_eligible both admit the
    # block: never on these f32 blocks (norm3 then runs K4)
    assert k2 == 0 and (k4 > 0) == (not sw.ln_fp32_norm), counts
    assert (counts.get("saspa_tpu_torch.models.unet.layer_norm_fp32_norm", 0) > 0) == sw.ln_fp32_norm
    assert set(batches) == {4 if sw.cfg_full_batch else 2}
    assert (counts.get("split_skip", 0) > 0) == sw.split_skip_concat, counts


def _recording_forward(counts):
    forward = t_unet.ResnetBlock2D.forward

    def recorded(self, x, temb, skip=None):
        if skip is not None:
            counts["split_skip"] = counts.get("split_skip", 0) + 1
        return forward(self, x, temb, skip)

    return recorded


# ---- bf16 sites: the f32 normalizes that f32 tests cannot see -------------------

def test_bf16_group_norm_under_gn_fp32_norm_matches_jax(monkeypatch):
    """GroupNorm32 built from the record of SASPA_PALLAS_GN=1
    SASPA_GN_FP32_NORM=1 against the JAX GroupNorm32 under the same
    variables (`_gn_pallas(..., bf16_norm=False)` in interpret mode), bf16,
    with SiLU, C320 (10 channels a group) at 8x8: >= 99.9% of the elements
    equal and all within 1 bf16 ulp; the bf16 normalize of the default TPU
    numerics differs from it on more than 5% of them."""
    _environment(monkeypatch, {"SASPA_PALLAS_GN": "1", "SASPA_GN_FP32_NORM": "1"})
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rec = KernelSwitches.from_env()
    rng = np.random.RandomState(7)
    c = 320
    x = (0.5 + 3.0 * rng.randn(2, 8, 8, c)).astype(np.float32)
    gamma, beta = (1.0 + 0.2 * rng.randn(c)).astype(np.float32), (0.2 * rng.randn(c)).astype(np.float32)
    flax = {"params": {"GroupNorm_0": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}}
    calls = []
    _counting(monkeypatch, {}, jgn, "_gn_pallas", key=lambda *a, **k: calls.append(a[-1]) or "k3")
    jx = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = _np(junet.GroupNorm32(32, act="silu").apply(flax, jx))
    assert calls == [False]  # the JAX side ran _gn_pallas with bf16_norm=False
    outs = {}
    for label, sw in (("f32norm", rec), ("bf16norm", rec.replace(gn_fp32_norm=False))):
        m = t_unet.GroupNorm32(c, 32, act="silu", **t_unet.gn_options(sw))
        m.load_state_dict(state_dict_from_flax(flax["params"]))
        xt = torch.tensor(_np(jx)).to(torch.bfloat16).permute(0, 3, 1, 2)
        outs[label] = _np(m(xt).permute(0, 2, 3, 1))
    assert np.mean(outs["f32norm"] == want) >= 0.999
    assert _bf16_ulps(outs["f32norm"], want).max() <= 1
    assert np.mean(outs["bf16norm"] != want) > 0.05


def test_bf16_transformer_block_under_ln_fp32_norm_matches_jax(monkeypatch):
    """A bf16 BasicTransformerBlock (C64, 2 heads, 64 tokens, a 77-token
    context) built from the record of SASPA_LN_FP32_NORM=1 against the JAX
    block under the same variable on a TPU backend (no K2, the f32
    LayerNorm at norm1-3, the feed-forward as separate ops), on the same
    flax params.  norm1 (the one norm whose input both packages share bit
    for bit): >= 99.9% of its elements equal to JAX's and all within 1 bf16
    ulp, where the default route's bf16 normalize differs on more than 5%;
    the block's output within 2% of its largest value."""
    _environment(monkeypatch, {"SASPA_LN_FP32_NORM": "1"})
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rec = KernelSwitches.from_env()
    rng = np.random.RandomState(3)
    x = (0.5 + 2.0 * rng.randn(2, 64, 64)).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    jx, jctx = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16)
    block = junet.BasicTransformerBlock(2, jnp.bfloat16)
    variables = jax.jit(block.init)(jax.random.PRNGKey(0), jx, jctx)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.1 * rng.randn(*p.shape)).astype(np.float32) * (p.ndim == 1),
        variables["params"])  # nonzero biases and norm shifts
    with pltpu.force_tpu_interpret_mode():
        want, inter = jax.jit(lambda p, a, c: block.apply({"params": p}, a, c, capture_intermediates=True,
                                                          mutable=["intermediates"]))(params, jx, jctx)
    want, want_norm1 = _np(want), _np(inter["intermediates"]["norm1"]["__call__"][0])
    outs, norm1 = {}, {}
    for label, sw in (("ln_fp32_norm", rec), ("default", KernelSwitches())):
        m = t_unet.BasicTransformerBlock(64, 32, 2, torch.bfloat16, "cpu", switches=sw)
        m.load_state_dict(state_dict_from_flax(params))
        m.norm1.register_forward_hook(lambda mod, a, out, _k=label: norm1.__setitem__(_k, _np(out)))
        with torch.no_grad():
            outs[label] = _np(m(torch.tensor(_np(jx)).to(torch.bfloat16), torch.tensor(_np(jctx)).to(torch.bfloat16)))
    assert np.mean(norm1["ln_fp32_norm"] == want_norm1) >= 0.999
    assert _bf16_ulps(norm1["ln_fp32_norm"], want_norm1).max() <= 1
    assert np.mean(norm1["default"] != want_norm1) > 0.05
    assert np.abs(outs["ln_fp32_norm"] - want).max() <= 0.02 * np.abs(want).max()


# ---- split skip ------------------------------------------------------------------

@pytest.mark.parametrize("pallas_gn", [False, True])
def test_split_skip_resnet_matches_jax(pallas_gn, monkeypatch):
    """ResnetBlock2D(x, temb, skip=skip) on a group-aligned seam (64 + 64
    channels into 32, 32 groups: 16 on each half) against the JAX block's
    split-skip path, f32, on the same flax params; with SASPA_PALLAS_GN=1
    the halves' GroupNorms run the TPU numerics (`_gn_pallas` in interpret
    mode at 16 groups a half).  The same params give the concatenation's
    route, up to f32 summation order: both within 1e-5 of the largest
    output."""
    _environment(monkeypatch, {"SASPA_PALLAS_GN": "1"} if pallas_gn else {})
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rec = KernelSwitches.from_env()
    assert t_unet.split_skip_eligible(64, 64, 32) and not t_unet.split_skip_eligible(64, 32, 32)
    rng = np.random.RandomState(11)
    x, skip = rng.randn(2, 8, 8, 64).astype(np.float32), rng.randn(2, 8, 8, 64).astype(np.float32)
    temb = rng.randn(2, 128).astype(np.float32)
    block = junet.ResnetBlock2D(32, jnp.float32)
    variables = jax.jit(lambda k, a, t, s: block.init(k, a, t, skip=s))(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(temb), jnp.asarray(skip))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.1 * rng.randn(*p.shape)).astype(np.float32) * (p.ndim == 1),
        variables["params"])
    calls = []
    _counting(monkeypatch, {}, jgn, "_gn_pallas", key=lambda *a, **k: calls.append(a[4]) or "k3")
    with pltpu.force_tpu_interpret_mode():
        want = _np(jax.jit(lambda p, a, t, s: block.apply({"params": p}, a, t, skip=s))(
            params, jnp.asarray(x), jnp.asarray(temb), jnp.asarray(skip)))
    assert sorted(calls) == ([16, 16, 32] if pallas_gn else [])  # norm1's halves, norm2
    m = t_unet.ResnetBlock2D(128, 32, 128, torch.float32, "cpu", switches=rec)
    m.load_state_dict(state_dict_from_flax(params))
    xt, st = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, skip))
    with torch.no_grad():
        split = _np(m(xt, torch.from_numpy(temb), skip=st).permute(0, 2, 3, 1))
        concat = _np(m(torch.cat([xt, st], dim=1), torch.from_numpy(temb)).permute(0, 2, 3, 1))
    scale = np.abs(want).max()
    np.testing.assert_allclose(split, want, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(concat, want, atol=1e-5 * scale, rtol=0)


# ---- cli gen ---------------------------------------------------------------------

def test_cli_gen_builds_its_pipeline_with_the_record(stub_tree, monkeypatch):  # noqa: F811
    """`cli gen` on the CPU under SASPA_PALLAS_GN=1 SASPA_GN_FP32_NORM=1
    SASPA_SPLIT_SKIP_CONCAT=1: init_pipeline builds (at the tiny configs, on
    the CPU) a pipeline whose record and modules carry those switches, and
    the run writes every image."""
    from saspa_tpu_torch import cli

    env = {"SASPA_PALLAS_GN": "1", "SASPA_GN_FP32_NORM": "1", "SASPA_SPLIT_SKIP_CONCAT": "1"}
    _environment(monkeypatch, env)
    made = []

    def tiny(*args, **kwargs):
        kwargs.update(device="cpu", dtype=torch.float32, unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
        made.append(DiffusionPipeline(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tpipelines, "DiffusionPipeline", tiny)
    out = cli.main(["gen", "--dataset", "planes", "--skip_filter", "--num_per_image", "1", "--resolution", "64",
                    "--num_inference_steps", "2", "--batch_size", "3"])
    assert len(made) == 1
    pipe = made[0]
    assert pipe.switches == KernelSwitches(pallas_group_norm=True, gn_fp32_norm=True, split_skip_concat=True)
    norms = [m for k in ("unet", "controlnet", "vae") for m in pipe.params[k].modules()
             if isinstance(m, t_unet.GroupNorm32)]
    assert norms and all(m.tpu_numerics and not m.bf16_norm for m in norms)
    assert pipe.params["unet"].split_skip
    assert len([p for p in Path(out).glob("*.png") if "_prompt_" in p.name]) == 3
