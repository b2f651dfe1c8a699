"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: these need an NVIDIA Hopper card and nvcc, and skip
elsewhere.  On the card:  python -m pytest tests/test_torch_cuda.py -m cuda
(chip_smoke.py runs the same checks at the main path's full shapes).
"""

import math

import pytest
import torch

from saspa_tpu_torch.ops import attention, geglu, groupnorm, layernorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,l,h,d,dp", [(2, 256, 8, 40, 64), (2, 512, 4, 80, 128), (1, 256, 2, 160, 192),
                                        (1, 256, 1, 512, 512)])
def test_attention_packed_kernel_matches_plain(gen, b, l, h, d, dp):
    """bf16 output; P rounded to bf16 before P.V; online vs one-pass softmax
    sum order: |diff| <= 1% of the largest output; pad columns exactly 0."""
    def padded(x):
        return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp).to(torch.bfloat16).contiguous()

    q = padded(torch.randn(b, l, h, d, generator=gen, device="cuda") * (attention.LOG2E / math.sqrt(d)))
    k, v = (padded(torch.randn(b, l, h, d, generator=gen, device="cuda")) for _ in range(2))
    before = attention.launches
    out = attention.flash_attention_packed(q, k, v, h)
    assert attention.launches == before + 1
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert (out.reshape(b, l, h, dp)[..., d:] == 0).all()


@pytest.mark.parametrize("b,l,h,d,dp", [(2, 256, 8, 40, 64), (8, 1024, 8, 40, 64), (2, 384, 2, 40, 64),
                                        (2, 256, 4, 80, 128), (8, 1024, 8, 80, 128), (2, 384, 2, 80, 128),
                                        (1, 128, 2, 160, 192), (2, 256, 2, 160, 192), (4, 1024, 8, 160, 192),
                                        (8, 1024, 10, 64, 64), (8, 256, 20, 64, 64), (16, 256, 20, 64, 64)])
def test_attention_packed_wgmma_kernel_peaked(gen, b, l, h, d, dp):
    """The wgmma kernel (head dims 64/128/192) on peaked scores: q of std 3
    before the scale puts each query's softmax on a few keys, so a permuted,
    half-swizzled or dropped K/V tile changes the output.  L = 128 and 256
    stay within one turn of the 3-stage K/V ring, L = 1024 wraps it several
    times; the L = 1024 cases launch 256 blocks (two waves on 132 SMs); L =
    384 takes the 2-warpgroup blocks at head dims 64 and 128 (L % 256 != 0);
    SDXL's heads of d 64 (no padding) at 10 and 20 heads, batch 8 and its
    CFG's 16.  |diff| <= 1% of the largest output; pad columns exactly 0."""
    def padded(x):
        return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp).to(torch.bfloat16).contiguous()

    q = padded(torch.randn(b, l, h, d, generator=gen, device="cuda") * (3.0 * attention.LOG2E / math.sqrt(d)))
    k, v = (padded(torch.randn(b, l, h, d, generator=gen, device="cuda")) for _ in range(2))
    before = attention.launches
    out = attention.flash_attention_packed(q, k, v, h)
    assert attention.launches == before + 1
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert ref.float().abs().max() >= 2.0  # peaked: a few keys carry each output
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert (out.reshape(b, l, h, dp)[..., d:] == 0).all()


@pytest.mark.parametrize("b,l,h", [(1, 256, 1), (2, 1024, 2), (8, 4096, 1), (1, 9216, 1), (1, 17536, 1)])
def test_attention_packed_d512_kernel_peaked(gen, b, l, h):
    """The bf16 kernel at head dim 512 (the VAE's one head; scores warpgroup
    and two output warpgroups) on peaked scores: L = 256 is four 64-key
    tiles, within the P double buffer's first turns; (2, 1024, 2 heads)
    takes the head and batch offsets of the tensor maps; (8, 4096, 1) is the
    VAE's decode shape (512 blocks, 3.9 waves); 9216 a 768^2 VAE; 17,536
    the largest L the packed route admits at d 512 in bf16.  |diff| <= 1%
    of the largest output, counted by launches alone."""
    d = 512
    q = (3.0 * torch.randn(b, l, h * d, generator=gen, device="cuda") * (attention.LOG2E / math.sqrt(d)))
    q = q.to(torch.bfloat16)
    k, v = (torch.randn(b, l, h * d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    before = (attention.launches, attention.launches_f32)
    out = attention.flash_attention_packed(q, k, v, h)
    assert (attention.launches, attention.launches_f32) == (before[0] + 1, before[1])
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert out.dtype == torch.bfloat16 and ref.float().abs().max() >= 2.0
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


def _geglu_args(gen, m, c):
    f = 4 * c

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    bf = torch.bfloat16
    return (rn(1, m, c).to(bf), 1.0 + rn(c, std=0.1), rn(c, std=0.1), rn(2 * f, c, std=c ** -0.5).to(bf),
            rn(2 * f, std=0.1).to(bf), rn(c, f, std=f ** -0.5).to(bf), rn(c, std=0.1).to(bf))


@pytest.mark.parametrize("m,c", [(256, 64), (96, 128), (32, 320), (96, 320), (200, 640), (96, 1280), (200, 1280),
                                 (65536, 320), (8192, 640), (2048, 1280)])
def test_ln_geglu_kernel_matches_plain(gen, m, c):
    """Same bf16 rounding points; f32 summation order differs: |diff| <= 1%
    of the largest output.  Row counts that are not multiples of the 128-row
    blocks at every main-path C (N tiles of 160 and 64), the full
    level-0 shape at 512^2, and SDXL-Turbo's rows at 512^2 (8192 x 640,
    2048 x 1280)."""
    args = _geglu_args(gen, m, c)
    before = geglu.launches
    out = geglu.fused_ln_geglu(*args)
    assert geglu.launches == before + 1
    ref = geglu.fused_ln_geglu_plain(*args)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("m,c", [(200, 320), (96, 640), (4096, 1280), (256, 64)])
def test_ln_geglu_stages_match_plain_stages(gen, m, c):
    """Each of K2's three kernels against its plain stage on the previous
    kernel's output.  xn: K4's function (>= 99% equal, <= 8 ulps).  hid:
    >= 99% bit-equal to the plain hidden, the rest within 1 bf16 ulp of the
    terms' magnitude of h * gelu(g): a_h |g| + |h| a_g, with a_h, a_g the
    products' terms (|xn| |W1|^T + |b1|), |gelu(g)|'s terms 0.5 |g| (1 +
    |erf|) <= |g| (where erf nears -1, 1 + erf cancels) and |gelu'| < 1.13;
    only the f32 sum order of the product and the polynomial's FMAs differ.
    out:
    >= 99% equal to the plain epilogue on the kernel's hid, and within 1% of
    the largest output."""
    args = _geglu_args(gen, m, c)
    x, lns, lnb, w1, b1, w2, b2 = args
    f = 4 * c
    xn, hid, out = geglu.ln_geglu_stages(*args)
    xn_ref = layernorm.layer_norm_one_pass_plain(x, lns, lnb).reshape(m, c)
    assert (xn == xn_ref).float().mean() >= 0.99
    assert _bf16_ulps(xn, xn_ref, xn_ref.float().abs()).max() <= 8

    hid_ref = geglu.geglu_hidden_plain(xn, w1, b1)
    a = xn.float().abs() @ w1.float().abs().t() + b1.float().abs()
    hg = xn.float() @ w1.float().t() + b1.float()
    mag = a[:, :f] * hg[:, f:].abs() + hg[:, :f].abs() * a[:, f:]
    assert (hid == hid_ref).float().mean() >= 0.99
    assert _bf16_ulps(hid, hid_ref, mag).max() <= 1

    out_ref = geglu.geglu_out_plain(hid, w2, b2, x.reshape(m, c))
    assert (out.reshape(m, c) == out_ref).float().mean() >= 0.99
    assert (out.reshape(m, c).float() - out_ref.float()).abs().max() <= 1e-2 * out_ref.float().abs().max()


def _bf16_ulps(out, ref, mag):
    """|out - ref| in bf16 ulps of the larger of |ref| and mag."""
    m = torch.maximum(mag, ref.float().abs()).clamp_min(2.0 ** -126)
    return (out.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize("b,c,h,w,act,eps", [(16, 320, 64, 64, "silu", 1e-5), (2, 960, 16, 16, "silu", 1e-5),
                                               (2, 960, 64, 64, None, 1e-5), (8, 128, 128, 128, "silu", 1e-6),
                                               (1, 128, 17, 19, None, 1e-6), (2, 640, 32, 32, "silu", 1e-5),
                                               (3, 256, 9, 9, "silu", 1e-6), (1, 64, 2, 3, None, 1e-5)])
@pytest.mark.parametrize("tpu", [False, True])
def test_group_norm_kernel_ulps_across_group_boundaries(gen, b, c, h, w, act, eps, tpu):
    """K3 against its plain versions as chip_smoke.py holds it: >= 99.9% of
    elements bit-equal and every one within 8 bf16 ulps of its terms'
    magnitude ((|x| + |mean|) |gamma rstd| + |beta|), where a flipped bf16
    rounding of a mean or a folded scale moves x * scale by 2 ulps and each
    later rounding adds one.  C/G = 10, 30, 20 and 8 put group boundaries
    inside 16-byte vectors (at C/G = 10 a vector of 8 channels spans two
    groups), C/G = 4 (the VAE's C128) and 2 put several groups in one; row
    counts that leave a ragged last row group (17x19, 9x9, 2x3) and a
    sample's rows walked by many blocks (B8 C128 128^2)."""
    x = (0.5 + 3.0 * torch.randn(b, c, h, w, generator=gen, device="cuda")).to(torch.bfloat16)
    x = x.to(memory_format=torch.channels_last)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    out = groupnorm.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)
    plain = groupnorm.group_norm_tpu_plain if tpu else groupnorm.group_norm_plain
    ref = plain(x, gamma, beta, 32, eps, act)
    xg = x.float().reshape(b, 32, -1)
    mean = xg.mean(-1)
    rstd = torch.rsqrt(((xg * xg).mean(-1) - mean * mean).clamp_min(0.0) + eps)
    sc = (gamma.reshape(1, 32, -1) * rstd[:, :, None]).abs().reshape(b, c, 1, 1)
    mag = (x.float().abs() + mean.abs().repeat_interleave(c // 32, 1)[:, :, None, None]) * sc \
        + beta.abs().reshape(1, c, 1, 1)
    assert out.stride() == x.stride()
    assert (out == ref).float().mean() >= 0.999
    assert _bf16_ulps(out, ref, mag).max() <= 8


@pytest.mark.parametrize("b,c,h,w,act,eps", [(16, 320, 64, 64, "silu", 1e-5), (16, 320, 64, 64, None, 1e-6),
                                               (16, 960, 64, 64, "silu", 1e-5), (16, 640, 32, 32, "silu", 1e-5),
                                               (16, 1280, 8, 8, "silu", 1e-5), (8, 256, 256, 256, "silu", 1e-6),
                                               (8, 512, 64, 64, None, 1e-6), (2, 256, 9, 9, "silu", 1e-6)])
def test_group_norm_f32norm_kernel_matches_plain(gen, b, c, h, w, act, eps):
    """K3's TPU numerics with the f32 normalize (SASPA_GN_FP32_NORM=1) at
    configuration (b)'s shapes (the UNet's largest and smallest sites, the
    transformers' norm, the VAE's C256 256^2 and its attention's norm) and a
    ragged one, against group_norm_tpu_plain(bf16_norm=False): held as
    chip_smoke.py holds K3, >= 99.9% of elements equal and all within 8 bf16
    ulps of the terms' magnitude; counted in launches and
    launches_tpu_f32norm, not launches_tpu."""
    x = (0.5 + 3.0 * torch.randn(b, c, h, w, generator=gen, device="cuda")).to(torch.bfloat16)
    x = x.to(memory_format=torch.channels_last)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    before = (groupnorm.launches, groupnorm.launches_tpu, groupnorm.launches_tpu_f32norm)
    out = groupnorm.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=True, bf16_norm=False)
    assert (groupnorm.launches, groupnorm.launches_tpu, groupnorm.launches_tpu_f32norm) == \
        (before[0] + 1, before[1], before[2] + 1)
    ref = groupnorm.group_norm_tpu_plain(x, gamma, beta, 32, eps, act, bf16_norm=False)
    xg = x.float().reshape(b, 32, -1)
    mean = xg.mean(-1)
    rstd = torch.rsqrt(((xg * xg).mean(-1) - mean * mean).clamp_min(0.0) + eps)
    sc = (gamma.reshape(1, 32, -1) * rstd[:, :, None]).abs().reshape(b, c, 1, 1)
    mag = (x.float().abs() + mean.abs().repeat_interleave(c // 32, 1)[:, :, None, None]) * sc \
        + beta.abs().reshape(1, c, 1, 1)
    assert out.dtype == torch.bfloat16 and out.stride() == x.stride()
    assert (out == ref).float().mean() >= 0.999
    assert _bf16_ulps(out, ref, mag).max() <= 8


# a UNet at kernel-legal widths: C128 and C256 (K2's and K5's multiples of 64
# and 128), heads of d 64, 32 groups; at 16x16 latents level 0's three
# self-attentions see 256 tokens (K1, or K5), the mid block's 64 run plain
SMALL_UNET = dict(block_out_channels=(128, 256), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                  transformer_layers_per_block=(1, 1), num_attention_heads=(2, 4), cross_attention_dim=64)
SWITCH_SETS = {"pallas_gn": {"pallas_group_norm": True}, "gn_fp32_norm": {"pallas_group_norm": True,
               "gn_fp32_norm": True}, "megakernel": {"attention_megakernel": True},
               "disable_pallas": {"disable_pallas": True, "attention_megakernel": True},
               "pallas_geglu_off": {"pallas_geglu": False}, "ln_fp32_norm": {"ln_fp32_norm": True},
               "split_skip_concat": {"split_skip_concat": True}, "cfg_full_batch": {"cfg_full_batch": True}}


def _unet_call_counts(gen, switches):
    """Launch counts and the UNet's input batch of one CFG step through the
    sampler (B2 latents, the [uncond, cond] context at B4) on a seeded bf16
    SMALL_UNET built with the switches."""
    from saspa_tpu_torch.diffusion.sampler import make_sample_loop
    from saspa_tpu_torch.diffusion.schedulers import SchedulerConfig, get_scheduler
    from saspa_tpu_torch.models.layers import init_weights
    from saspa_tpu_torch.models.unet import UNet2DCondition, UNetConfig

    unet = UNet2DCondition(UNetConfig(**SMALL_UNET), torch.bfloat16, "cuda", switches=switches).eval()
    init_weights(unet, 0)
    batches = []
    unet.register_forward_pre_hook(lambda m, a: batches.append(a[0].shape[0]))
    sample = make_sample_loop(lambda p, lat, t, ctx, ac, dr, mr: p(lat, t, ctx, dr, mr, ac),
                              get_scheduler("ddim", SchedulerConfig(), "cuda"),
                              cfg_full_batch=switches.cfg_full_batch)
    lat = torch.randn(2, 16, 16, 4, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 64, generator=gen, device="cuda")
    counters = {"k1": (attention, "launches"), "k5": (attention, "block_launches"),
                "k6": (attention, "flash_launches"), "k2": (geglu, "launches"), "k3": (groupnorm, "launches"),
                "k3_tpu": (groupnorm, "launches_tpu"), "k3_f32norm": (groupnorm, "launches_tpu_f32norm"),
                "k4": (layernorm, "launches")}
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    out = sample({"unet": unet}, lat, ctx, torch.zeros_like(ctx), [500], 7.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    return {k: getattr(m, a) - before[k] for k, (m, a) in counters.items()}, batches


@pytest.mark.parametrize("name", list(SWITCH_SETS))
def test_switch_launch_counts_on_one_unet_call(gen, name):
    """Each switch of ops/switches.py on one UNet call under CFG, against the
    default record's counts: K3's TPU numerics (bf16 or f32 normalize) at
    every GroupNorm, K5 at the admitted self-attention, no K1, K5, K6
    anywhere, no K2 (norm3 then runs K4), no K2 and no K4, two K3 calls on
    each split-skip seam's norm1, the UNet's input at 2B."""
    from saspa_tpu_torch.ops.switches import KernelSwitches

    base, base_batches = _unet_call_counts(gen, KernelSwitches())
    sw = KernelSwitches(**SWITCH_SETS[name])
    got, batches = _unet_call_counts(gen, sw)
    assert base["k1"] == 3 and base["k2"] > 0 and base["k4"] == 2 * base["k2"] and base["k3_tpu"] == 0
    want = dict(base)
    if sw.pallas_group_norm:
        want["k3_f32norm" if sw.gn_fp32_norm else "k3_tpu"] = base["k3"]
    if sw.attention_megakernel and not sw.disable_pallas:
        want["k1"], want["k5"] = 0, base["k1"]
    if sw.disable_pallas:
        want["k1"] = want["k5"] = want["k6"] = 0
    if not sw.pallas_geglu:
        want["k2"], want["k4"] = 0, 3 * base["k2"]
    if sw.ln_fp32_norm:
        want["k2"] = want["k4"] = 0
    if sw.split_skip_concat:
        assert got["k3"] > base["k3"]
        want["k3"] = got["k3"]
    assert got == want, (name, got, want)
    assert batches == [4 if sw.cfg_full_batch else 2] and base_batches == [2]


def test_group_norm_makes_two_launches(gen):
    """One call runs K3's two kernels (statistics, then normalize) and
    nothing else: no finalize launch, no memset."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2, 320, 32, 32, generator=gen, device="cuda").to(torch.bfloat16)
    x = x.to(memory_format=torch.channels_last)
    ones = torch.ones(320, device="cuda")
    groupnorm.group_norm(x, ones, ones, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        groupnorm.group_norm(x, ones, ones, 32, 1e-5, "silu")
        torch.cuda.synchronize()
    names = sorted(e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(names) == 2 and any("gn_stats_kernel" in n for n in names) \
        and any("gn_apply_kernel" in n for n in names), names


@pytest.mark.parametrize("b,c,h,w,act,eps", [(2, 320, 64, 64, "silu", 1e-5), (2, 1280, 8, 8, None, 1e-6),
                                               (1, 256, 128, 128, "silu", 1e-6), (3, 64, 4, 4, None, 1e-5),
                                               (2, 192, 5, 7, "silu", 1e-5), (2, 2560, 8, 8, "silu", 1e-5),
                                               (2, 1920, 16, 16, None, 1e-5), (1, 640, 32, 32, "silu", 1e-5)])
@pytest.mark.parametrize("tpu", [False, True])
def test_group_norm_kernel_matches_plain(gen, b, c, h, w, act, eps, tpu):
    """Both epilogues on channels-last input; f32 statistics summed in another
    order than the plain version's, which can flip a bf16 rounding: |diff|
    <= 1% of the largest output, and >= 99% of elements equal.  One chunk
    and many; channel slots of 2, 4 and 8 per thread, fewer and more slots
    than threads; an HW that is not a multiple of 8."""
    x = (2.0 + 3.0 * torch.randn(b, c, h, w, generator=gen, device="cuda")).to(torch.bfloat16)
    x = x.to(memory_format=torch.channels_last)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    before = (groupnorm.launches, groupnorm.launches_tpu)
    out = groupnorm.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)
    assert (groupnorm.launches, groupnorm.launches_tpu) == (before[0] + 1, before[1] + int(tpu))
    plain = groupnorm.group_norm_tpu_plain if tpu else groupnorm.group_norm_plain
    ref = plain(x, gamma, beta, 32, eps, act)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape and out.stride() == x.stride()
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert (out == ref).float().mean() >= 0.99


@pytest.mark.parametrize("b,c,h,w,act,eps", [(2, 128, 64, 64, "silu", 1e-6), (1, 256, 32, 32, None, 1e-6),
                                               (2, 512, 16, 16, "silu", 1e-6), (2, 64, 5, 7, "silu", 1e-5),
                                               (2, 2048, 8, 8, None, 1e-5), (1, 96, 9, 9, "silu", 1e-5)])
@pytest.mark.parametrize("tpu", [False, True])
def test_group_norm_f32_kernel_matches_plain(gen, b, c, h, w, act, eps, tpu):
    """f32 x (the XL VAE under SASPA_XL_VAE_FP32=1), both epilogues, 16-byte
    vectors of 4 channels: f32 out within 2e-5 of the largest output (the
    statistics' sum order), counted by launches_f32 alone."""
    x = (0.5 + 3.0 * torch.randn(b, c, h, w, generator=gen, device="cuda")).to(memory_format=torch.channels_last)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    before = (groupnorm.launches, groupnorm.launches_tpu, groupnorm.launches_f32)
    out = groupnorm.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)
    assert (groupnorm.launches, groupnorm.launches_tpu, groupnorm.launches_f32) == (*before[:2], before[2] + 1)
    plain = groupnorm.group_norm_tpu_plain if tpu else groupnorm.group_norm_plain
    ref = plain(x, gamma, beta, 32, eps, act)
    assert out.dtype == torch.float32 and out.shape == x.shape and out.stride() == x.stride()
    assert (out - ref).abs().max() <= 2e-5 * ref.abs().max()


def test_group_norm_f32_at_2_31_elements(gen):
    """The XL VAE's f32 site at 1024^2, B8 (C256): 2^31 elements, past a
    32-bit offset.  The last sample (the elements past 2^31 - 2^28) against
    the plain version on that sample alone (samples are independent)."""
    x = torch.empty(8, 256, 1024, 1024, device="cuda").to(memory_format=torch.channels_last)
    x.normal_(generator=gen).mul_(3.0).add_(0.5)
    gamma = 1.0 + 0.2 * torch.randn(256, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(256, generator=gen, device="cuda")
    out = groupnorm.group_norm(x, gamma, beta, 32, 1e-6, "silu")
    ref = groupnorm.group_norm_plain(x[7:], gamma, beta, 32, 1e-6, "silu")
    assert (out[7:] - ref).abs().max() <= 2e-5 * ref.abs().max()
    assert bool(torch.isfinite(out[0]).all())


@pytest.mark.parametrize("b,l,h", [(1, 256, 1), (2, 1024, 1), (1, 384, 2), (8, 4096, 1), (1, 9600, 1)])
def test_attention_packed_f32_kernel_matches_plain(gen, b, l, h):
    """f32 at head dim 512 (the XL VAE's one head under SASPA_XL_VAE_FP32=1),
    peaked scores (q of 3x the unit scale): f32 out within 1e-4 of the
    largest output (online against one-pass softmax, other product sum
    orders), counted by launches_f32 alone; L = 384 at 2 heads is six
    64-row blocks a head, L = 4096 at B8 the VAE's decode shape, 9600 the
    largest L the packed route admits at d 512 in f32."""
    d = 512
    q = (torch.randn(b, l, h * d, generator=gen, device="cuda") * (3.0 * attention.LOG2E / math.sqrt(d)))
    k, v = (torch.randn(b, l, h * d, generator=gen, device="cuda") for _ in range(2))
    before = (attention.launches, attention.launches_f32)
    out = attention.flash_attention_packed(q, k, v, h)
    assert (attention.launches, attention.launches_f32) == (before[0], before[1] + 1)
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert out.dtype == torch.float32 and ref.abs().max() >= 1.5
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("b,l,h,d,dp,real", [
    (2, 256, 8, 40, 64, True), (1, 384, 2, 40, 64, True), (2, 1024, 8, 80, 128, True), (1, 320, 4, 80, 128, True),
    (2, 256, 8, 160, 192, True), (1, 448, 2, 160, 192, True), (2, 256, 4, 64, 64, True), (1, 192, 2, 120, 128, True),
    (1, 320, 2, 24, 64, True), (2, 256, 8, 40, 64, False), (1, 192, 4, 80, 128, False), (1, 256, 2, 160, 192, False),
    (1, 320, 2, 128, 128, True), (1, 192, 2, 192, 192, True)])
def test_attention_f32_packed_kernel_matches_plain(gen, b, l, h, d, dp, real):
    """K1 in f32 at the UNet's heads (csrc/attention_f32.cu), q pre-scaled by
    scale * log2(e) on peaked scores (q of 3x the unit scale): f32 out within
    1e-4 of the largest output (online against one-pass softmax, other sum
    orders), padded columns exactly 0, counted by launches_f32_heads alone.
    real: the wrapper is told the real head dim, as the UNet tells it (the
    core computes on d columns: its widths 40, 64, 80, 160, and 120 and 24
    at the next width up, 128 and 40), else it computes on all d_pad columns
    (widths 64, 128, 192); L = 192, 320, 384, 448 are not multiples of 128
    (the f32 core's tiles take L % 64 == 0)."""
    def padded(x):
        return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp).contiguous()

    q = padded(torch.randn(b, l, h, d, generator=gen, device="cuda") * (3.0 * attention.LOG2E / math.sqrt(d)))
    k, v = (padded(torch.randn(b, l, h, d, generator=gen, device="cuda")) for _ in range(2))
    before = (attention.launches, attention.launches_f32, attention.launches_f32_heads)
    out = attention.flash_attention_packed(q, k, v, h, head_dim=d if real else None)
    assert (attention.launches, attention.launches_f32, attention.launches_f32_heads) == (*before[:2], before[2] + 1)
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert out.dtype == torch.float32 and ref.abs().max() >= 1.5
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (out.reshape(b, l, h, dp)[..., d:] == 0).all()


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 256, 256, 8, 40), (1, 1024, 1024, 8, 40), (1, 512, 512, 4, 80),
                                         (1, 256, 256, 2, 160), (1, 320, 448, 2, 40), (1, 256, 384, 2, 64),
                                         (1, 256, 256, 2, 120), (1, 192, 320, 2, 80), (1, 448, 192, 2, 160),
                                         (1, 320, 256, 2, 128), (1, 256, 192, 2, 192), (1, 192, 256, 2, 16),
                                         (1, 256, 320, 2, 48), (1, 192, 192, 2, 176)])
def test_flash_attention_f32_kernel_matches_plain(gen, b, lq, lk, h, d):
    """K6 in f32 (csrc/attention_f32.cu) at unpadded heads (d 40, 80, 160 of
    SD1.5 and 64 at the core's widths of the same d; 128 and 192; 16, 48,
    120 and 176 at the next width up, 40, 64, 128 and 192, with zeroed
    columns), Lq != Lk among them and L = 192, 320, 448 not multiples of
    128, q of std 3 (peaked softmax): f32 out within 1e-4 of the largest
    output (64-key tiles against the plain version's 256/512-key chunks),
    counted by flash_launches_f32 alone."""
    q = 3.0 * torch.randn(b, lq, h, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, lk, h, d, generator=gen, device="cuda") for _ in range(2))
    scale = d ** -0.5
    before = (attention.flash_launches, attention.flash_launches_f32)
    out = attention.flash_attention(q, k, v, scale)
    assert (attention.flash_launches, attention.flash_launches_f32) == (before[0], before[1] + 1)
    ref = attention.flash_attention_plain(q, k, v, scale)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("m,c", [(4096, 320), (1000, 640), (67, 1280), (13, 8), (257, 64), (999, 1000),
                                 (5, 1536), (300, 768), (65536, 320)])
def test_layernorm_f32_kernel_matches_plain(gen, m, c):
    """K4 on f32 rows (an f32 UNet's norm1/norm2/norm3): f32 statistics and
    normalize, within 1e-6 of the largest output (the statistics' sum order,
    rsqrt's last bits), counted by launches_f32 alone; widths with 1 to 12
    16-byte vectors a lane, up to the refiner's 1536."""
    x = 1.0 + 2.0 * torch.randn(1, m, c, generator=gen, device="cuda")
    s, bias = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda"), 0.1 * torch.randn(c, generator=gen, device="cuda")
    before = (layernorm.launches, layernorm.launches_f32)
    out = layernorm.layer_norm_one_pass(x, s, bias)
    assert (layernorm.launches, layernorm.launches_f32) == (before[0], before[1] + 1)
    ref = layernorm.layer_norm_one_pass_plain(x, s, bias)
    assert out.dtype == torch.float32 and (out - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.parametrize("b,c,h,w,act,eps", [(2, 2560, 8, 8, "silu", 1e-5), (2, 2560, 16, 16, None, 1e-6),
                                               (1, 4096, 4, 4, "silu", 1e-5), (2, 2056, 4, 4, None, 1e-5)])
@pytest.mark.parametrize("tpu", [False, True])
def test_group_norm_f32_two_vectors_matches_plain(gen, b, c, h, w, act, eps, tpu):
    """f32 rows wider than 512 threads of 4 channels (SD1.5's up blocks'
    2560-channel skip concatenations in an f32 UNet): two 16-byte vectors a
    thread, both epilogues, within 2e-5 of the largest output, counted by
    launches_f32 alone."""
    x = (0.5 + 3.0 * torch.randn(b, c, h, w, generator=gen, device="cuda")).to(memory_format=torch.channels_last)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    before = (groupnorm.launches, groupnorm.launches_f32)
    out = groupnorm.group_norm(x, gamma, beta, 32 if c % 32 == 0 else 8, eps, act, tpu_numerics=tpu)
    assert (groupnorm.launches, groupnorm.launches_f32) == (before[0], before[1] + 1)
    plain = groupnorm.group_norm_tpu_plain if tpu else groupnorm.group_norm_plain
    ref = plain(x, gamma, beta, 32 if c % 32 == 0 else 8, eps, act)
    assert out.dtype == torch.float32 and out.stride() == x.stride()
    assert (out - ref).abs().max() <= 2e-5 * ref.abs().max()


@pytest.mark.parametrize("m,c", [(4096, 320), (1000, 640), (64, 1280), (3, 2048), (4099, 320), (1003, 640),
                                 (67, 1280), (13, 8), (257, 64), (999, 1000), (5, 2048), (65536, 320)])
def test_layernorm_kernel_matches_plain(gen, m, c):
    """Same bf16 rounding points; f32 sum order and rsqrt differ: |diff| <= 1%
    of the largest output, and >= 99% of elements equal.  Ragged row counts
    (not multiples of a warp's or a block's rows) at the UNet's widths,
    widths with 1 to 8 vectors a lane and an idle slot (C 1000), and the
    main path's rows 65536, C320."""
    x = (1.0 + 2.0 * torch.randn(1, m, c, generator=gen, device="cuda")).to(torch.bfloat16)
    s, bias = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda"), 0.1 * torch.randn(c, generator=gen, device="cuda")
    before = layernorm.launches
    out = layernorm.layer_norm_one_pass(x, s, bias)
    assert layernorm.launches == before + 1
    ref = layernorm.layer_norm_one_pass_plain(x, s, bias)
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert (out == ref).float().mean() >= 0.99


def _block_args(gen, b, l, c, h, bf=torch.bfloat16):
    """K5's inputs in dtype bf (bf16, or f32 for its f32 variant), bo f32."""
    d = c // h
    dp = attention.pad_head_dim(d)

    def rows(w):  # (C, C) torch-layout weight -> head-padded (H*dp, C)
        return torch.nn.functional.pad(w.reshape(h, d, c), (0, 0, 0, dp - d)).reshape(h * dp, c)

    w = [torch.randn(c, c, generator=gen, device="cuda") * c ** -0.5 for _ in range(4)]
    wq = (rows(3.0 * w[0]) * (attention.LOG2E / d ** 0.5)).to(bf).contiguous()
    wk, wv = rows(w[1]).to(bf).contiguous(), rows(w[2]).to(bf).contiguous()
    wo = torch.nn.functional.pad(w[3].reshape(c, h, d), (0, dp - d)).reshape(c, h * dp).to(bf).contiguous()
    bo = 0.05 * torch.randn(c, generator=gen, device="cuda")
    x = torch.randn(b, l, c, generator=gen, device="cuda").to(bf)
    res = (0.05 * torch.randn(b, l, c, generator=gen, device="cuda")).to(bf)
    return x, res, wq, wk, wv, wo, bo, h


@pytest.mark.parametrize("b,l,c,h", [(2, 256, 320, 8), (1, 1024, 640, 8), (2, 256, 1280, 8), (1, 128, 128, 2),
                                     (8, 1024, 640, 10), (8, 256, 1280, 20), (2, 4096, 320, 5)])
def test_attention_block_kernel_matches_plain(gen, b, l, c, h):
    """K5 vs its plain version: bf16 Q/K/V and packed rounding points are the
    same; online vs one-pass softmax and f32 product order differ: |diff|
    <= 1% of the largest attention-plus-projection term (out - residual -
    bo).  Scores of std ~4.3 bits peak each query's softmax on a few keys, so
    that term is of order 1, beside a small residual and bo.  The last case
    is a 128-token block (one 128-row attention block, one 128-key tile; C
    128 takes the out product's 64-column tiles); the two before it are
    SDXL's sites at 512^2 (heads of d 64, no padding), and SD2.1's level 0
    (5 heads of 64: H*D_pad 320, the Q/K/V product's 64-column tiles)."""
    args = _block_args(gen, b, l, c, h)
    x, res, bo = args[0], args[1], args[6]
    before = (attention.block_launches, attention.launches)
    out = attention.attention_block_fused(*args)
    assert (attention.block_launches, attention.launches) == (before[0] + 1, before[1])
    ref = attention.attention_block_fused_plain(*args)
    term = ref.float() - res.float() - bo
    assert term.abs().max() >= 0.5
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * term.abs().max()


@pytest.mark.parametrize("b,l,c,h", [(16, 4096, 320, 8), (16, 1024, 640, 8), (16, 256, 1280, 8), (2, 384, 320, 8),
                                     (2, 640, 640, 8), (2, 4096, 320, 5), (2, 384, 320, 5)])
def test_attention_block_stages_match_plain_stages(gen, b, l, c, h):
    """Each of K5's three kernels against its plain stage on the previous
    kernel's output, at the three main-path shapes of configuration (b) and
    at L = 384 and 640, where the attention takes K1's 2-warpgroup blocks (L
    % 256 != 0), and at SD2.1's H*D_pad 320 (the Q/K/V product's 64-column
    tiles).  Q, K, V: f32 products rounded to bf16, only the sum order
    differs: >= 99% bit-equal, the rest within 1 ulp of the product's terms
    (|x| |W|^T).  packed: K1's function on the kernel's Q, K, V, within 1% of
    its largest output; padded head columns exactly 0.  out: >= 99% equal to
    the plain epilogue on the kernel's packed heads, and the whole block
    within 1% of the largest attention-plus-projection term."""
    args = _block_args(gen, b, l, c, h)
    x, res, wq, wk, wv, wo, bo, _ = args
    dp = attention.pad_head_dim(c // h)
    q, k, v, packed, out = attention.attention_block_stages(*args)
    for got, w in ((q, wq), (k, wk), (v, wv)):
        want = (x.float() @ w.float().t()).to(torch.bfloat16)
        mag = x.float().abs() @ w.float().abs().t()
        assert (got == want).float().mean() >= 0.99
        assert _bf16_ulps(got, want, mag).max() <= 1
    att_ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert (packed.float() - att_ref.float()).abs().max() <= 1e-2 * att_ref.float().abs().max()
    assert (packed.reshape(b, l, h, dp)[..., c // h:] == 0).all()
    out_ref = (packed.float() @ wo.float().t() + bo + res.float()).to(torch.bfloat16)
    assert (out == out_ref).float().mean() >= 0.99
    ref = attention.attention_block_fused_plain(*args)
    term = ref.float() - res.float() - bo
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * term.abs().max()


@pytest.mark.parametrize("b,l,c,h", [(2, 4096, 320, 8), (2, 1024, 640, 8), (2, 256, 1280, 8), (1, 4096, 640, 8),
                                     (1, 1024, 1280, 8), (2, 4096, 320, 5), (3, 192, 128, 2)])
def test_attention_block_f32_stages_match_plain_stages(gen, b, l, c, h):
    """K5 in f32 (csrc/attention_f32.cu's block entry) at an f32 pipeline's
    sites under SASPA_ATTN_MEGAKERNEL=1, reduced in batch: 512^2's levels
    0-2, 1024^2's levels 1-2, SD2.1's level 0 (H*D_pad 320), and 3 x 192
    tokens (576 rows: a ragged last row tile; L % 128 != 0, which the FFMA
    core takes).  Q, K, V against x W^T in f32 within 1e-5 of each
    element's |x| |W|^T (sum order only); packed against K1's plain version
    on the kernel's Q, K, V within 1e-4 of its largest output (as K1 f32),
    padded columns exactly 0; out against packed wo^T + bo + residual within
    1e-5 of |packed| |wo|^T + |bo| + |residual|; the whole block within 2e-5
    of the largest attention-plus-projection term.  Counted by
    block_launches_f32 alone (not block_launches, not K1's counters).  The
    wrapper is told the real head dim, as the UNet tells it."""
    args = _block_args(gen, b, l, c, h, torch.float32)
    x, res, wq, wk, wv, wo, bo, _ = args
    dp = attention.pad_head_dim(c // h)
    counters = ("block_launches", "block_launches_f32", "launches", "launches_f32", "launches_f32_heads")
    before = [getattr(attention, n) for n in counters]
    q, k, v, packed, out = attention.attention_block_stages(*args, head_dim=c // h)
    assert [getattr(attention, n) for n in counters] == [before[0], before[1] + 1, *before[2:]]
    assert all(t.dtype == torch.float32 for t in (q, k, v, packed, out)) and out.shape == x.shape
    for got, w in ((q, wq), (k, wk), (v, wv)):
        want = x @ w.t()
        mag = x.abs() @ w.abs().t()
        assert ((got - want).abs() <= 1e-5 * mag).all()
    att_ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert (packed - att_ref).abs().max() <= 1e-4 * att_ref.abs().max()
    assert (packed.reshape(b, l, h, dp)[..., c // h:] == 0).all()
    out_ref = packed @ wo.t() + bo + res
    mag = packed.abs() @ wo.abs().t() + bo.abs() + res.abs()
    assert ((out - out_ref).abs() <= 1e-5 * mag).all()
    ref = attention.attention_block_stages_plain(*args)[4]
    term = ref - res - bo
    assert term.abs().max() >= 0.5
    assert (out - ref).abs().max() <= 2e-5 * term.abs().max()


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 256, 256, 8, 40), (1, 512, 512, 4, 80), (1, 256, 256, 2, 160),
                                          (2, 384, 384, 2, 64), (1, 128, 320, 2, 40), (1, 1024, 1024, 1, 40)])
def test_flash_attention_kernel_matches_plain(gen, b, lq, lk, h, d):
    """K6 vs its plain version on unpadded (B, L, H, d) heads: the same bf16
    rounding of q * scale, P and the output; the kernel's 64-key tiles round P
    against another running max than the plain version's 512/256/Lk-key
    chunks: |diff| <= 1% of the largest output.  q of std 3 peaks each
    query's softmax on a few keys.  L = 384 and 320 are not multiples of 128;
    the fifth case has Lq != Lk."""
    scale = d ** -0.5
    q = (3.0 * torch.randn(b, lq, h, d, generator=gen, device="cuda")).to(torch.bfloat16)
    k, v = (torch.randn(b, lk, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    before = attention.flash_launches
    out = attention.flash_attention(q, k, v, scale)
    assert attention.flash_launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, scale)
    assert out.shape == ref.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.parametrize("b,lq,lk,h,d", [
    (2, 512, 512, 3, 40),      # 256-row blocks, 128-key tiles, the trimmed dc <= 40 path, three heads
    (1, 384, 384, 2, 40),      # 128-row blocks (Lq % 256 != 0)
    (2, 320, 320, 2, 40),      # 64-row blocks and 64-key tiles (L % 128 != 0)
    (1, 256, 1024, 1, 40),     # Lq < Lk, one head
    (1, 1024, 256, 2, 40),     # Lq > Lk, several 256-row blocks over two K/V tiles
    (2, 256, 256, 2, 16),      # dc 16 on the trimmed path
    (1, 512, 512, 2, 56),      # dc 56: Q.K^T and P.V at the padded 64
    (2, 512, 384, 2, 80),      # dc 80: two boxes, the second 16 columns wide
    (1, 384, 512, 3, 160),     # dc 160: three boxes, 128-row blocks
    (1, 320, 320, 2, 160),     # dc 160, 64-row blocks
    (1, 4800, 4800, 8, 80),    # the capped bucket's level 1: 64-row blocks (4800 % 128 != 0)
])
def test_flash_attention_wgmma_kernel_peaked(gen, b, lq, lk, h, d):
    """The wgmma kernel's block shapes, widths and box layouts on peaked
    scores (q of std 3): every head's dc columns come from TMA boxes 64
    columns wide whose columns past dc are zero-filled, so a box that read a
    neighbouring head, a misplaced tile or a wrong block size changes the
    output.  |diff| <= 1% of the largest output, as in chip_smoke.py."""
    scale = d ** -0.5
    q = (3.0 * torch.randn(b, lq, h, d, generator=gen, device="cuda")).to(torch.bfloat16)
    k, v = (torch.randn(b, lk, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    before = attention.flash_launches
    out = attention.flash_attention(q, k, v, scale)
    assert attention.flash_launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, scale)
    assert ref.float().abs().max() >= 2.0  # peaked: a few keys carry each output
    assert out.shape == ref.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.zeros(1, 256, 64, device="cuda")  # f32 on the card: the f32 kernels take head dims 64-192 and 512
    with pytest.raises(ValueError):
        attention.flash_attention_packed(x, x, x, 4)  # head dim 16
    with pytest.raises(ValueError):  # f32 at d_pad 64: the FFMA core's 64-row tiles take L % 64 == 0
        x96 = torch.zeros(1, 96, 64, device="cuda")
        attention.flash_attention_packed(x96, x96, x96, 1)
    with pytest.raises(TypeError):  # f64
        attention.flash_attention_packed(x.double(), x.double(), x.double(), 1)
    for l in (80, 96):  # f32 and bf16 at d 512: the kernels' 64-row query tiles take L % 64 == 0
        x512 = torch.zeros(1, l, 512, device="cuda")
        with pytest.raises(ValueError):
            attention.flash_attention_packed(x512, x512, x512, 1)
        with pytest.raises(ValueError):
            attention.flash_attention_packed(*(x512.to(torch.bfloat16),) * 3, 1)
    y = x[:, :, :40].to(torch.bfloat16).contiguous()  # head dim 40: not padded
    with pytest.raises(ValueError):
        attention.flash_attention_packed(y, y, y, 1)
    for dp in (64, 128, 192):  # L = 192: the wgmma kernel's blocks take 128 or 256 rows
        x192 = torch.zeros(1, 192, 2 * dp, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError):
            attention.flash_attention_packed(x192, x192, x192, 2)
    ones = torch.ones(64, device="cuda")
    with pytest.raises(TypeError):  # f64 activations
        groupnorm.group_norm(x.reshape(1, 64, 16, 16).double().to(memory_format=torch.channels_last), ones, ones)
    with pytest.raises(ValueError):  # 3-d
        groupnorm.group_norm(x.reshape(1, 64, 256), ones, ones)
    wide = torch.zeros(1, 2060, 2, 2, device="cuda").to(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # f32 rows of 2060 channels: past 512 threads of 4, not a multiple of 8
        groupnorm.group_norm(wide, torch.ones(2060, device="cuda"), torch.ones(2060, device="cuda"), 4)
    with pytest.raises(ValueError):  # contiguous NCHW, not channels-last
        groupnorm.group_norm(y.reshape(1, 40, 16, 16), ones[:40], ones[:40])
    with pytest.raises(TypeError):  # f64
        layernorm.layer_norm_one_pass(x.double(), ones, ones)
    with pytest.raises(ValueError):  # C not a multiple of 8
        layernorm.layer_norm_one_pass(y[:, :, :36].contiguous(), ones[:36], ones[:36])
    xo = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(1, 64, 64)
    with pytest.raises(ValueError):  # contiguous but 8-byte aligned: the kernel's vector loads need 16
        layernorm.layer_norm_one_pass(xo, ones, ones)
    gargs = list(_geglu_args(gen, 64, 64))
    with pytest.raises(TypeError):  # f32 activations
        geglu.fused_ln_geglu(gargs[0].float(), *gargs[1:])
    with pytest.raises(ValueError):  # contiguous but 8-byte aligned x: TMA and the vector loads need 16
        geglu.fused_ln_geglu(xo, *gargs[1:])
    g96 = list(_geglu_args(gen, 64, 96))
    with pytest.raises(ValueError):  # C = 96: not a multiple of 64
        geglu.fused_ln_geglu(*g96)
    w = torch.zeros(40, 40, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):  # head dim 40: not padded
        attention.attention_block_fused(y, y, w, w, w, w, ones[:40], 1)
    x64 = torch.zeros(1, 64, 128, dtype=torch.bfloat16, device="cuda")
    w128 = torch.zeros(128, 128, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):  # L = 64: K1's attention blocks take L % 128 == 0
        attention.attention_block_fused(x64, x64, w128, w128, w128, w128, torch.ones(128, device="cuda"), 2)
    x96, w128f = torch.zeros(1, 96, 128, device="cuda"), w128.float()
    with pytest.raises(ValueError):  # f32 at L = 96: the FFMA core's tiles take L % 64 == 0
        attention.attention_block_fused(x96, x96, w128f, w128f, w128f, w128f, torch.ones(128, device="cuda"), 2)
    with pytest.raises(TypeError):  # f32 activations, bf16 weights
        attention.attention_block_fused(x64.float(), x64.float(), w128, w128, w128, w128,
                                        torch.ones(128, device="cuda"), 2)
    g36 = torch.zeros(1, 36, 4, 4, dtype=torch.bfloat16, device="cuda").to(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # C = 36: not a whole number of 16-byte vectors
        groupnorm.group_norm(g36, ones[:36], ones[:36])
    z = torch.zeros(1, 256, 2, 40, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):  # f64
        attention.flash_attention(z.double(), z.double(), z.double(), 0.1)
    with pytest.raises(ValueError):  # L not a multiple of 64
        attention.flash_attention(z[:, :200], z[:, :200], z[:, :200], 0.1)
    with pytest.raises(ValueError):  # head dim 512: past K6's padded dims
        attention.flash_attention(*(torch.zeros(1, 256, 1, 512, dtype=torch.bfloat16, device="cuda"),) * 3, 0.1)
    zs = torch.zeros(1, 256, 2, 48, dtype=torch.bfloat16, device="cuda")[..., :40]
    with pytest.raises(ValueError):  # not contiguous
        attention.flash_attention(zs, zs, zs, 0.1)
    za = torch.zeros(256 * 2 * 40 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(1, 256, 2, 40)
    with pytest.raises(ValueError):  # contiguous but 8-byte aligned: TMA needs 16
        attention.flash_attention(za, za, za, 0.1)


def test_graphed_decodes_match_eager(gen):
    """The prompt tools' decode loops from CUDA graphs (utils/graphs.py)
    give the eager loops' ids, on the graph's first inputs and on new ones."""
    import numpy as np

    from saspa_tpu_torch.models import blip_caption as bc
    from saspa_tpu_torch.models import t5 as t5m
    from saspa_tpu_torch.utils import graphs

    cap = bc.TorchBlipCaptioner(vit=bc.BlipViTConfig(image_size=32, width=32, layers=1, heads=2),
                                text=bc.BlipTextConfig(width=32, layers=2, heads=2, intermediate=64), max_len=12,
                                device="cuda", seed=1)
    t5 = t5m.TorchKeytotextT5(cfg=t5m.T5Config(d_model=32, d_kv=16, d_ff=64, layers=2, heads=2), max_new_tokens=8,
                              device="cuda", seed=2)
    rs = np.random.RandomState(0)
    for _ in range(2):
        img = rs.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8)
        key = t5.next_key()
        ids, mask = t5.encode_batch(["airplane", "a jet, of type 747"])
        runs = []
        for enabled in (True, False):
            graphs.ENABLED = enabled
            try:
                runs.append((cap.caption_ids(img, return_margins=True),
                             t5m.t5_generate_ids(t5.model, ids, mask, 8, key=key, return_margins=True)))
            finally:
                graphs.ENABLED = True
        for graphed, eager in zip(*runs):
            assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
