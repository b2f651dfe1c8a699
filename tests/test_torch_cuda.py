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


@pytest.mark.parametrize("b,l,h", [(1, 256, 1), (2, 1024, 1), (1, 96, 2), (8, 4096, 1)])
def test_attention_packed_f32_kernel_matches_plain(gen, b, l, h):
    """f32 at head dim 512 (the XL VAE's one head under SASPA_XL_VAE_FP32=1),
    peaked scores (q of 3x the unit scale): f32 out within 1e-4 of the
    largest output (online against one-pass softmax, other product sum
    orders), counted by launches_f32 alone; L = 96 is three 32-key tiles,
    L = 4096 at B8 the VAE's decode shape."""
    d = 512
    q = (torch.randn(b, l, h * d, generator=gen, device="cuda") * (3.0 * attention.LOG2E / math.sqrt(d)))
    k, v = (torch.randn(b, l, h * d, generator=gen, device="cuda") for _ in range(2))
    before = (attention.launches, attention.launches_f32)
    out = attention.flash_attention_packed(q, k, v, h)
    assert (attention.launches, attention.launches_f32) == (before[0], before[1] + 1)
    ref = attention.flash_attention_packed_plain(q, k, v, h)
    assert out.dtype == torch.float32 and ref.abs().max() >= 1.5
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


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


def _block_args(gen, b, l, c, h):
    d = c // h
    dp = attention.pad_head_dim(d)
    bf = torch.bfloat16

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
                                     (8, 1024, 640, 10), (8, 256, 1280, 20)])
def test_attention_block_kernel_matches_plain(gen, b, l, c, h):
    """K5 vs its plain version: bf16 Q/K/V and packed rounding points are the
    same; online vs one-pass softmax and f32 product order differ: |diff|
    <= 1% of the largest attention-plus-projection term (out - residual -
    bo).  Scores of std ~4.3 bits peak each query's softmax on a few keys, so
    that term is of order 1, beside a small residual and bo.  The last case
    is a 128-token block (one 128-row attention block, one 128-key tile; C
    128 takes the out product's 64-column tiles); the two before it are
    SDXL's sites at 512^2 (heads of d 64, no padding)."""
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
                                     (2, 640, 640, 8)])
def test_attention_block_stages_match_plain_stages(gen, b, l, c, h):
    """Each of K5's three kernels against its plain stage on the previous
    kernel's output, at the three main-path shapes of configuration (b) and
    at L = 384 and 640, where the attention takes K1's 2-warpgroup blocks (L
    % 256 != 0).  Q, K, V: f32 products rounded to bf16, only the sum order
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
    x = torch.zeros(1, 256, 64, device="cuda")  # f32 on the card: the f32 kernel takes head dim 512 only
    with pytest.raises(ValueError):
        attention.flash_attention_packed(x, x, x, 1)
    with pytest.raises(TypeError):  # f64
        attention.flash_attention_packed(x.double(), x.double(), x.double(), 1)
    x512 = torch.zeros(1, 80, 512, device="cuda")
    with pytest.raises(ValueError):  # f32 at L = 80: the f32 kernel's tiles take L % 32 == 0
        attention.flash_attention_packed(x512, x512, x512, 1)
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
    wide = torch.zeros(1, 2056, 2, 2, device="cuda").to(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # f32 rows of 2056 channels: past 512 threads of 4
        groupnorm.group_norm(wide, torch.ones(2056, device="cuda"), torch.ones(2056, device="cuda"), 8)
    with pytest.raises(ValueError):  # contiguous NCHW, not channels-last
        groupnorm.group_norm(y.reshape(1, 40, 16, 16), ones[:40], ones[:40])
    with pytest.raises(TypeError):
        layernorm.layer_norm_one_pass(x, ones, ones)
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
    g36 = torch.zeros(1, 36, 4, 4, dtype=torch.bfloat16, device="cuda").to(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # C = 36: not a whole number of 16-byte vectors
        groupnorm.group_norm(g36, ones[:36], ones[:36])
    z = torch.zeros(1, 256, 2, 40, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        attention.flash_attention(z.float(), z.float(), z.float(), 0.1)
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
