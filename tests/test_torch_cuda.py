"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: these need an NVIDIA Hopper card and nvcc, and skip
elsewhere.  On the card:  python -m pytest tests/test_torch_cuda.py -m cuda
(chip_smoke.py runs the same checks at the main path's full shapes).
"""

import math

import pytest
import torch

from saspa_tpu_torch.ops import attention, geglu

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


@pytest.mark.parametrize("m,c", [(256, 64), (96, 128), (32, 320)])
def test_ln_geglu_kernel_matches_plain(gen, m, c):
    """Same bf16 rounding points; f32 summation order differs: |diff| <= 1%
    of the largest output.  Row counts that are not multiples of 64 too."""
    f = 4 * c

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    bf = torch.bfloat16
    args = (rn(1, m, c).to(bf), 1.0 + rn(c, std=0.1), rn(c, std=0.1), rn(2 * f, c, std=c ** -0.5).to(bf),
            rn(2 * f, std=0.1).to(bf), rn(c, f, std=f ** -0.5).to(bf), rn(c, std=0.1).to(bf))
    out = geglu.fused_ln_geglu(*args)
    ref = geglu.fused_ln_geglu_plain(*args)
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.zeros(1, 256, 64, device="cuda")  # f32 on the card
    with pytest.raises(TypeError):
        attention.flash_attention_packed(x, x, x, 1)
    y = x[:, :, :40].to(torch.bfloat16).contiguous()  # head dim 40: not padded
    with pytest.raises(ValueError):
        attention.flash_attention_packed(y, y, y, 1)
