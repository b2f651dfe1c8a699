// One-pass LayerNorm for Hopper (K4).
//
// Replaces saspa_tpu/ops/layernorm.py::layer_norm_one_pass (Pallas kernel
// _ln_kernel).  For x of shape (M, C) bf16:
//     mean = E[x], var = E[x^2] - mean^2 (f32, no clamp), rs = rsqrt(var + eps)
//     out  = bf16(bf16(bf16(x - bf16(mean)) * bf16(rs * scale)) + bf16(bias))
// i.e. the normalize in bf16 in flax's association, with a bf16 rounding
// after each op, exactly as _ln_kernel and models/unet.py::_ln32_forward.
//
// What bounds it on an H100: a handful of flops per element against 4 bytes
// (one bf16 read, one bf16 write): HBM bandwidth.  The TPU kernel kept a
// q-block of rows in VMEM for one read and one write; here one warp owns one
// row (C <= 2048: up to 8 16-byte vectors per lane) and keeps it in
// registers between the statistics and the normalize, so x is read once and
// the output written once, with 16-byte loads and stores.
#include "mma_bf16.cuh"

namespace saspa {

constexpr int LN_WARPS = 4;  // rows per block
constexpr int LN_MAXV = 8;   // 16-byte vectors per lane: C <= 32 * 8 * 8

__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int C, float eps) {
    const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (row >= M) return;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * C);
    const int nv = C / 8;

    uint4 v[LN_MAXV];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXV; ++j) {
        const int idx = lane + j * 32;
        if (idx < nv) {
            v[j] = xr[idx];
            const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float f = __bfloat162float(e[i]);
                s1 += f;
                s2 += f * f;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 / C;
    const float rs = rsqrtf(s2 / C - mean * mean + eps);
    const float mb = round_bf16(mean);

#pragma unroll
    for (int j = 0; j < LN_MAXV; ++j) {
        const int idx = lane + j * 32;
        if (idx < nv) {
            const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
            __align__(16) bf16 o[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int col = idx * 8 + i;
                const float t1 = round_bf16(__bfloat162float(e[i]) - mb);
                const float t2 = round_bf16(t1 * round_bf16(rs * scale[col]));
                o[i] = __float2bfloat16_rn(t2 + round_bf16(bias[col]));
            }
            orow[idx] = *reinterpret_cast<const uint4*>(o);
        }
    }
}

}  // namespace saspa

// x, out: (M, C) bf16; scale, bias: (C,) f32; all contiguous on the device;
// C % 8 == 0 and C <= 2048.  Returns a cudaError_t (0 on success).
extern "C" int saspa_layernorm(const void* x, const void* scale, const void* bias, void* out, int M, int C,
                               float eps, void* stream) {
    using saspa::bf16;
    if (M <= 0 || C <= 0 || C % 8 || C > 32 * 8 * saspa::LN_MAXV) return (int)cudaErrorInvalidValue;
    const int blocks = (M + saspa::LN_WARPS - 1) / saspa::LN_WARPS;
    saspa::layernorm_kernel<<<blocks, saspa::LN_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<bf16*>(out), M, C, eps);
    return (int)cudaGetLastError();
}
