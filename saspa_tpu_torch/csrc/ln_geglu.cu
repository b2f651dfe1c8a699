// Fused LayerNorm + GEGLU feed-forward for Hopper (K2).
//
// Replaces saspa_tpu/ops/geglu.py::fused_ln_geglu (Pallas kernel
// _ln_geglu_kernel).  For x of shape (M, C) bf16 (M = batch * tokens):
//     [h | g] = LN(x) W1^T + b1            W1: (2F, C), b1: (2F,)
//     hid     = bf16(h * gelu_erf(g))      F = 4C
//     out     = bf16(bf16(hid W2^T) + b2) + x        W2: (C, F), b2: (C,)
// with every rounding point of the TPU kernel: LN statistics in f32 with the
// fast variance E[x^2] - E[x]^2 (no clamp), the normalize pass in bf16
// ((x - bf16(mean)) * bf16(rsqrt(var + eps) * scale) + bf16(bias)), b1 rounded
// to bf16 and added to the f32 accumulators, gelu on f32 through Eigen's
// rational erf polynomial (geglu.py::_erf_f32), hid rounded to bf16 before the
// second product, and the bf16 epilogue (out -> bf16) + b2 + x.
//
// What bounds it on an H100: both products are 2*M*C*F flops each against
// M*(2C + F) bf16 activations and 3*C*F weights, i.e. ~1000 flops per byte at
// the UNet's shapes -- tensor-core throughput bounds it.  The TPU kernel kept
// the (rows x F) hidden in VMEM; F reaches 5120 here, so a 64-row hidden
// (640 KB) does not fit in shared memory beside an f32 output tile.  This
// first design therefore runs two launches behind one wrapper:
//   (a) ln_geglu_hidden: LN prologue on the A tile + x.[W1h | W1g] + the GEGLU
//       epilogue, writing hid as bf16 to a scratch buffer;
//   (b) geglu_out: hid.W2 + the (-> bf16) + b2 + x epilogue.
// Since the TPU kernel itself rounds hid to bf16 before W2, this is the same
// function; only the hidden's HBM round trip (write + read of M*F bf16) is
// extra.  Both are 64x64-tile bf16 mma.sync GEMMs with f32 accumulation,
// 4 warps of 32x32, a 32-deep k step staged through shared memory.
#include "gemm_bf16.cuh"

namespace saspa {

// Eigen generic_fast_erf_float, the polynomial of geglu.py::_erf_f32.
__device__ __forceinline__ float erf_poly(float x) {
    x = fminf(fmaxf(x, -3.832506856900711f), 3.832506856900711f);
    const float x2 = x * x;
    float a = -2.72614225801306e-10f;
    a = a * x2 + 2.77068142495902e-08f;
    a = a * x2 + -2.10102402082508e-06f;
    a = a * x2 + -5.69250639462346e-05f;
    a = a * x2 + -7.34990630326855e-04f;
    a = a * x2 + -2.95459980854025e-03f;
    a = a * x2 + -1.60960333262415e-02f;
    a = a * x;
    float b = -1.45660718464996e-05f;
    b = b * x2 + -2.13374055278905e-04f;
    b = b * x2 + -1.68282697438203e-03f;
    b = b * x2 + -7.37332916720468e-03f;
    b = b * x2 + -1.42647390514189e-02f;
    return a / b;
}

__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.0f + erf_poly(x * 0.70710678118654752f));
}

// (a) grid (F/64, ceil(M/64)): hid[m0:m0+64, n0:n0+64]
__global__ void __launch_bounds__(GM_THREADS)
ln_geglu_hidden_kernel(const bf16* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ lnb,
                       const bf16* __restrict__ w1, const bf16* __restrict__ b1, bf16* __restrict__ hid,
                       int M, int C, int F, float eps) {
    __shared__ __align__(16) uint16_t smem[3 * GM_BM * GM_S];
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sBh = sA + GM_BM * GM_S;
    bf16* sBg = sBh + GM_BN * GM_S;
    __shared__ float sMean[GM_BM];  // bf16(mean) as a float
    __shared__ float sRs[GM_BM];    // rsqrt(var + eps), f32

    const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2;
    const bf16* xb = x + (size_t)m0 * C;
    const int rows = min(GM_BM, M - m0);

    // LN statistics: each warp takes 16 rows
    for (int r = warp * 16; r < min(warp * 16 + 16, rows); ++r) {
        const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(xb + (size_t)r * C);
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < C / 2; c += 32) {
            float2 v = __bfloat1622float2(row[c]);
            s1 += v.x + v.y;
            s2 += v.x * v.x + v.y * v.y;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
            const float mean = s1 / C;
            const float var = s2 / C - mean * mean;
            sMean[r] = round_bf16(mean);
            sRs[r] = rsqrtf(var + eps);
        }
    }
    __syncthreads();

    float acch[2][4][4], accg[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acch[i][j][e] = accg[i][j][e] = 0.f;

    for (int k0 = 0; k0 < C; k0 += GM_BK) {
        load_rows_async(sBh, w1 + (size_t)n0 * C + k0, C);
        load_rows_async(sBg, w1 + (size_t)(F + n0) * C + k0, C);
        cp_async_commit();
        // A tile: the bf16 normalize pass, 8 contiguous columns per step
        for (int i = threadIdx.x; i < GM_BM * (GM_BK / 8); i += GM_THREADS) {
            const int r = i / (GM_BK / 8), c = (i % (GM_BK / 8)) * 8;
            if (r >= rows) {
                *reinterpret_cast<uint4*>(sA + r * GM_S + c) = make_uint4(0, 0, 0, 0);
                continue;
            }
            const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)r * C + k0 + c);
            const bf16* xv = reinterpret_cast<const bf16*>(&raw);
            __align__(16) bf16 out[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int col = k0 + c + e;
                const float t1 = round_bf16(__bfloat162float(xv[e]) - sMean[r]);
                const float mul = round_bf16(sRs[r] * lns[col]);
                const float t2 = round_bf16(t1 * mul);
                out[e] = __float2bfloat16_rn(t2 + round_bf16(lnb[col]));
            }
            *reinterpret_cast<uint4*>(sA + r * GM_S + c) = *reinterpret_cast<const uint4*>(out);
        }
        cp_async_wait<0>();
        __syncthreads();
        warp_mma_step(acch, sA, sBh, wm, wn, lane);
        warp_mma_step(accg, sA, sBg, wm, wn, lane);
        __syncthreads();
    }

    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
            const float bh0 = __bfloat162float(b1[col]), bh1 = __bfloat162float(b1[col + 1]);
            const float bg0 = __bfloat162float(b1[F + col]), bg1 = __bfloat162float(b1[F + col + 1]);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
                if (row >= M) continue;
                const float h0 = acch[mi][ni][2 * half] + bh0, h1 = acch[mi][ni][2 * half + 1] + bh1;
                const float g0 = accg[mi][ni][2 * half] + bg0, g1 = accg[mi][ni][2 * half + 1] + bg1;
                *reinterpret_cast<__nv_bfloat162*>(hid + (size_t)row * F + col) =
                    __floats2bfloat162_rn(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
            }
        }
    }
}

// (b) grid (C/64, ceil(M/64)): out[m0:m0+64, n0:n0+64]
__global__ void __launch_bounds__(GM_THREADS)
geglu_out_kernel(const bf16* __restrict__ hid, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                 const bf16* __restrict__ x, bf16* __restrict__ out, int M, int C, int F) {
    __shared__ __align__(16) uint16_t smem[2 * GM_BM * GM_S];
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sB = sA + GM_BM * GM_S;
    const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2;

    float acc[2][4][4];
    zero_acc(acc);
    block_gemm_bt(acc, sA, sB, hid, F, w2, F, F, m0, n0, M);

    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
            const float c0 = __bfloat162float(b2[col]), c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
                if (row >= M) continue;
                const float2 xr = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * C + col));
                const float y0 = round_bf16(round_bf16(acc[mi][ni][2 * half]) + c0);
                const float y1 = round_bf16(round_bf16(acc[mi][ni][2 * half + 1]) + c1);
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) =
                    __floats2bfloat162_rn(y0 + xr.x, y1 + xr.y);
            }
        }
    }
}

}  // namespace saspa

// x, out: (M, C) bf16; lns, lnb: (C,) f32; w1: (2F, C) bf16 with the value
// rows first and the gate rows second; b1: (2F,) bf16; w2: (C, F) bf16;
// b2: (C,) bf16; hid: (M, F) bf16 scratch.  All contiguous on the device;
// C and F multiples of 64.  Returns a cudaError_t (0 on success).
extern "C" int saspa_ln_geglu(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* hid, void* out, int M, int C, int F,
                              float eps, void* stream) {
    using saspa::bf16;
    if (C % saspa::GM_BN || F % saspa::GM_BN || M <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int mb = (M + saspa::GM_BM - 1) / saspa::GM_BM;
    saspa::ln_geglu_hidden_kernel<<<dim3(F / saspa::GM_BN, mb), saspa::GM_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(lns), static_cast<const float*>(lnb),
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), static_cast<bf16*>(hid), M, C, F, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    saspa::geglu_out_kernel<<<dim3(C / saspa::GM_BN, mb), saspa::GM_THREADS, 0, s>>>(
        static_cast<const bf16*>(hid), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
        static_cast<const bf16*>(x), static_cast<bf16*>(out), M, C, F);
    return (int)cudaGetLastError();
}
