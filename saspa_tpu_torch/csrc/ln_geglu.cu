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
// rational erf polynomial (geglu.py::_erf_f32) with IEEE division, hid
// rounded to bf16 before the second product, and the bf16 epilogue
// (out -> bf16) + b2 + x.
//
// What bounds it on an H100: the two products, 6*M*C*F flops against
// M*(2C + F)-ish bf16 activations and 3*C*F weights (~1000 flops per byte at
// the UNet's shapes): tensor-core throughput, which only wgmma reaches.  The
// TPU kernel kept the (rows x F) hidden in VMEM; here it round-trips HBM as
// bf16 (the TPU kernel rounds it to bf16 before W2 too, so the function is
// the same).  Three launches behind one entry point:
//   1. ln_geglu_norm_kernel: K4's row-normalize (layernorm_row.cuh) writes
//      xn (M, C) bf16 once, instead of every N tile recomputing it;
//   2. ln_geglu_up_kernel: [h | g] = xn W1^T on wgmma, 128 rows x 64 hidden
//      columns a block.  Each stage's B is two 64-row TMA boxes of W1 (value
//      rows n0.., gate rows F + n0..) stacked into one 128-row operand, so
//      one m64n128k16 per 16-deep step gives every thread matching h and g
//      accumulators and the GEGLU epilogue is thread-local; writes hid;
//   3. ln_geglu_down_kernel: hid W2^T on wgmma, 128 rows x BN output
//      columns (BN = 160 where C % 160 == 0, else 64), epilogue + b2 + x.
// Both products walk their tiles with gemm_wgmma.cuh (shared with K5): TMA
// loads with the 128-byte swizzle into a 3-stage ring of full/empty
// mbarriers, fed by one thread of the second warpgroup, and two consumer
// warpgroups of 64 rows each with one wgmma group in flight.  A block needs <= 128 registers a thread and
// <= 110 KB of shared memory, so two blocks share an SM: one's epilogue
// (the erf polynomial and a division per hidden element on the CUDA cores)
// overlaps the other's products.  The blocks are persistent (two an SM) and
// walk the tiles N fastest, so the blocks at work share their A rows (xn,
// hid) and weight tiles in L2; the ring runs on across a block's tiles, so
// the next tile's first stages load during this tile's epilogue.
#include "gemm_wgmma.cuh"
#include "layernorm_row.cuh"

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

// ---- 1. the row-normalize ------------------------------------------------

template <int V>
__global__ void __launch_bounds__(LN_THREADS)
ln_geglu_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                     bf16* __restrict__ xn, int M, int C, int lanes, float eps) {
    extern __shared__ __align__(16) float ln_params[];
    layernorm_rows<V>(x, scale, bias, xn, ln_params, M, C, lanes, eps);
}

static const LayerNormKernel kNormKernels[LN_MAXV] = {
    ln_geglu_norm_kernel<1>, ln_geglu_norm_kernel<2>, ln_geglu_norm_kernel<3>, ln_geglu_norm_kernel<4>,
    ln_geglu_norm_kernel<5>, ln_geglu_norm_kernel<6>, ln_geglu_norm_kernel<7>, ln_geglu_norm_kernel<8>};

// ---- 2, 3. the products ----------------------------------------------------

// Persistent blocks over the (F / 64) x ceil(M / 128) tiles of hid: tile
// hid[m0:m0+128, n0:n0+64].
__global__ void __launch_bounds__(GG_THREADS, 2)
ln_geglu_up_kernel(const __grid_constant__ CUtensorMap mxn, const __grid_constant__ CUtensorMap mw1,
                   const bf16* __restrict__ b1, bf16* __restrict__ hid, int M, int C, int F) {
    __shared__ __align__(8) uint64_t bars[2 * GG_STAGES];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int nt = F / 64;

    // acc columns 0..63: h of hidden columns n0.., 64..127: g of the same columns
    auto load = [&](int n, int m, int j, uint32_t a, uint32_t b, uint32_t bar) {
        tma_load_2d(a, &mxn, j * 64, m * GG_BM, bar);
        tma_load_2d(b, &mw1, j * 64, n * 64, bar);
        tma_load_2d(b + 64 * 128, &mw1, j * 64, F + n * 64, bar);
    };
    auto epi = [&](int n, int m, float (&acc)[64]) {
        const int row0 = m * GG_BM + (threadIdx.x / 32) * 16 + g;  // warp w of the block holds rows 16w..16w+15
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int col = n * 64 + 8 * i + 2 * t;
            const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
            const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + F + col));
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = row0 + 8 * half;
                if (row >= M) continue;
                const float h0 = acc[4 * i + 2 * half] + bh.x, h1 = acc[4 * i + 2 * half + 1] + bh.y;
                const float g0 = acc[32 + 4 * i + 2 * half] + bg.x, g1 = acc[32 + 4 * i + 2 * half + 1] + bg.y;
                *reinterpret_cast<__nv_bfloat162*>(hid + (size_t)row * F + col) =
                    __floats2bfloat162_rn(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
            }
        }
    };
    gg_tiles<128>(smem, bars, C / 64, nt, nt * ((M + GG_BM - 1) / GG_BM), load, epi);
}

// Persistent blocks over the (C / BN) x ceil(M / 128) tiles of out: tile
// out[m0:m0+128, n0:n0+BN].
template <int BN>
__global__ void __launch_bounds__(GG_THREADS, 2)
ln_geglu_down_kernel(const __grid_constant__ CUtensorMap mhid, const __grid_constant__ CUtensorMap mw2,
                     const bf16* __restrict__ b2, const bf16* __restrict__ x, bf16* __restrict__ out, int M, int C,
                     int F) {
    __shared__ __align__(8) uint64_t bars[2 * GG_STAGES];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int nt = C / BN;

    auto load = [&](int n, int m, int j, uint32_t a, uint32_t b, uint32_t bar) {
        tma_load_2d(a, &mhid, j * 64, m * GG_BM, bar);
        tma_load_2d(b, &mw2, j * 64, n * BN, bar);
    };
    auto epi = [&](int n, int m, float (&acc)[BN / 2]) {
        const int row0 = m * GG_BM + (threadIdx.x / 32) * 16 + g;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int col = n * BN + 8 * i + 2 * t;
            const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = row0 + 8 * half;
                if (row >= M) continue;
                const float2 xr =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * C + col));
                const float y0 = round_bf16(round_bf16(acc[4 * i + 2 * half]) + c.x);
                const float y1 = round_bf16(round_bf16(acc[4 * i + 2 * half + 1]) + c.y);
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) =
                    __floats2bfloat162_rn(y0 + xr.x, y1 + xr.y);
            }
        }
    };
    gg_tiles<BN>(smem, bars, F / 64, nt, nt * ((M + GG_BM - 1) / GG_BM), load, epi);
}

template <int BN>
static cudaError_t launch_down(const CUtensorMap& mhid, const void* w2, const bf16* b2, const bf16* x, bf16* out,
                               int M, int C, int F, cudaStream_t stream) {
    CUtensorMap mw2;
    if (!bf16_map_sw128(&mw2, w2, C, F, BN)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(ln_geglu_down_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)GgCfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    const int ntiles = (C / BN) * ((M + GG_BM - 1) / GG_BM);
    ln_geglu_down_kernel<BN><<<gg_grid(ntiles), GG_THREADS, GgCfg<BN>::SMEM, stream>>>(mhid, mw2, b2, x, out, M,
                                                                                          C, F);
    return cudaGetLastError();
}

}  // namespace saspa

// x, out, xn: (M, C) bf16; lns, lnb: (C,) f32; w1: (2F, C) bf16 with the
// value rows first and the gate rows second; b1: (2F,) bf16; w2: (C, F) bf16;
// b2: (C,) bf16; hid: (M, F) bf16.  xn and hid are scratch written by the
// first two stages.  All contiguous and 16-byte aligned on the device; C and
// F multiples of 64, C <= 2048.  lanes, vecs, ln_blocks: the row-normalize's
// launch plan; bn_down: the second product's N tile (64, or 160 where
// C % 160 == 0) (ops/geglu.py::geglu_plan).  Returns a cudaError_t (0 on
// success).
extern "C" int saspa_ln_geglu(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* xn, void* hid, void* out, int M, int C, int F,
                              int lanes, int vecs, int ln_blocks, int bn_down, float eps, void* stream) {
    using namespace saspa;
    if (M <= 0 || C % 64 || F % 64 || F <= 0 || !(bn_down == 64 || (bn_down == 160 && C % 160 == 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = layernorm_launch<bf16>(kNormKernels, x, lns, lnb, xn, M, C, lanes, vecs, ln_blocks, eps, s);
    if (err != cudaSuccess) return (int)err;

    CUtensorMap mxn, mw1, mhid;
    if (!bf16_map_sw128(&mxn, xn, M, C, GG_BM) || !bf16_map_sw128(&mw1, w1, 2 * (uint64_t)F, C, 64) ||
        !bf16_map_sw128(&mhid, hid, M, F, GG_BM))
        return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ln_geglu_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GgCfg<128>::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int ntiles = (F / 64) * ((M + GG_BM - 1) / GG_BM);
    ln_geglu_up_kernel<<<gg_grid(ntiles), GG_THREADS, GgCfg<128>::SMEM, s>>>(
        mxn, mw1, static_cast<const bf16*>(b1), static_cast<bf16*>(hid), M, C, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bf16* b2p = static_cast<const bf16*>(b2);
    const bf16* xp = static_cast<const bf16*>(x);
    bf16* op = static_cast<bf16*>(out);
    return (int)(bn_down == 160 ? launch_down<160>(mhid, w2, b2p, xp, op, M, C, F, s)
                                : launch_down<64>(mhid, w2, b2p, xp, op, M, C, F, s));
}
