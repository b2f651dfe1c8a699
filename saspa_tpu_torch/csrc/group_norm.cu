// GroupNorm(+SiLU) for Hopper (K3).
//
// Replaces saspa_tpu/ops/groupnorm.py::_gn_pallas (Pallas kernel _gn_kernel).
// x: (B, C, H, W) bf16, channels-last (NHWC in memory: a row of C channels
// per pixel), the format the port's convolutions keep from the latents on.
// Statistics in f32: sum and sum of squares, mean = S1/n, var = S2/n -
// mean^2, rstd = rsqrt(var + eps).  Two epilogues:
//   xla order (tpu = 0), the JAX main path's default _xla_group_norm:
//     var clamped at 0; y = bf16((x - mean) * (rstd * gamma_c) + beta_c) in
//     f32; SiLU of the rounded value in f32, rounded once: y / (1 + exp(-y));
//   TPU numerics (tpu = 1), _gn_kernel with its bf16 normalize:
//     no clamp; scale_c = bf16(gamma_c * rstd), shift_c = bf16(beta_c - mean *
//     gamma_c * rstd); o = bf16(bf16(x * scale_c) + shift_c) and SiLU as
//     o * (1 / (1 + exp(-o))) with a bf16 rounding after each op.
//
// What bounds it on an H100: a few flops per element against 4 bytes (one
// bf16 read, one bf16 write): HBM bandwidth.  The TPU kernel kept one
// sample's channel block resident in VMEM (one read, one write) and summed
// per-channel f32 moments over rows before folding channels into groups
// with a one-hot matmul; a group here reaches 2,097,152 elements (the VAE's
// 256 channels at 512^2), far beyond a block's shared memory, so x is read
// twice (the second read partly from L2), in two launches on one host plan
// (ops/groupnorm.py::gn_plan):
//   gn_stats_kernel: a thread owns one 16-byte vector (8 consecutive
//     channels) of a pixel row, whatever C/G is; `rows` pixel rows of C/8
//     threads each run side by side in a block of `threads` (whole warps),
//     and grid (blocks, B) blocks walk their sample's rows grid-stride,
//     four loads in flight a thread.  Each thread sums its 8 channels' f32
//     moments over its rows in row order; the block adds its row offsets per
//     channel, in order, then folds channels into groups once (a vector may
//     span a group boundary: C/G = 10, 20, 30), all groups at once (gn_fold:
//     lane-strided sums, then a butterfly), and writes one (sum, sum of
//     squares) per group;
//   gn_apply_kernel<TPU, SILU>: its prologue folds the sample's `blocks`
//     partials of each group the same way, in the same fixed order in every
//     block, into (mean, rstd); then the same walk as the statistics, its 8
//     channels' coefficients in registers, normalizes each vector and stores
//     16 bytes.  With SiLU the normalize is bound by its arithmetic (expf and
//     an IEEE division or reciprocal an element, and in the TPU numerics a
//     bf16 rounding after each op) as much as by HBM.
// The sums are deterministic; their order differs from the plain versions'.
#include "mma_bf16.cuh"

namespace saspa {

constexpr int GN_MAX_THREADS = 512;  // a block's threads (ops/groupnorm.py::GN_MAX_THREADS)
constexpr int GN_MAX_GROUPS = 64;

// Per-channel coefficients: xla order (a, b) = (rstd * gamma, beta) with the
// mean subtracted first; TPU numerics (a, b) = (bf16(scale), bf16(shift)).
struct GnCoef {
    float a, b;
};

__device__ __forceinline__ GnCoef gn_coef(float gamma, float beta, float mean, float rstd, int tpu) {
    if (tpu) {
        const float sc = gamma * rstd;
        return {round_bf16(sc), round_bf16(beta - __fmul_rn(mean, sc))};
    }
    return {rstd * gamma, beta};
}

// One element; the result is rounded to bf16 by the store.
template <int TPU, int SILU>
__device__ __forceinline__ float gn_elem(float x, GnCoef k, float mean) {
    if (TPU) {
        float y = round_bf16(round_bf16(x * k.a) + k.b);
        if (SILU) y = y * round_bf16(__frcp_rn(round_bf16(1.f + round_bf16(expf(-y)))));  // 1 / z, rounded once
        return y;
    }
    float y = round_bf16(__fmul_rn(x - mean, k.a) + k.b);  // no fma: the plain order
    if (SILU) y = y / (1.f + expf(-y));
    return y;
}

// Lanes that fold one group's terms (channels in the statistics, the blocks'
// partials in the normalize): the most, up to a warp, that let the block hold
// all G groups at once.  A power of two, so a group's lanes are an aligned
// segment of a warp and a butterfly over them stays inside it.
__device__ __forceinline__ int gn_lanes(int G) {
    int L = 32;
    while (L > 1 && G * L > (int)blockDim.x) L >>= 1;
    return L;
}

// Thread tid = g * L + l of the block's first ceil(G * L / 32) warps (L =
// gn_lanes(G)) folds terms l, l + L, ... of group g, in order, then the L
// lanes add up in a butterfly; term(g, i, s1, s2) adds term i; returns the
// group's (sum, sum of squares) in the group's lane 0 (and (0, 0) where g >=
// G).  Every lane of those warps runs the shuffles.
template <class Term>
__device__ __forceinline__ bool gn_fold(int G, int n, Term term, int& g, float2& out) {
    const int L = gn_lanes(G), tid = threadIdx.x;
    if (tid / 32 >= (G * L + 31) / 32) return false;
    g = tid / L;
    float s1 = 0.f, s2 = 0.f;
    if (g < G)
        for (int i = tid % L; i < n; i += L) term(g, i, s1, s2);
    for (int off = L / 2; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    out = make_float2(s1, s2);
    return g < G && tid % L == 0;
}

// Thread tid < rows * C/8 of a block owns channels 8s .. 8s + 7 (s = tid %
// (C/8)) of the pixel rows blockIdx.x * rows + tid / (C/8) + k * gridDim.x *
// rows, k = 0, 1, ... of sample blockIdx.y; fn(v, r) runs on each row's
// vector, U loads ahead, in row order.
template <int U, class Fn>
__device__ __forceinline__ void gn_walk(const bf16* xs, int HW, int C, int rows, int ro, Fn fn) {
    const int step = gridDim.x * rows;
    int r = blockIdx.x * rows + ro;
    for (; r + (U - 1) * step < HW; r += U * step) {
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(xs + (size_t)(r + u * step) * C));
#pragma unroll
        for (int u = 0; u < U; ++u) fn(v[u], r + u * step);
    }
    for (; r < HW; r += step) fn(__ldg(reinterpret_cast<const uint4*>(xs + (size_t)r * C)), r);
}

// partial[(b * G + g) * gridDim.x + blockIdx.x] = this block's (sum, sum of
// squares) of group g.
__global__ void __launch_bounds__(GN_MAX_THREADS, 2)
gn_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ partial, int HW, int C, int G, int rows) {
    extern __shared__ float2 sch[];  // [rows][C]: each row offset's per-channel moments
    const int b = blockIdx.y, nv = C / 8, tid = threadIdx.x;
    if (tid < rows * nv) {
        const int s = tid % nv, ro = tid / nv;
        float s1[8], s2[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
        gn_walk<4>(x + (size_t)b * HW * C + s * 8, HW, C, rows, ro, [&](const uint4& v, int) {
            const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float f = __bfloat162float(h[e]);
                s1[e] += f;
                s2[e] += f * f;
            }
        });
#pragma unroll
        for (int e = 0; e < 8; ++e) sch[ro * C + s * 8 + e] = make_float2(s1[e], s2[e]);
    }
    __syncthreads();
    for (int c = tid; c < C; c += blockDim.x) {  // the row offsets, in order
        float2 a = sch[c];
        for (int ro = 1; ro < rows; ++ro) {
            a.x += sch[ro * C + c].x;
            a.y += sch[ro * C + c].y;
        }
        sch[c] = a;
    }
    __syncthreads();
    const int CG = C / G;
    int g;
    float2 m;
    if (gn_fold(G, CG, [&](int grp, int i, float& s1, float& s2) {  // channels into groups
            s1 += sch[grp * CG + i].x;
            s2 += sch[grp * CG + i].y;
        }, g, m))
        partial[((size_t)b * G + g) * gridDim.x + blockIdx.x] = m;
}

// One instantiation per epilogue (TPU numerics or the xla order, with or
// without SiLU), so that no per-element branch or unused operand takes
// registers.
template <int TPU, int SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS, 2)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                bf16* __restrict__ out, const float2* __restrict__ partial, int HW, int C, int G, int rows, float n,
                float eps) {
    __shared__ float2 sst[GN_MAX_GROUPS];  // (mean, rstd) of this sample's groups
    const int b = blockIdx.y, nv = C / 8, tid = threadIdx.x;
    int g;
    float2 m;
    if (gn_fold(G, gridDim.x, [&](int grp, int i, float& s1, float& s2) {  // the blocks' partials
            const float2 p = partial[((size_t)b * G + grp) * gridDim.x + i];
            s1 += p.x;
            s2 += p.y;
        }, g, m)) {
        const float mean = m.x / n;
        float var = m.y / n - mean * mean;
        if (!TPU) var = fmaxf(var, 0.f);
        sst[g] = make_float2(mean, rsqrtf(var + eps));
    }
    __syncthreads();
    if (tid >= rows * nv) return;
    const int s = tid % nv, ro = tid / nv, CG = C / G;
    GnCoef k[8];
    float mean[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int c = s * 8 + e;
        const float2 st = sst[c / CG];
        mean[e] = st.x;
        k[e] = gn_coef(gamma[c], beta[c], st.x, st.y, TPU);
    }
    const size_t base = (size_t)b * HW * C + s * 8;
    gn_walk<TPU ? 4 : 2>(x + base, HW, C, rows, ro, [&](const uint4& v, int r) {
        const bf16* h = reinterpret_cast<const bf16*>(&v);
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16_rn(gn_elem<TPU, SILU>(__bfloat162float(h[e]), k[e], mean[e]));
        *reinterpret_cast<uint4*>(out + base + (size_t)r * C) = *reinterpret_cast<const uint4*>(o);
    });
}

typedef void (*GnApplyKernel)(const bf16*, const float*, const float*, bf16*, const float2*, int, int, int, int,
                              float, float);
static const GnApplyKernel kGnApply[2][2] = {{gn_apply_kernel<0, 0>, gn_apply_kernel<0, 1>},
                                             {gn_apply_kernel<1, 0>, gn_apply_kernel<1, 1>}};  // [tpu][silu]

}  // namespace saspa

// x, out: (B, C, HW) bf16, NHWC in memory; gamma, beta: (C,) f32; ws:
// (B * G * blocks) float2 scratch (each block's group moments).  threads,
// rows, blocks: the launch plan (ops/groupnorm.py::gn_plan): threads a
// multiple of 32 and at most 512, rows * C/8 <= threads, grid (blocks, B).
// All contiguous and 16-byte aligned on the device; C % 8 == 0, C <= 4096,
// C % G == 0, G <= 64, B <= 65535.  Returns a cudaError_t (0 on success).
extern "C" int saspa_group_norm(const void* x, const void* gamma, const void* beta, void* out, void* ws, int B,
                                int C, int HW, int G, int threads, int rows, int blocks, float eps, int silu, int tpu,
                                void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8 || C > 4096 || G <= 0 || G > GN_MAX_GROUPS || C % G ||
        threads % 32 || threads <= 0 || threads > GN_MAX_THREADS || rows <= 0 || rows * (C / 8) > threads ||
        blocks <= 0)
        return (int)cudaErrorInvalidValue;
    const bf16* xp = static_cast<const bf16*>(x);
    float2* part = static_cast<float2*>(ws);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(blocks, B);
    gn_stats_kernel<<<grid, threads, sizeof(float2) * rows * C, s>>>(xp, part, HW, C, G, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kGnApply[tpu != 0][silu != 0]<<<grid, threads, 0, s>>>(xp, static_cast<const float*>(gamma),
                                                           static_cast<const float*>(beta), static_cast<bf16*>(out),
                                                           part, HW, C, G, rows, (float)((long long)(C / G) * HW), eps);
    return (int)cudaGetLastError();
}
