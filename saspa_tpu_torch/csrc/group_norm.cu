// GroupNorm(+SiLU) for Hopper (K3).
//
// Replaces saspa_tpu/ops/groupnorm.py::_gn_pallas (Pallas kernel _gn_kernel).
// x: (B, C, H, W) bf16 or f32, channels-last (NHWC in memory: a row of C
// channels per pixel), the format the port's convolutions keep from the
// latents on.  Statistics in f32: sum and sum of squares, mean = S1/n, var =
// S2/n - mean^2, rstd = rsqrt(var + eps).  Two epilogues:
//   xla order (tpu = 0), the JAX main path's default _xla_group_norm:
//     var clamped at 0; y = T((x - mean) * (rstd * gamma_c) + beta_c) in
//     f32; SiLU of the rounded value in f32, rounded once: y / (1 + exp(-y));
//   TPU numerics (tpu = 1), _gn_kernel: no clamp; scale_c = T(gamma_c *
//     rstd), shift_c = T(beta_c - mean * gamma_c * rstd); o = T(T(x * scale_c)
//     + shift_c) and SiLU as o * (1 / (1 + exp(-o))) with a T rounding after
//     each op: the bf16 normalize for bf16 input, every op in f32 (no
//     rounding, no fused multiply-add) for f32 input, as _gn_kernel runs an
//     f32 block.
// T is the input's type: bf16, or f32 for the XL VAE under
// SASPA_XL_VAE_FP32=1 (_gn_pallas on f32 input; the default path's
// _xla_group_norm in f32).
//
// What bounds it on an H100: a few flops per element against 2 * sizeof(T)
// bytes (one read, one write): HBM bandwidth.  The TPU kernel kept one
// sample's channel block resident in VMEM (one read, one write) and summed
// per-channel f32 moments over rows before folding channels into groups
// with a one-hot matmul; a group here reaches 2,097,152 elements (the VAE's
// 256 channels at 512^2), far beyond a block's shared memory, so x is read
// twice (the second read partly from L2), in two launches on one host plan
// (ops/groupnorm.py::gn_plan):
//   gn_stats_kernel<T>: a thread owns one 16-byte vector (8 bf16 or 4 f32
//     consecutive channels) of a pixel row, whatever C/G is; `rows` pixel
//     rows of C/VEC threads each run side by side in a block of `threads`
//     (whole warps), and grid (blocks, B) blocks walk their sample's rows
//     grid-stride, four loads in flight a thread.  Each thread sums its
//     channels' f32 moments over its rows in row order; the block adds its
//     row offsets per channel, in order, then folds channels into groups
//     once (a vector may span a group boundary: C/G = 10, 20, 30), all
//     groups at once (gn_fold: lane-strided sums, then a butterfly), and
//     writes one (sum, sum of squares) per group;
//   gn_apply_kernel<T, TPU, SILU>: its prologue folds the sample's `blocks`
//     partials of each group the same way, in the same fixed order in every
//     block, into (mean, rstd); then the same walk as the statistics, its
//     channels' coefficients in registers, normalizes each vector and stores
//     16 bytes.  With SiLU the normalize is bound by its arithmetic (expf and
//     an IEEE division or reciprocal an element, and in the bf16 TPU
//     numerics a rounding after each op) as much as by HBM.
// Element offsets are 64-bit: the XL VAE's f32 site at 1024^2, B8, holds
// 2^31 elements.  The sums are deterministic; their order differs from the
// plain versions'.
#include "mma_bf16.cuh"

namespace saspa {

constexpr int GN_MAX_THREADS = 512;  // a block's threads (ops/groupnorm.py::GN_MAX_THREADS)
constexpr int GN_MAX_GROUPS = 64;

// The element type's vector width (16 bytes), its rounding and conversions.
template <typename T>
struct GnType;
template <>
struct GnType<bf16> {
    static constexpr int VEC = 8;
    __device__ static __forceinline__ float rnd(float x) { return round_bf16(x); }
    __device__ static __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
    __device__ static __forceinline__ bf16 from_f(float v) { return __float2bfloat16_rn(v); }
};
template <>
struct GnType<float> {
    static constexpr int VEC = 4;
    __device__ static __forceinline__ float rnd(float x) { return x; }
    __device__ static __forceinline__ float to_f(float v) { return v; }
    __device__ static __forceinline__ float from_f(float v) { return v; }
};

// Per-channel coefficients: xla order (a, b) = (rstd * gamma, beta) with the
// mean subtracted first; TPU numerics (a, b) = (T(scale), T(shift)).
struct GnCoef {
    float a, b;
};

template <typename T>
__device__ __forceinline__ GnCoef gn_coef(float gamma, float beta, float mean, float rstd, int tpu) {
    if (tpu) {
        const float sc = gamma * rstd;
        return {GnType<T>::rnd(sc), GnType<T>::rnd(beta - __fmul_rn(mean, sc))};
    }
    return {rstd * gamma, beta};
}

// One element; the result is rounded to T by the store.  __fmul_rn and
// __fadd_rn keep each product and sum rounded on its own, as the plain
// versions compute them (no fused multiply-add).
template <typename T, int TPU, int SILU>
__device__ __forceinline__ float gn_elem(float x, GnCoef k, float mean) {
    using G = GnType<T>;
    if (TPU) {
        float y = G::rnd(__fadd_rn(G::rnd(__fmul_rn(x, k.a)), k.b));
        if (SILU) y = y * G::rnd(__frcp_rn(G::rnd(1.f + G::rnd(expf(-y)))));  // 1 / z, rounded once
        return y;
    }
    float y = G::rnd(__fmul_rn(x - mean, k.a) + k.b);  // no fma: the plain order
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

// Thread tid < rows * C/VEC of a block owns channels VEC*s .. VEC*s + VEC-1
// (s = tid % (C/VEC)) of the pixel rows blockIdx.x * rows + tid / (C/VEC) +
// k * gridDim.x * rows, k = 0, 1, ... of sample blockIdx.y; fn(v, r) runs on
// each row's 16-byte vector, U loads ahead, in row order.
template <int U, typename T, class Fn>
__device__ __forceinline__ void gn_walk(const T* xs, int HW, int C, int rows, int ro, Fn fn) {
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
template <typename T>
__global__ void __launch_bounds__(GN_MAX_THREADS, 2)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial, int HW, int C, int G, int rows) {
    constexpr int VEC = GnType<T>::VEC;
    extern __shared__ float2 sch[];  // [rows][C]: each row offset's per-channel moments
    const int b = blockIdx.y, nv = C / VEC, tid = threadIdx.x;
    if (tid < rows * nv) {
        const int s = tid % nv, ro = tid / nv;
        float s1[VEC], s2[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
        gn_walk<4>(x + (size_t)b * HW * C + s * VEC, HW, C, rows, ro, [&](const uint4& v, int) {
            const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float f = GnType<T>::to_f(h[e]);
                s1[e] += f;
                s2[e] += f * f;
            }
        });
#pragma unroll
        for (int e = 0; e < VEC; ++e) sch[ro * C + s * VEC + e] = make_float2(s1[e], s2[e]);
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

// One instantiation per type and epilogue (TPU numerics or the xla order,
// with or without SiLU), so that no per-element branch or unused operand
// takes registers.
template <typename T, int TPU, int SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS, 2)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ out, const float2* __restrict__ partial, int HW, int C, int G, int rows, float n,
                float eps) {
    constexpr int VEC = GnType<T>::VEC;
    __shared__ float2 sst[GN_MAX_GROUPS];  // (mean, rstd) of this sample's groups
    const int b = blockIdx.y, nv = C / VEC, tid = threadIdx.x;
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
    GnCoef k[VEC];
    float mean[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
        const int c = s * VEC + e;
        const float2 st = sst[c / CG];
        mean[e] = st.x;
        k[e] = gn_coef<T>(gamma[c], beta[c], st.x, st.y, TPU);
    }
    const size_t base = (size_t)b * HW * C + s * VEC;
    gn_walk<TPU ? 4 : 2>(x + base, HW, C, rows, ro, [&](const uint4& v, int r) {
        const T* h = reinterpret_cast<const T*>(&v);
        __align__(16) T o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            o[e] = GnType<T>::from_f(gn_elem<T, TPU, SILU>(GnType<T>::to_f(h[e]), k[e], mean[e]));
        *reinterpret_cast<uint4*>(out + base + (size_t)r * C) = *reinterpret_cast<const uint4*>(o);
    });
}

template <typename T>
static cudaError_t launch_group_norm(const void* x, const void* gamma, const void* beta, void* out, void* ws,
                                     int B, int C, int HW, int G, int threads, int rows, int blocks, float eps,
                                     int silu, int tpu, cudaStream_t s) {
    typedef void (*ApplyKernel)(const T*, const float*, const float*, T*, const float2*, int, int, int, int, float,
                                float);
    static const ApplyKernel apply[2][2] = {{gn_apply_kernel<T, 0, 0>, gn_apply_kernel<T, 0, 1>},
                                            {gn_apply_kernel<T, 1, 0>, gn_apply_kernel<T, 1, 1>}};  // [tpu][silu]
    if (C % GnType<T>::VEC || C > GnType<T>::VEC * GN_MAX_THREADS || rows * (C / GnType<T>::VEC) > threads)
        return cudaErrorInvalidValue;
    const T* xp = static_cast<const T*>(x);
    float2* part = static_cast<float2*>(ws);
    const dim3 grid(blocks, B);
    gn_stats_kernel<T><<<grid, threads, sizeof(float2) * rows * C, s>>>(xp, part, HW, C, G, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    apply[tpu != 0][silu != 0]<<<grid, threads, 0, s>>>(xp, static_cast<const float*>(gamma),
                                                        static_cast<const float*>(beta), static_cast<T*>(out), part,
                                                        HW, C, G, rows, (float)((long long)(C / G) * HW), eps);
    return cudaGetLastError();
}

}  // namespace saspa

// x, out: (B, C, HW), NHWC in memory, bf16 (f32 = 0) or f32 (f32 = 1);
// gamma, beta: (C,) f32; ws: (B * G * blocks) float2 scratch (each block's
// group moments).  threads, rows, blocks: the launch plan
// (ops/groupnorm.py::gn_plan): threads a multiple of 32 and at most 512,
// rows * C/VEC <= threads (VEC = 8 for bf16, 4 for f32), grid (blocks, B).
// All contiguous and 16-byte aligned on the device; C % VEC == 0, C <= VEC *
// 512, C % G == 0, G <= 64, B <= 65535.  Returns a cudaError_t (0 on
// success).
extern "C" int saspa_group_norm(const void* x, const void* gamma, const void* beta, void* out, void* ws, int B,
                                int C, int HW, int G, int threads, int rows, int blocks, float eps, int silu, int tpu,
                                int f32, void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || G <= 0 || G > GN_MAX_GROUPS || C % G || threads % 32 ||
        threads <= 0 || threads > GN_MAX_THREADS || rows <= 0 || blocks <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (f32) return (int)launch_group_norm<float>(x, gamma, beta, out, ws, B, C, HW, G, threads, rows, blocks, eps,
                                                  silu, tpu, s);
    return (int)launch_group_norm<bf16>(x, gamma, beta, out, ws, B, C, HW, G, threads, rows, blocks, eps, silu, tpu,
                                        s);
}
