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
// sample's channel block resident in VMEM (one read, one write) and folded
// group stats into channels with a one-hot matmul; a group here reaches
// 2,097,152 elements (the VAE's 256 channels at 512^2), far beyond a block's
// shared memory.  So the work is split into chunks of `chunk` pixel rows of
// one sample, in three launches:
// (a) gn_stats writes each chunk's f32 (sum, sum of squares) per group;
// (b) gn_finalize sums a group's partials in a fixed order into (mean, rstd);
// (c) gn_apply normalizes a chunk.  x is read twice (the second read often
// from L2); the sum order differs from the plain version's, nothing else
// does.  A thread owns VEC consecutive channels of one group (VEC divides
// C/G) and walks the chunk's rows, so loads stay coalesced along C.
#include "mma_bf16.cuh"

namespace saspa {

constexpr int GN_THREADS = 256;
constexpr int GN_MAX_GROUPS = 64;

template <int VEC>
__device__ __forceinline__ void load_vec(float f[VEC], const bf16* p) {
    if (VEC == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = __bfloat162float(e[i]);
    } else if (VEC == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = __bfloat162float(e[i]);
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = __bfloat162float(p[i]);
    }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float f[VEC]) {
    __align__(16) bf16 o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = __float2bfloat16_rn(f[i]);
    if (VEC == 8) {
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
    } else if (VEC == 4) {
        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(o);
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) p[i] = o[i];
    }
}

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
__device__ __forceinline__ float gn_elem(float x, GnCoef k, float mean, int silu, int tpu) {
    if (tpu) {
        float y = round_bf16(round_bf16(x * k.a) + k.b);
        if (silu) y = y * round_bf16(1.f / round_bf16(1.f + round_bf16(expf(-y))));
        return y;
    }
    float y = round_bf16(__fmul_rn(x - mean, k.a) + k.b);  // no fma: the plain order
    if (silu) y = y / (1.f + expf(-y));
    return y;
}

// Grid (nchunk, B): a chunk is `rows` pixel rows of one sample.
// P = C / VEC channel slots per row; with P < GN_THREADS, RP = GN_THREADS / P
// rows run side by side (thread t: row offset t / P, slot t % P), else each
// thread takes slots t, t + GN_THREADS, ... of every row.

// (a) partial[(b * G + g) * nchunk + chunk] = (sum, sum of squares)
template <int VEC>
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ partial, int HW, int C, int G, int rows,
                     int nchunk) {
    extern __shared__ float2 sacc[];  // [RP][P]
    const int b = blockIdx.y, P = C / VEC;
    const int RP = P >= GN_THREADS ? 1 : GN_THREADS / P;
    const int r_off = P >= GN_THREADS ? 0 : threadIdx.x / P;
    const int r_lo = blockIdx.x * rows, r_hi = min(r_lo + rows, HW);
    const bf16* xb = x + (size_t)b * HW * C;
    if (r_off < RP) {
        for (int s = P >= GN_THREADS ? threadIdx.x : threadIdx.x % P; s < P; s += GN_THREADS) {
            float s1 = 0.f, s2 = 0.f;
            for (int r = r_lo + r_off; r < r_hi; r += RP) {
                float f[VEC];
                load_vec<VEC>(f, xb + (size_t)r * C + s * VEC);
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    s1 += f[e];
                    s2 += f[e] * f[e];
                }
            }
            sacc[r_off * P + s] = make_float2(s1, s2);
        }
    }
    __syncthreads();
    const int slots = C / G / VEC;  // a group's slots
    for (int g = threadIdx.x; g < G; g += GN_THREADS) {
        float s1 = 0.f, s2 = 0.f;
        for (int ro = 0; ro < RP; ++ro)
            for (int s = g * slots; s < (g + 1) * slots; ++s) {
                const float2 v = sacc[ro * P + s];
                s1 += v.x;
                s2 += v.y;
            }
        partial[((size_t)b * G + g) * nchunk + blockIdx.x] = make_float2(s1, s2);
    }
}

// (c)
template <int VEC>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                     bf16* __restrict__ out, const float2* __restrict__ stats, int HW, int C, int G, int rows,
                     int silu, int tpu) {
    __shared__ float2 sst[GN_MAX_GROUPS];  // (mean, rstd) of this sample's groups
    const int b = blockIdx.y, P = C / VEC;
    for (int g = threadIdx.x; g < G; g += GN_THREADS) sst[g] = stats[(size_t)b * G + g];
    __syncthreads();
    const int RP = P >= GN_THREADS ? 1 : GN_THREADS / P;
    const int r_off = P >= GN_THREADS ? 0 : threadIdx.x / P;
    const int r_lo = blockIdx.x * rows, r_hi = min(r_lo + rows, HW);
    const int CG = C / G;
    const size_t base = (size_t)b * HW * C;
    if (r_off >= RP) return;
    for (int s = P >= GN_THREADS ? threadIdx.x : threadIdx.x % P; s < P; s += GN_THREADS) {
        const float2 st = sst[s * VEC / CG];  // VEC divides C/G: one group per slot
        GnCoef k[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) k[e] = gn_coef(gamma[s * VEC + e], beta[s * VEC + e], st.x, st.y, tpu);
        for (int r = r_lo + r_off; r < r_hi; r += RP) {
            const size_t i = base + (size_t)r * C + s * VEC;
            float f[VEC];
            load_vec<VEC>(f, x + i);
#pragma unroll
            for (int e = 0; e < VEC; ++e) f[e] = gn_elem(f[e], k[e], st.x, silu, tpu);
            store_vec<VEC>(out + i, f);
        }
    }
}

// (b) one warp per (sample, group): stats[bg] = (mean, rstd)
__global__ void __launch_bounds__(GN_THREADS)
gn_finalize_kernel(const float2* __restrict__ partial, float2* __restrict__ stats, int BG, int nchunk, float n,
                   float eps, int tpu) {
    const int bg = blockIdx.x * (GN_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (bg >= BG) return;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
        const float2 p = partial[(size_t)bg * nchunk + c];
        s1 += p.x;
        s2 += p.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
        const float mean = s1 / n;
        float var = s2 / n - mean * mean;
        if (!tpu) var = fmaxf(var, 0.f);
        stats[bg] = make_float2(mean, rsqrtf(var + eps));
    }
}

struct GnArgs {
    const bf16* x;
    const float* gamma;
    const float* beta;
    bf16* out;
    float2* partial;
    float2* stats;
    int B, C, HW, G, chunk, nchunk, silu, tpu;
    float eps;
    cudaStream_t s;
};

static cudaError_t finalize(const GnArgs& a) {
    const int bg = a.B * a.G, per = GN_THREADS / 32;
    gn_finalize_kernel<<<(bg + per - 1) / per, GN_THREADS, 0, a.s>>>(a.partial, a.stats, bg, a.nchunk,
                                                                     (float)((long)(a.C / a.G) * a.HW), a.eps, a.tpu);
    return cudaGetLastError();
}

template <int VEC>
static cudaError_t launch(const GnArgs& a) {
    const int P = a.C / VEC;
    const size_t smem = sizeof(float2) * (P >= GN_THREADS ? P : (GN_THREADS / P) * P);
    const dim3 grid(a.nchunk, a.B);
    gn_stats_kernel<VEC><<<grid, GN_THREADS, smem, a.s>>>(a.x, a.partial, a.HW, a.C, a.G, a.chunk, a.nchunk);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) err = finalize(a);
    if (err != cudaSuccess) return err;
    gn_apply_kernel<VEC><<<grid, GN_THREADS, 0, a.s>>>(a.x, a.gamma, a.beta, a.out, a.stats, a.HW, a.C, a.G, a.chunk,
                                                       a.silu, a.tpu);
    return cudaGetLastError();
}

}  // namespace saspa

// x, out: (B, C, HW) bf16, NHWC in memory; gamma, beta: (C,) f32; ws:
// (B * G * (nchunk + 1)) float2 scratch (the chunks' partial sums, then the
// groups' (mean, rstd)).  chunk: pixel rows per chunk, nchunk = ceil(HW /
// chunk).  All contiguous on the device; C % G == 0, C/G even, G <= 64,
// C <= 4096, B <= 65535.  Returns a cudaError_t (0 on success).
extern "C" int saspa_group_norm(const void* x, const void* gamma, const void* beta, void* out, void* ws, int B,
                                int C, int HW, int G, int chunk, int nchunk, float eps, int silu, int tpu,
                                void* stream) {
    using saspa::bf16;
    if (B <= 0 || G <= 0 || HW <= 0 || C % G || chunk <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
    const int CG = C / G;
    if (nchunk != (HW + chunk - 1) / chunk) return (int)cudaErrorInvalidValue;
    if (CG % 2 || G > saspa::GN_MAX_GROUPS || C > 4096) return (int)cudaErrorInvalidValue;
    float2* w = static_cast<float2*>(ws);
    const saspa::GnArgs a{static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                          static_cast<const float*>(beta), static_cast<bf16*>(out), w, w + (size_t)B * G * nchunk,
                          B, C, HW, G, chunk, nchunk, silu, tpu, eps, static_cast<cudaStream_t>(stream)};
    if (CG % 8 == 0) return (int)saspa::launch<8>(a);
    if (CG % 4 == 0) return (int)saspa::launch<4>(a);
    return (int)saspa::launch<2>(a);
}
