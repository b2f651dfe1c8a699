// The one-pass LayerNorm row-normalize, shared by K4 (layernorm.cu) and the
// first stage of K2 (ln_geglu.cu).  For rows of C bf16:
//     mean = E[x], var = E[x^2] - mean^2 (f32, no clamp), rs = rsqrt(var + eps)
//     out  = bf16(bf16(bf16(x - bf16(mean)) * bf16(rs * scale)) + bf16(bias))
// (saspa_tpu/ops/layernorm.py::_ln_kernel, and the same normalize inside
// saspa_tpu/ops/geglu.py::_ln_geglu_kernel); for rows of C f32 (K4 only,
// _ln_kernel's f32 branch) the same statistics and
//     out  = (x - mean) * (rs * scale) + bias
// all in f32, each product and sum rounded on its own (no fused multiply-add).
//
// A bandwidth kernel: 2 * sizeof(T) bytes of HBM traffic per element (one
// read, one write) against ~8 f32 operations.  The launch plan is chosen on
// the host (ops/layernorm.py::ln_plan): `lanes` lanes of a warp share one row
// (a power of two, so 32 / lanes rows a warp) and each lane holds `V`
// 16-byte vectors of it (8 bf16 or 4 f32), vector li + j * lanes for j < V,
// so neighbouring lanes read neighbouring 16 bytes.  At C = 320 * 2^k (k = 0,
// 1, 2) the bf16 plan is V = 5 at 8, 16, 32 lanes, the f32 one V = 5, 5, 10
// at 16, 32, 32: no lane idles.  A lane issues all of its
// loads before the statistics, which are reduced with __shfl_xor_sync over
// the row's lanes; the row stays in registers between the statistics and
// the normalize, so x is read once.  Blocks of LN_THREADS walk the rows
// grid-stride (the host sizes the grid to a few blocks per SM), and each
// block stages scale and bias (bf16(bias) for bf16 rows) once in shared
// memory, read back as float4.
#pragma once

#include "mma_bf16.cuh"

namespace saspa {

constexpr int LN_THREADS = 256;  // 8 warps a block
constexpr int LN_MAXV = 8;       // bf16: 16-byte vectors a lane, C <= 32 * 8 * LN_MAXV
constexpr int LN_MAXV_F32 = 12;  // f32: C <= 32 * 4 * LN_MAXV_F32 (1536, the refiner's widest)

// The element type's 16-byte vector and the most vectors a lane holds.
template <typename T>
struct LnType;
template <>
struct LnType<bf16> {
    static constexpr int VEC = 8, MAXV = LN_MAXV;
};
template <>
struct LnType<float> {
    static constexpr int VEC = 4, MAXV = LN_MAXV_F32;
};

__device__ __forceinline__ float ln_to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ln_to_f(float v) { return v; }

// The block's kernel body.  sp: 2 * C floats of dynamic shared memory.
template <int V, typename T = bf16>
__device__ __forceinline__ void layernorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                                               const float* __restrict__ bias, T* __restrict__ out, float* sp,
                                               int M, int C, int lanes, float eps) {
    constexpr int VEC = LnType<T>::VEC;
    constexpr bool F32 = VEC == 4;
    float* ss = sp;      // scale
    float* sb = sp + C;  // bias (bf16 rows: bf16(bias)), as floats
    for (int i = threadIdx.x; i < C / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(ss)[i] = reinterpret_cast<const float4*>(scale)[i];
        float4 b = reinterpret_cast<const float4*>(bias)[i];
        if constexpr (!F32) b = make_float4(round_bf16(b.x), round_bf16(b.y), round_bf16(b.z), round_bf16(b.w));
        reinterpret_cast<float4*>(sb)[i] = b;
    }
    __syncthreads();

    const int nv = C / VEC;
    const int lane = threadIdx.x % 32, li = lane % lanes, rpw = 32 / lanes;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, nwarps = gridDim.x * blockDim.x / 32;
    for (int r0 = warp * rpw; r0 < M; r0 += nwarps * rpw) {  // warp-uniform: every lane shuffles
        const int row = r0 + lane / lanes;
        const bool on = row < M;
        const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
        uint4 v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const int idx = li + j * lanes;
            v[j] = on && idx < nv ? __ldg(xr + idx) : make_uint4(0, 0, 0, 0);
        }
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float f = ln_to_f(e[i]);
                s1 += f;
                s2 += f * f;
            }
        }
        for (int off = lanes / 2; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        const float mean = s1 / C;
        const float rs = rsqrtf(s2 / C - mean * mean + eps);
        const float mb = round_bf16(mean);

        T* orow = out + (size_t)row * C;
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const int idx = li + j * lanes;
            if (!on || idx >= nv) continue;
            const float4* sc = reinterpret_cast<const float4*>(ss + idx * VEC);
            const float4* bi = reinterpret_cast<const float4*>(sb + idx * VEC);
            if constexpr (F32) {
                const float4 c0 = sc[0], b0 = bi[0], xv = *reinterpret_cast<const float4*>(&v[j]);
                const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, scl[4] = {c0.x, c0.y, c0.z, c0.w},
                            bs[4] = {b0.x, b0.y, b0.z, b0.w};
                float o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) o[i] = __fadd_rn(__fmul_rn(xs[i] - mean, __fmul_rn(rs, scl[i])), bs[i]);
                reinterpret_cast<float4*>(orow)[idx] = make_float4(o[0], o[1], o[2], o[3]);
                continue;
            }
            const float4 c0 = sc[0], c1 = sc[1], b0 = bi[0], b1 = bi[1];
            const float scl[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
            __align__(16) bf16 o[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float t1 = round_bf16(__bfloat162float(e[i]) - mb);
                const float t2 = round_bf16(t1 * round_bf16(rs * scl[i]));
                o[i] = __float2bfloat16_rn(t2 + bs[i]);
            }
            reinterpret_cast<uint4*>(orow)[idx] = *reinterpret_cast<const uint4*>(o);
        }
    }
}

template <typename T>
using LayerNormKernelT = void (*)(const T*, const float*, const float*, T*, int, int, int, float);
typedef LayerNormKernelT<bf16> LayerNormKernel;

// Launches kernels[vecs - 1] (the instantiations V = 1..MAXV of a kernel
// that runs layernorm_rows<V, T>) with a host plan; refuses a plan that does
// not cover the row: lanes a power of two <= 32, lanes * vecs >= C / VEC.
template <typename T>
static cudaError_t layernorm_launch(const LayerNormKernelT<T> (&kernels)[LnType<T>::MAXV], const void* x,
                                    const void* scale, const void* bias, void* out, int M, int C, int lanes,
                                    int vecs, int blocks, float eps, cudaStream_t stream) {
    constexpr int VEC = LnType<T>::VEC, MAXV = LnType<T>::MAXV;
    if (M <= 0 || C <= 0 || C % 8 || C > 32 * VEC * MAXV || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
        vecs < 1 || vecs > MAXV || lanes * vecs < C / VEC || blocks < 1)
        return cudaErrorInvalidValue;
    kernels[vecs - 1]<<<blocks, LN_THREADS, 2 * C * sizeof(float), stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(out), M, C, lanes, eps);
    return cudaGetLastError();
}

}  // namespace saspa
