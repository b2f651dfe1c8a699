// Self-attention in f32 at padded head dims 64, 128 and 192 for Hopper: K1's
// f32 variant at the UNet's heads and K6's f32 variant, one core; and K5's
// f32 variant, the whole self-attention block around that core.
//
// Replaces, on f32 activations (a pipeline built with dtype=float32):
//   saspa_tpu/ops/attention.py::flash_attention_packed (Pallas kernel
//     _packed_kernel) at d_pad 64/128/192: packed (B, L, H*d_pad) q, k, v,
//     q pre-scaled by softmax_scale*log2(e) in f32, softmax in base 2
//     (entry saspa_attention_f32_packed);
//   saspa_tpu/ops/attention.py::_flash_attention_padded (Pallas kernel
//     _flash_kernel, via flash_attention) on (B, L, H, d) q, k, v at the
//     real head dim d (a multiple of 8 padding to 64/128/192), q * scale
//     folded in f32, softmax in base e with a running max and sum
//     (entry saspa_flash_attention_f32);
//   saspa_tpu/ops/attention.py::attention_block_fused (Pallas kernel
//     _block_kernel, under SASPA_ATTN_MEGAKERNEL=1) on an f32 block
//     (entry saspa_attention_block_f32): Q, K, V = x_ln wq_scaled^T,
//     x_ln wk^T, x_ln wv^T; the packed heads = the K1 entry's attention on
//     them; out = packed wo^T + bo + residual; all f32, nothing rounded.
//     Three kernels behind the entry, as K5 in bf16 runs (attention_block.cu):
//     the Q/K/V product (attention_block_f32_qkv_kernel), this core at exp2
//     on Q, K, V, and the out product (attention_block_f32_out_kernel), whose
//     epilogue adds bo and the residual; Q, K, V and the packed heads
//     round-trip device memory in f32 (a workspace of 4 * B*L*H*D_PAD
//     floats).  The products are gemm_f32.cuh's register-tiled FFMA tiles
//     (64 columns: SD2.1's H*D_PAD = 320 needs no other tile, and no tile
//     straddles two projections).  What bounds it: operations, the
//     attention's 4*B*H*L^2*D_PAD flops against the four projections'
//     8*B*L*C*H*D_PAD (about 89% and 11% at SD1.5's level 0).
// For every batch row b and head h: out = softmax(q_h k_h^T) v_h, with the
// scores, probabilities, the running max and sum, the P.V product and the
// output all f32, as the TPU kernels compute an f32 block (P cast to v's
// dtype is f32 there).  The heads are zero-padded to D_PAD in shared memory
// (K1's inputs arrive padded; K6's padded columns of Q, K and V are zeroed
// once), so the padding changes no score.
//
// What bounds it on an H100: operations.  The work is 4*B*H*Lq*Lk*D_PAD
// flops against 4*B*H*(2*Lq + 2*Lk)*d bytes; in f32 outside the tensor cores
// the card does 67 TFLOP/s.  TF32 tensor cores would be faster but round q,
// k, P and v to 10 mantissa bits, other numerics than the TPU kernels' f32:
// this core is FFMA on the CUDA cores.
//
// Design (a simple one: a first f32 version at these head dims): one block
// of 256 threads per 64 query rows of one (b, h), grid (Lq/64, H, B).  Q
// stays in shared memory (scaled as it lands); K and V stream through it in
// 64-key tiles by cp.async, each one tile ahead of its use: K(j + 1) behind
// the softmax and P.V of tile j, V(j + 1) behind the scores of tile j + 1.
// Rows are padded by 4 floats, so the 16 keys a warp reads sit in distinct
// bank quads.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i
// (i < 4) of both products:
//   S = Q K^T: keys tx + 16*e (e < 4), a 4 x 4 register tile; each step over
//     4 dims reads 4 float4 of q (2 rows a warp: broadcasts) and 4 of k and
//     does 64 FFMAs;
//   O += P V: columns 4*tx + 64*c (c < D_PAD/64), 4 x D_PAD/16 accumulators;
//     each step over 4 keys reads the 4 rows' probabilities as float4 and
//     D_PAD/16 float4 of V.
// The online softmax runs between them on the score tile in shared memory,
// 4 threads a row (16 keys each, max and sum by two shuffles), and writes
// the probabilities in place and each row's rescale factor.  Three block
// barriers a tile.  Shared memory: Q, K, V (64 x (D_PAD + 4) floats each)
// and the 64 x 68 score tile: 70 / 119 / 168 KB at D_PAD 64 / 128 / 192.
#include "gemm_f32.cuh"
#include "mma_bf16.cuh"

#include <math.h>

namespace saspa {

constexpr int AF_BM = 64;         // query rows a block
constexpr int AF_BN = 64;         // keys a K/V tile
constexpr int AF_THREADS = 256;
constexpr int AF_SS = AF_BN + 4;  // the score tile's row stride (floats)

template <int DP>
constexpr size_t af_smem_bytes() {
    return 4 * ((size_t)(AF_BM + 2 * AF_BN) * (DP + 4) + AF_BM * AF_SS + AF_BM);
}
static_assert(af_smem_bytes<192>() <= 232448, "shared memory per block");

__device__ __forceinline__ float af_dot4(const float4& a, const float4& b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void af_fma(float4& acc, float p, const float4& v) {
    acc.x = fmaf(p, v.x, acc.x);
    acc.y = fmaf(p, v.y, acc.y);
    acc.z = fmaf(p, v.z, acc.z);
    acc.w = fmaf(p, v.w, acc.w);
}

template <bool EXP2>
__device__ __forceinline__ float af_exp(float x) {
    return EXP2 ? exp2f(x) : expf(x);
}

// q, o: element (b, l, h, j) at ((b*Lq + l)*H + h)*dh + j; k, v the same with
// Lk.  dh: the stored head width (K1: D_PAD; K6: the real d, dh % 4 == 0).
// q is multiplied by `scale` in f32 as it lands (K1: 1).
template <int DP, bool EXP2>
__global__ void __launch_bounds__(AF_THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int Lq, int Lk, int H, int dh, float scale) {
    constexpr int S = DP + 4;  // Q, K, V row stride (floats)
    constexpr int NC = DP / 64;
    extern __shared__ __align__(16) float af_smem[];
    float* sQ = af_smem;
    float* sK = sQ + AF_BM * S;
    float* sV = sK + AF_BN * S;
    float* sP = sV + AF_BN * S;  // [row][key]: scores, then probabilities
    float* sF = sP + AF_BM * AF_SS;  // each row's rescale factor, at the end its sum
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * AF_BM;
    const size_t rs = (size_t)H * dh;  // a token's row (floats)
    const float* qg = q + ((size_t)b * Lq + q0) * rs + (size_t)h * dh;
    const float* kg = k + (size_t)b * Lk * rs + (size_t)h * dh;
    const float* vg = v + (size_t)b * Lk * rs + (size_t)h * dh;
    const int nc = dh / 4, nkv = Lk / AF_BN;

    auto load_tile = [&](float* dst, const float* src, int j) {
        const float* g = src + (size_t)j * AF_BN * rs;
        for (int i = tid; i < AF_BN * nc; i += AF_THREADS) {
            const int r = i / nc, c = (i % nc) * 4;
            cp_async_16(dst + r * S + c, g + (size_t)r * rs + c);
        }
    };
    load_tile(sK, kg, 0);
    cp_async_commit();
    load_tile(sV, vg, 0);
    cp_async_commit();
    // the padded columns dh .. DP of Q, K, V: zero once (the tiles' loads never write them)
    for (int i = tid; i < AF_BM * (DP - dh); i += AF_THREADS) {
        const int r = i / (DP - dh), c = dh + i % (DP - dh);
        sQ[r * S + c] = 0.f;
        sK[r * S + c] = 0.f;
        sV[r * S + c] = 0.f;
    }
    for (int i = tid; i < AF_BM * nc; i += AF_THREADS) {
        const int r = i / nc, c = (i % nc) * 4;
        const float4 x = __ldg(reinterpret_cast<const float4*>(qg + (size_t)r * rs + c));
        *reinterpret_cast<float4*>(sQ + r * S + c) =
            make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }

    float4 acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    // softmax: thread owns row sr, keys 4*sk + 16*t (t < 4); its running max and its share of the row sum
    const int sr = tid / 4, sk = tid % 4;
    float m_run = -INFINITY, l_run = 0.f;

    for (int j = 0; j < nkv; ++j) {
        cp_async_wait<1>();  // K(j) landed (V(j) may be in flight)
        __syncthreads();
        // ---- S = Q K^T: rows ty + 16*i, keys tx + 16*e
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DP; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * S + d);
#pragma unroll
            for (int e = 0; e < 4; ++e) kv[e] = *reinterpret_cast<const float4*>(sK + (tx + 16 * e) * S + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[i][e] = af_dot4(qv[i], kv[e], s[i][e]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) sP[(ty + 16 * i) * AF_SS + tx + 16 * e] = s[i][e];
        __syncthreads();  // the scores written, every thread done with K(j)
        if (j + 1 < nkv) load_tile(sK, kg, j + 1);
        cp_async_commit();  // (an empty group on the last tile keeps the wait counts)

        // ---- online softmax of row sr over the tile's 64 keys
        float4 sv[4];
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            sv[t] = *reinterpret_cast<const float4*>(sP + sr * AF_SS + 4 * sk + 16 * t);
            mx = fmaxf(mx, fmaxf(fmaxf(sv[t].x, sv[t].y), fmaxf(sv[t].z, sv[t].w)));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_run, mx);
        const float al = af_exp<EXP2>(m_run - mn);
        m_run = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const float4 p = make_float4(af_exp<EXP2>(sv[t].x - mn), af_exp<EXP2>(sv[t].y - mn),
                                         af_exp<EXP2>(sv[t].z - mn), af_exp<EXP2>(sv[t].w - mn));
            sum += (p.x + p.y) + (p.z + p.w);
            *reinterpret_cast<float4*>(sP + sr * AF_SS + 4 * sk + 16 * t) = p;
        }
        l_run = l_run * al + sum;
        if (sk == 0) sF[sr] = al;
        cp_async_wait<1>();  // V(j) landed (K(j + 1) may be in flight)
        __syncthreads();     // P, the factors and V(j) visible to every thread

        // ---- O = O * alpha + P V over the tile's 64 keys
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float a = sF[ty + 16 * i];
            if (a != 1.f) {
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    acc[i][c] = make_float4(acc[i][c].x * a, acc[i][c].y * a, acc[i][c].z * a, acc[i][c].w * a);
            }
        }
#pragma unroll 2
        for (int key = 0; key < AF_BN; key += 4) {
            float4 p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * AF_SS + key);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float4 vv = *reinterpret_cast<const float4*>(sV + (key + kk) * S + 4 * tx + 64 * c);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
                        af_fma(acc[i][c], pk, vv);
                    }
                }
            }
        }
        __syncthreads();  // every thread done with V(j), P and the factors
        if (j + 1 < nkv) load_tile(sV, vg, j + 1);
        cp_async_commit();
    }
    cp_async_wait<0>();

    // the row sums: the row's 4 threads' shares
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
    if (sk == 0) sF[sr] = l_run;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float l = sF[r];
        float* orow = o + ((size_t)b * Lq + q0 + r) * rs + (size_t)h * dh;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = 4 * tx + 64 * c;
            if (col < dh) {
                const float4 a = acc[i][c];
                *reinterpret_cast<float4*>(orow + col) = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
            }
        }
    }
}

template <int DP, bool EXP2>
static cudaError_t attention_f32_launch(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                                        int Lk, int H, int dh, float scale, cudaStream_t s) {
    constexpr size_t smem = af_smem_bytes<DP>();
    cudaError_t err =
        cudaFuncSetAttribute(attention_f32_kernel<DP, EXP2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Lq / AF_BM, H, B);
    attention_f32_kernel<DP, EXP2><<<grid, AF_THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), Lq, Lk, H, dh, scale);
    return cudaGetLastError();
}

template <bool EXP2>
static int attention_f32_dispatch(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
                                  int H, int dh, int dp, float scale, void* stream) {
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Lq <= 0 || Lk <= 0 || Lq % AF_BM || Lk % AF_BN ||
        dh <= 0 || dh % 4 || dh > dp)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dp) {
        case 64:
            return (int)attention_f32_launch<64, EXP2>(q, k, v, out, B, Lq, Lk, H, dh, scale, s);
        case 128:
            return (int)attention_f32_launch<128, EXP2>(q, k, v, out, B, Lq, Lk, H, dh, scale, s);
        case 192:
            return (int)attention_f32_launch<192, EXP2>(q, k, v, out, B, Lq, Lk, H, dh, scale, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// K5 in f32, phase 1: [Q | K | V] = x [wq | wk | wv]^T.  blockIdx.x walks
// the 3 * HD / GF_BN column tiles (Q's, then K's, then V's: tile n reads
// rows (n % per) * 64 .. + 63 of one projection's weights), blockIdx.y the
// ceil(M / GF_BM) row tiles; the three outputs are (M, HD) planes one after
// another in qkv.
__global__ void __launch_bounds__(GF_THREADS, 2)
attention_block_f32_qkv_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                               const float* __restrict__ wk, const float* __restrict__ wv, float* __restrict__ qkv,
                               int M, int C, int HD) {
    extern __shared__ __align__(16) float gf_smem[];
    const int per = HD / GF_BN, which = blockIdx.x / per, n0 = (blockIdx.x % per) * GF_BN;
    const int m0 = blockIdx.y * GF_BM, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][4];
    gf_tile(x, C, which == 0 ? wq : which == 1 ? wk : wv, C, M, C, m0, n0, gf_smem, acc);
    float* o = qkv + (size_t)which * M * HD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e) o[(size_t)row * HD + n0 + tx + 16 * e] = acc[i][e];
        }
    }
}

// K5 in f32, phase 3: out = packed wo^T + bo + residual, the sum in that
// order (the TPU kernel's and the plain version's); blockIdx.x walks the C /
// GF_BN column tiles, blockIdx.y the row tiles.
__global__ void __launch_bounds__(GF_THREADS, 2)
attention_block_f32_out_kernel(const float* __restrict__ packed, const float* __restrict__ wo,
                               const float* __restrict__ bo, const float* __restrict__ res, float* __restrict__ out,
                               int M, int C, int HD) {
    extern __shared__ __align__(16) float gf_smem[];
    const int n0 = blockIdx.x * GF_BN, m0 = blockIdx.y * GF_BM, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][4];
    gf_tile(packed, HD, wo, HD, M, HD, m0, n0, gf_smem, acc);
    float bs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bs[e] = __ldg(bo + n0 + tx + 16 * e);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const size_t at = (size_t)row * C + n0 + tx + 16 * e;
                out[at] = (acc[i][e] + bs[e]) + __ldg(res + at);
            }
        }
    }
}

static cudaError_t attention_block_f32_run(const float* x, const float* res, const float* wq, const float* wk,
                                           const float* wv, const float* wo, const float* bo, float* ws, float* out,
                                           int B, int L, int C, int H, int dp, cudaStream_t s) {
    const int HD = H * dp, M = B * L, mt = (M + GF_BM - 1) / GF_BM;
    if (mt > 65535) return cudaErrorInvalidValue;
    const size_t n = (size_t)M * HD;
    float *q = ws, *k = ws + n, *v = ws + 2 * n, *packed = ws + 3 * n;
    cudaError_t err = cudaFuncSetAttribute(attention_block_f32_qkv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GF_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(attention_block_f32_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)GF_SMEM);
    if (err != cudaSuccess) return err;
    attention_block_f32_qkv_kernel<<<dim3(3 * HD / GF_BN, mt), GF_THREADS, GF_SMEM, s>>>(x, wq, wk, wv, q, M, C, HD);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = (cudaError_t)attention_f32_dispatch<true>(q, k, v, packed, B, L, L, H, dp, dp, 1.0f, s);
    if (err != cudaSuccess) return err;
    attention_block_f32_out_kernel<<<dim3(C / GF_BN, mt), GF_THREADS, GF_SMEM, s>>>(packed, wo, bo, res, out, M, C,
                                                                                    HD);
    return cudaGetLastError();
}

}  // namespace saspa

// K1 in f32: q, k, v, out contiguous, 16-byte aligned (B, L, H*dp) f32 on the
// device, q pre-scaled by softmax_scale*log2(e); dp 64, 128 or 192; L % 64
// == 0.  Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_f32_packed(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, int dp, void* stream) {
    return saspa::attention_f32_dispatch<true>(q, k, v, out, B, L, L, H, dp, dp, 1.0f, stream);
}

// K6 in f32: q, out (B, Lq, H, d), k, v (B, Lk, H, d), contiguous, 16-byte
// aligned f32 on the device; d % 8 == 0 with dp = pad(d) in {64, 128, 192};
// Lq % 64 == 0, Lk % 64 == 0; q is multiplied by scale in f32.  Returns a
// cudaError_t (0 on success).
extern "C" int saspa_flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                                         int Lk, int H, int d, int dp, float scale, void* stream) {
    return saspa::attention_f32_dispatch<false>(q, k, v, out, B, Lq, Lk, H, d, dp, scale, stream);
}

// K5 in f32: x_ln, residual, out (B, L, C); wq (pre-scaled by
// softmax_scale*log2(e)), wk, wv (H*dp, C); wo (C, H*dp); bo (C,); ws 4 *
// B*L*H*dp floats (Q, K, V, then the packed heads, each (B, L, H*dp)).  All
// f32, contiguous and 16-byte aligned on the device; L % 64 == 0 (the
// core's 64-row query tiles and 64-key tiles), C % 64 == 0 (the products'
// 64-column tiles and 32-deep stages), dp 64, 128 or 192.  Returns a
// cudaError_t (0 on success).
extern "C" int saspa_attention_block_f32(const void* x_ln, const void* residual, const void* wq, const void* wk,
                                         const void* wv, const void* wo, const void* bo, void* ws, void* out, int B,
                                         int L, int C, int H, int dp, void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || L % AF_BM || C <= 0 || C % GF_BN ||
        (dp != 64 && dp != 128 && dp != 192))
        return (int)cudaErrorInvalidValue;
    return (int)attention_block_f32_run(
        static_cast<const float*>(x_ln), static_cast<const float*>(residual), static_cast<const float*>(wq),
        static_cast<const float*>(wk), static_cast<const float*>(wv), static_cast<const float*>(wo),
        static_cast<const float*>(bo), static_cast<float*>(ws), static_cast<float*>(out), B, L, C, H, dp,
        static_cast<cudaStream_t>(stream));
}
