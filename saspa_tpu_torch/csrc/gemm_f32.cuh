// A register-tiled f32 product on the CUDA cores (FFMA), for K5 in f32
// (attention_f32.cu: the Q/K/V and out projections of
// saspa_attention_block_f32).
//
// acc = A B^T over one 128-row x 64-column output tile, A (M, K) and B (N, K)
// both contiguous along K (x_ln against torch's (out, in) weights, the
// packed heads against wo).  Every product and sum is f32: TF32 tensor cores
// would round A and B to 10 mantissa bits, other numerics than the TPU
// kernel's f32 block (the f32 attention core, attention_f32.cu, is FFMA for
// the same reason).
//
// A block of GF_THREADS = 256 walks K in stages of GF_BK = 32, two stages in
// shared memory, each loaded by cp.async one stage ahead of its use.  The
// tiles land as they lie in device memory (rows along K, padded by 4 floats:
// a warp's 16-byte reads of 8 consecutive rows then hit distinct bank
// quads), and each thread reads float4 runs along K of its rows and
// columns: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i <
// 8) and columns tx + 16 e (e < 4), 32 accumulators, 128 FFMAs for every 12
// shared-memory reads of 16 bytes.  Rows of A at or past M are read as 0 (a
// block's last row tile may be ragged); N and K are whole tiles.
// Shared memory: 2 x (128 + 64) x 36 floats = 55,296 bytes; two blocks an SM.
#pragma once

#include "mma_bf16.cuh"

namespace saspa {

constexpr int GF_BM = 128;        // output rows a block
constexpr int GF_BN = 64;         // output columns a block
constexpr int GF_BK = 32;         // K a stage
constexpr int GF_THREADS = 256;
constexpr int GF_S = GF_BK + 4;   // a tile row's stride in shared memory (floats)
constexpr int GF_STAGE = (GF_BM + GF_BN) * GF_S;  // floats a stage
constexpr size_t GF_SMEM = 2 * (size_t)GF_STAGE * 4;

__device__ __forceinline__ float gf_dot4(const float4& a, const float4& b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
}

// acc[i][e] = sum over k of A[m0 + ty + 16 i][k] * B[n0 + tx + 16 e][k] for
// this thread's (ty, tx); lda, ldb: the row strides (floats, multiples of
// 4); K % GF_BK == 0; rows n0 .. n0 + 63 of B exist.  smem: GF_SMEM bytes,
// 16-byte aligned.  Every thread of the block calls it.
__device__ __forceinline__ void gf_tile(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
                                        int M, int K, int m0, int n0, float* smem, float (&acc)[8][4]) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    constexpr int CH = GF_BK / 4;  // 16-byte chunks a tile row
    auto load = [&](int st, int kt) {
        float* sa = smem + st * GF_STAGE;
        float* sb = sa + GF_BM * GF_S;
        const int k0 = kt * GF_BK;
#pragma unroll
        for (int r = 0; r < GF_BM * CH / GF_THREADS; ++r) {
            const int i = tid + r * GF_THREADS, row = i / CH, c = (i % CH) * 4;
            float* dst = sa + row * GF_S + c;
            if (m0 + row < M)
                cp_async_16(dst, A + (size_t)(m0 + row) * lda + k0 + c);
            else
                *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < GF_BN * CH / GF_THREADS; ++r) {
            const int i = tid + r * GF_THREADS, row = i / CH, c = (i % CH) * 4;
            cp_async_16(sb + row * GF_S + c, B + (size_t)(n0 + row) * ldb + k0 + c);
        }
    };
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const int nk = K / GF_BK;
    load(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load((kt + 1) % 2, kt + 1);
        cp_async_commit();  // (an empty group on the last stage keeps the wait count)
        cp_async_wait<1>();  // stage kt landed
        __syncthreads();
        const float* sa = smem + (kt % 2) * GF_STAGE;
        const float* sb = sa + GF_BM * GF_S;
#pragma unroll
        for (int k = 0; k < GF_BK; k += 4) {
            float4 a[8], b[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * GF_S + k);
#pragma unroll
            for (int e = 0; e < 4; ++e) b[e] = *reinterpret_cast<const float4*>(sb + (tx + 16 * e) * GF_S + k);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][e] = gf_dot4(a[i], b[e], acc[i][e]);
        }
        __syncthreads();  // every thread done with stage kt before its buffer is refilled
    }
    cp_async_wait<0>();
}

}  // namespace saspa
