// A block-level bf16 GEMM tile shared by the port's kernels (K2, K5):
// C[m0:m0+64, n0:n0+64] (+)= A[m0:m0+64, :K] . B[n0:n0+64, :K]^T with both
// operands row-major along K (B in torch's (out, in) weight layout), f32
// accumulation on mma.sync m16n8k16, 4 warps of 32x32, 32-deep k steps
// staged through shared memory with cp.async.
//
// Accumulator layout of warp w (wm = w / 2, wn = w % 2): acc[mi][ni][e] is
// row m0 + wm*32 + mi*16 + lane/4 + (e/2)*8, col n0 + wn*32 + ni*8 + 2*(lane%4) + e%2.
#pragma once

#include "mma_bf16.cuh"

namespace saspa {

constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 32;
constexpr int GM_THREADS = 128;
constexpr int GM_S = GM_BK + 8;  // padded smem row stride (80 bytes: ldmatrix conflict-free)

// 64 rows x 32 cols of a row-major bf16 matrix (row stride ld) into smem;
// rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_rows_async(bf16* s, const bf16* g, int ld, int rows = GM_BM) {
    for (int i = threadIdx.x; i < GM_BM * (GM_BK / 8); i += GM_THREADS) {
        int r = i / (GM_BK / 8), c = (i % (GM_BK / 8)) * 8;
        if (r < rows)
            cp_async_16(s + r * GM_S + c, g + (size_t)r * ld + c);
        else
            *reinterpret_cast<uint4*>(s + r * GM_S + c) = make_uint4(0, 0, 0, 0);
    }
}

// One 32-deep step of a warp's 32x32 tile: acc[mi][ni] += A[rows] * B[cols]^T.
__device__ __forceinline__ void warp_mma_step(float acc[2][4][4], const bf16* sA, const bf16* sB,
                                              int wm, int wn, int lane) {
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(a[mi], sA + (wm * 32 + mi * 16 + (lane % 16)) * GM_S + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, sB + (wn * 32 + np * 16 + (lane / 16) * 8 + (lane % 8)) * GM_S + kk * 16 + ((lane / 8) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                mma_bf16_16816(acc[mi][2 * np], a[mi], b[0], b[1]);
                mma_bf16_16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
            }
        }
    }
}

__device__ __forceinline__ void zero_acc(float acc[2][4][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += A[m0:m0+64, :K] . B[n0:n0+64, :K]^T; A rows at or past M read as
// zero; K % 32 == 0.  sA, sB: 64 x GM_S bf16 each.
__device__ __forceinline__ void block_gemm_bt(float acc[2][4][4], bf16* sA, bf16* sB, const bf16* A, int lda,
                                              const bf16* B, int ldb, int K, int m0, int n0, int M) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int k0 = 0; k0 < K; k0 += GM_BK) {
        load_rows_async(sA, A + (size_t)m0 * lda + k0, lda, M - m0);
        load_rows_async(sB, B + (size_t)n0 * ldb + k0, ldb);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        warp_mma_step(acc, sA, sB, warp / 2, warp % 2, lane);
        __syncthreads();
    }
}

}  // namespace saspa
