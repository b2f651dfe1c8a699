// Streamed attention of one 64-row query tile on mma.sync, shared by K1's
// 512-wide VAE head (attention_packed.cu) and K5 (attention_block.cu).
//
// For one (batch row, head), softmax2(Q K^T) V over the L keys: 4 warps,
// each owning 16 query rows; Q.K^T and P.V on bf16 mma.sync m16n8k16 with f32
// accumulation; 64-key K/V tiles streamed through shared memory
// (double-buffered with cp.async where shared memory allows, DP <= 192) with
// an online (running max/sum) softmax in base 2.  Scores, running max, sum
// and the output accumulator are f32; P is rounded to bf16 before the P.V
// product, as the TPU kernels do; the output is rounded to bf16.  K, V and
// the output rows hold the padded head dims, and log2(e) is folded into q,
// so the scores are base 2.
#pragma once

#include "mma_bf16.cuh"

#include <math.h>

namespace saspa {

constexpr int ATT_BM = 64;       // query rows per block
constexpr int ATT_BN = 64;       // keys per K/V tile
constexpr int ATT_THREADS = 128;

// DP: (padded) head dim of Q and K; DO: the output columns this block owns.
template <int DP, int DO>
struct AttnCfg {
    static constexpr int SQ = DP + 8;  // padded smem row strides (elements):
    static constexpr int SV = DO + 8;  // +16 bytes keeps ldmatrix conflict-free
    static constexpr int STAGES = (DP <= 192) ? 2 : 1;
    static constexpr int Q_ELEMS = ATT_BM * SQ;
    static constexpr int K_ELEMS = ATT_BN * SQ;
    static constexpr int V_ELEMS = ATT_BN * SV;
    static constexpr size_t SMEM = sizeof(bf16) * (Q_ELEMS + STAGES * (K_ELEMS + V_ELEMS));
};

// ROWS x cols bf16 tile (cols % 8 == 0) from global (row stride gstride) into
// smem (row stride sstride); callers with a constant cols get it folded
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, int sstride, const bf16* g, int gstride, int cols) {
    const int cpr = cols / 8;
    for (int i = threadIdx.x; i < ROWS * cpr; i += ATT_THREADS) {
        int r = i / cpr, c = (i % cpr) * 8;
        cp_async_16(s + r * sstride + c, g + (size_t)r * gstride + c);
    }
}

// sQ: the 64 x DP query tile (row stride DP + 8), either committed by the
// caller as its own cp.async group or written and synchronised.  sK, sV: the
// K/V staging buffers of AttnCfg<DP, DO>.  kg: the head's first K row; vg:
// the first V column of this block's DO-wide slice; og: the output at the
// tile's first query row and the slice's first column.  K, V and the output
// share the row stride ld (elements); L % 64 == 0.
template <int DP, int DO>
__device__ __forceinline__ void attend_tile(const bf16* sQ, bf16* sK, bf16* sV, const bf16* kg, const bf16* vg,
                                            bf16* og, int L, int ld) {
    using Cfg = AttnCfg<DP, DO>;
    constexpr int SQ = Cfg::SQ, SV = Cfg::SV, STAGES = Cfg::STAGES;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int nkv = L / ATT_BN;

    if (STAGES == 2) {
        load_tile<ATT_BN>(sK, SQ, kg, ld, DP);
        load_tile<ATT_BN>(sV, SV, vg, ld, DO);
    }
    cp_async_commit();

    float acc[DO / 8][4];
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int j = 0; j < nkv; ++j) {
        const int buf = (STAGES == 2) ? (j & 1) : 0;
        if (STAGES == 2) {
            if (j + 1 < nkv) {
                const int nb = (j + 1) & 1;
                load_tile<ATT_BN>(sK + nb * Cfg::K_ELEMS, SQ, kg + (size_t)(j + 1) * ATT_BN * ld, ld, DP);
                load_tile<ATT_BN>(sV + nb * Cfg::V_ELEMS, SV, vg + (size_t)(j + 1) * ATT_BN * ld, ld, DO);
            }
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            load_tile<ATT_BN>(sK, SQ, kg + (size_t)j * ATT_BN * ld, ld, DP);
            load_tile<ATT_BN>(sV, SV, vg + (size_t)j * ATT_BN * ld, ld, DO);
            cp_async_commit();
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* cK = sK + buf * Cfg::K_ELEMS;
        const bf16* cV = sV + buf * Cfg::V_ELEMS;

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, sQ + (warp * 16 + (lane % 16)) * SQ + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bb[4];
                ldmatrix_x4(bb, cK + (np * 16 + (lane / 16) * 8 + (lane % 8)) * SQ + kk * 16 + ((lane / 8) & 1) * 8);
                mma_bf16_16816(s[2 * np], a, bb[0], bb[1]);
                mma_bf16_16816(s[2 * np + 1], a, bb[2], bb[3]);
            }
        }

        // online softmax (base 2): rows g and g+8 of the warp's 16
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
            mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            s[i][0] = exp2f(s[i][0] - mn0);
            s[i][1] = exp2f(s[i][1] - mn0);
            s[i][2] = exp2f(s[i][2] - mn1);
            s[i][3] = exp2f(s[i][3] - mn1);
            l0 += s[i][0] + s[i][1];
            l1 += s[i][2] + s[i][3];
        }
#pragma unroll
        for (int i = 0; i < DO / 8; ++i) {
            acc[i][0] *= al0;
            acc[i][1] *= al0;
            acc[i][2] *= al1;
            acc[i][3] *= al1;
        }

        // acc += bf16(P) V ; P's C-fragments are reused as A-fragments
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            uint32_t a[4];
            a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
            a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
            a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
            a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
            for (int dp = 0; dp < DO / 16; ++dp) {
                uint32_t bb[4];
                ldmatrix_x4_trans(bb, cV + (kc * 16 + ((lane / 8) & 1) * 8 + (lane % 8)) * SV + dp * 16 + (lane / 16) * 8);
                mma_bf16_16816(acc[2 * dp], a, bb[0], bb[1]);
                mma_bf16_16816(acc[2 * dp + 1], a, bb[2], bb[3]);
            }
        }
        __syncthreads();  // the buffer just read is refilled next iteration
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    bf16* o0 = og + (size_t)(warp * 16 + g) * ld;
    bf16* o1 = o0 + (size_t)8 * ld;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
        const int c = i * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[i][0] / l0, acc[i][1] / l0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(acc[i][2] / l1, acc[i][3] / l1);
    }
}

}  // namespace saspa
