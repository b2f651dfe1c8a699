// The wgmma attention step shared by K1 (attention_packed.cu) and K6
// (flash_attention.cu): for one warpgroup of 64 query rows and one tile of BN
// keys, S = Q K^T on wgmma from shared memory, an online (running max/sum)
// softmax in registers, and O += bf16(P) V with P as wgmma's register
// operand.  Tiles are 64-column TMA boxes with the 128-byte swizzle
// (wgmma_tma.cuh); S and O use the accumulator layout described there, so
// thread (g = lane / 4) holds rows g and g + 8 of its warp's 16.
#pragma once

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

#include <math.h>

namespace saspa {

// S = Q K^T over the first K columns of the head (K % 16 == 0; issued, not
// waited).  Q: Q_BOX-byte boxes of this warpgroup's rows; K: BN-row boxes.
template <int K, int BN, int Q_BOX>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t qa, uint32_t kb) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;  // 16 columns = 32 bytes into the 128-byte row
        const uint64_t da = sw128_desc(qa + (kk / 4) * Q_BOX + koff, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk / 4) * BN * 128 + koff, 16, 1024);
        if constexpr (BN == 128) wgmma_ss_n128(s, da, db, kk > 0);
        else wgmma_ss_n64(s, da, db, kk > 0);
    }
}

// O += bf16(P) V over one BN-key tile for the first N output columns
// (issued, not waited).
template <int N, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[N / 2], uint32_t (&p)[BN / 16][4], uint32_t vb) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t dv = sw128_desc(vb + kc * 16 * 128, BN * 128, 1024);
        if constexpr (N == 40) wgmma_rs_n40(o, p[kc], dv);
        else if constexpr (N == 64) wgmma_rs_n64(o, p[kc], dv);
        else if constexpr (N == 128) wgmma_rs_n128(o, p[kc], dv);
        else wgmma_rs_n192(o, p[kc], dv);
    }
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0 (beside a
// row sum >= 1 they are nothing).
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Online softmax of one tile's scores, in place: s becomes
// exp2(c * (s - new max)), c = 1 for base-2 scores and log2(e) for base-e
// ones (one FFMA a score); the row sums l take the factors al and the new
// terms.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float c, float& m0, float& m1, float& l0,
                                               float& l1, float& al0, float& al1) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mc0 = mn0 * c, mc1 = mn1 * c;
    al0 = exp2_ftz(m0 * c - mc0);
    al1 = exp2_ftz(m1 * c - mc1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        s[4 * i] = exp2_ftz(fmaf(s[4 * i], c, -mc0));
        s[4 * i + 1] = exp2_ftz(fmaf(s[4 * i + 1], c, -mc0));
        s[4 * i + 2] = exp2_ftz(fmaf(s[4 * i + 2], c, -mc1));
        s[4 * i + 3] = exp2_ftz(fmaf(s[4 * i + 3], c, -mc1));
        l0 += s[4 * i] + s[4 * i + 1];
        l1 += s[4 * i + 2] + s[4 * i + 3];
    }
}

// bf16(P) as wgmma's register A operand: 16 keys per step, S's chunks 2kc, 2kc+1.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
        p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
}

// O *= the factors of its rows; skipped (the same result) where no row of
// the warp has a new max.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float al0, float al1) {
    if (!__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) return;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
    }
}

template <int BN>
__device__ __forceinline__ void fence_p(uint32_t (&p)[BN / 16][4]) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) fence_regs(p[kc]);
}

}  // namespace saspa
