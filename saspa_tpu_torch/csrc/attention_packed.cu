// Packed-heads self-attention for Hopper (K1).
//
// Replaces saspa_tpu/ops/attention.py::flash_attention_packed (Pallas kernel
// _packed_kernel).  Computes, for every batch row b and head h,
//     out[b, :, h*DP:(h+1)*DP] = softmax2(q_h k_h^T) v_h
// over packed (B, L, H*DP) bf16 tensors, where q arrives pre-scaled by
// softmax_scale*log2(e) so the softmax uses exp2.  Scores, running max, sum
// and the output accumulator are f32; P is rounded to bf16 before the P.V
// product (as the TPU kernel does); the output is bf16.  Zero-padded head
// columns of v give exactly-zero output columns.
//
// What bounds it on an H100: at the UNet's shapes (L = 4096/1024/256, head
// dims padded to 64/128/192) the work is 4*L^2*DP flops per (b, h) against
// 8*L*DP bytes, i.e. hundreds of flops per byte: tensor-core throughput
// bounds it, not HBM.  The TPU kernel kept all of K/V for one row resident in
// VMEM and took a single max pass; 4096 keys x DP do not fit in 227 KB of
// shared memory, so this kernel streams 64-key K/V tiles through shared
// memory with an online (running max/sum) softmax instead.
//
// Design: grid (q-tile x d-split, head, batch); 4 warps, each owning 16 query
// rows of a 64-row q tile.  Q.K^T and P.V run on bf16 mma.sync m16n8k16 with
// f32 accumulation; the packed layout is read by strides, with no transposes
// outside the kernel.  The VAE's single 512-wide head cannot keep a 16x512
// f32 accumulator in registers, so for DP = 512 each block owns a 128-column
// slice of the output (DO = 128) and recomputes the scores for its slice.
// K/V tiles are double-buffered with cp.async where shared memory allows
// (DP <= 192).  Simple, not yet tuned: no wgmma/TMA, no warp specialisation.
#include "mma_bf16.cuh"

#include <math.h>

namespace saspa {

constexpr int ATT_BM = 64;       // query rows per block
constexpr int ATT_BN = 64;       // keys per K/V tile
constexpr int ATT_THREADS = 128;

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

// rows x cols bf16 tile from global (row stride gstride) into smem (row stride sstride)
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* s, int sstride, const bf16* g, int gstride) {
    constexpr int CPR = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * CPR; i += ATT_THREADS) {
        int r = i / CPR, c = (i % CPR) * 8;
        cp_async_16(s + r * sstride + c, g + (size_t)r * gstride + c);
    }
}

template <int DP, int DO>
__global__ void __launch_bounds__(ATT_THREADS)
attention_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int L, int HD) {
    using Cfg = AttnCfg<DP, DO>;
    constexpr int SQ = Cfg::SQ, SV = Cfg::SV, STAGES = Cfg::STAGES;
    constexpr int NSPLIT = DP / DO;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + Cfg::Q_ELEMS;                  // STAGES x K tile
    bf16* sV = sK + STAGES * Cfg::K_ELEMS;         // STAGES x V tile

    const int qt = blockIdx.x / NSPLIT, split = blockIdx.x % NSPLIT;
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const size_t head_base = (size_t)b * L * HD + (size_t)h * DP;
    const bf16* qg = q + head_base + (size_t)qt * ATT_BM * HD;
    const bf16* kg = k + head_base;
    const bf16* vg = v + head_base + split * DO;
    const int nkv = L / ATT_BN;

    load_tile<ATT_BM, DP>(sQ, SQ, qg, HD);
    if (STAGES == 2) {
        load_tile<ATT_BN, DP>(sK, SQ, kg, HD);
        load_tile<ATT_BN, DO>(sV, SV, vg, HD);
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
                load_tile<ATT_BN, DP>(sK + nb * Cfg::K_ELEMS, SQ, kg + (size_t)(j + 1) * ATT_BN * HD, HD);
                load_tile<ATT_BN, DO>(sV + nb * Cfg::V_ELEMS, SV, vg + (size_t)(j + 1) * ATT_BN * HD, HD);
            }
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            load_tile<ATT_BN, DP>(sK, SQ, kg + (size_t)j * ATT_BN * HD, HD);
            load_tile<ATT_BN, DO>(sV, SV, vg + (size_t)j * ATT_BN * HD, HD);
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
    const int row0 = qt * ATT_BM + warp * 16 + g;
    bf16* o0 = o + head_base + (size_t)row0 * HD + split * DO;
    bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
        const int c = i * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[i][0] / l0, acc[i][1] / l0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(acc[i][2] / l1, acc[i][3] / l1);
    }
}

template <int DP, int DO>
static cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                          cudaStream_t stream) {
    const size_t smem = AttnCfg<DP, DO>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(attention_packed_kernel<DP, DO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((L / ATT_BM) * (DP / DO), H, B);
    attention_packed_kernel<DP, DO><<<grid, ATT_THREADS, smem, stream>>>(q, k, v, o, L, H * DP);
    return cudaGetLastError();
}

}  // namespace saspa

// q, k, v, out: contiguous (B, L, H*dp) bf16 on the device; L % 64 == 0;
// dp in {64, 128, 192, 512}.  Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_packed(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int H, int dp, void* stream) {
    using saspa::bf16;
    if (L % saspa::ATT_BM != 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dp) {
        case 64: return (int)saspa::launch<64, 64>(qp, kp, vp, op, B, L, H, s);
        case 128: return (int)saspa::launch<128, 128>(qp, kp, vp, op, B, L, H, s);
        case 192: return (int)saspa::launch<192, 192>(qp, kp, vp, op, B, L, H, s);
        case 512: return (int)saspa::launch<512, 128>(qp, kp, vp, op, B, L, H, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
