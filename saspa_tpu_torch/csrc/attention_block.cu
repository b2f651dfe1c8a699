// Self-attention block for Hopper (K5).
//
// Replaces saspa_tpu/ops/attention.py::attention_block_fused (Pallas kernel
// _block_kernel).  For x_ln, residual: (B, L, C) bf16 and head-padded
// weights in torch's (out, in) layout, wq_scaled/wk/wv: (H*DP, C) with
// softmax_scale*log2(e) folded into wq, wo: (C, H*DP), bo: (C,) f32:
//     Q, K, V = bf16(x_ln wq_scaled^T), bf16(x_ln wk^T), bf16(x_ln wv^T)
//     packed  = bf16(softmax2(Q_h K_h^T) V_h) per head, packed (B, L, H*DP)
//     out     = bf16(packed wo^T + bo + residual)      (the sum in f32)
// with the TPU kernel's rounding points: every product accumulates in f32
// and is rounded to bf16 where the TPU kernel rounds it (the K/V scratch, Q,
// each head's output); P is rounded to bf16 before P.V.
//
// What bounds it on an H100: tensor-core throughput.  At the UNet's shapes
// (L = 4096/1024/256, C = 320/640/1280, H*DP = 512/1024/1536) the
// attention's 4*L^2*H*DP flops and the four projections' 8*L*C*H*DP flops per
// batch row dwarf the bytes (x_ln, residual and out are 3*L*C bf16, the
// weights 4*C*H*DP), and only wgmma reaches the card's bf16 rate.  The TPU
// kernel projected K/V for a whole batch row into VMEM scratch and kept it
// resident across that row's q-blocks; 4096 keys do not fit in a block's
// shared memory, and blocks here run in parallel, so the function runs as
// three wgmma + TMA kernels behind one entry point, with Q, K, V and the
// packed heads round-tripping HBM as bf16 (where the TPU kernel rounds them
// too, so the function is the same):
//   1. attention_block_qkv_kernel<BN>: [Q | K | V] = x_ln [wq | wk | wv]^T on
//      the persistent product walk of gemm_wgmma.cuh (shared with K2), 128
//      rows x BN columns a tile, BN = 128 where H*DP % 128 == 0 (SD1.5, SDXL,
//      the refiner), else 64 (SD2.1's 5 heads of 64 at level 0: H*DP = 320),
//      so that no tile straddles two projections; the load picks wq's, wk's
//      or wv's tensor map by the N tile, so nothing is concatenated per
//      call, and the epilogue
//      rounds to bf16 into K1's packed (B, L, H*DP) layout, 16 bytes a
//      thread after a transpose across each quad of lanes (quad_transpose:
//      4-byte stores of the accumulator's layout cost more than the
//      product at C = 320);
//   2. attention_block_attend_kernel: K1's wgmma attention block
//      (attention_packed_wgmma.cuh) on Q, K, V, writing the packed heads;
//   3. attention_block_out_kernel<BN>: packed wo^T on the same walk, BN = 160
//      output columns a tile where C % 160 == 0 (else 64), with the epilogue
//      acc + bo + residual in f32, rounded once, 16 bytes a thread.
// The streamed online softmax differs from the TPU kernel's one-pass softmax
// over a resident row only in summation order.
#include "attention_packed_wgmma.cuh"
#include "gemm_wgmma.cuh"

namespace saspa {

// Persistent blocks over the (3 * HD / BN) x ceil(M / 128) tiles of
// [Q | K | V]: N tiles 0 .. HD/BN - 1 are Q's, then K's, then V's.
template <int BN>
__global__ void __launch_bounds__(GG_THREADS, 2)
attention_block_qkv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mwq,
                           const __grid_constant__ CUtensorMap mwk, const __grid_constant__ CUtensorMap mwv,
                           bf16* __restrict__ qkv, int M, int C, int HD) {
    __shared__ __align__(8) uint64_t bars[2 * GG_STAGES];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int per = HD / BN, nt = 3 * per;  // N tiles of one projection, of all three

    auto load = [&](int n, int m, int j, uint32_t a, uint32_t b, uint32_t bar) {
        const int which = n / per;
        const CUtensorMap* w = which == 0 ? &mwq : which == 1 ? &mwk : &mwv;
        tma_load_2d(a, &mx, j * 64, m * GG_BM, bar);
        tma_load_2d(b, w, j * 64, (n % per) * BN, bar);
    };
    auto epi = [&](int n, int m, float (&acc)[BN / 2]) {
        bf16* o = qkv + (size_t)(n / per) * M * HD;  // Q, K, V: (M, HD) each, one after another
        const int row0 = m * GG_BM + (threadIdx.x / 32) * 16 + g;
#pragma unroll
        for (int i = 0; i < BN / 8; i += 4)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                uint32_t w[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    w[j] = pack_bf16(acc[4 * (i + j) + 2 * half], acc[4 * (i + j) + 2 * half + 1]);
                quad_transpose(w);  // now columns 8(i + t) .. + 7
                const int row = row0 + 8 * half;
                if (row < M)
                    *reinterpret_cast<uint4*>(o + (size_t)row * HD + (n % per) * BN + 8 * (i + t)) =
                        make_uint4(w[0], w[1], w[2], w[3]);
            }
    };
    gg_tiles<BN>(smem, bars, C / 64, nt, nt * ((M + GG_BM - 1) / GG_BM), load, epi);
}

// K5's __global__ for packed_attention_wgmma (attention_packed_wgmma.cuh).
template <int DP, int WGS>
__global__ void __launch_bounds__(WgCfg<DP, WGS>::THREADS, 1)
attention_block_attend_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int L, int HD) {
    packed_attention_wgmma<DP, WGS>(mq, mk, mv, o, L, HD);
}

struct K5Kernels {
    template <int DP, int WGS>
    static PackedWgmmaKernel get() { return attention_block_attend_kernel<DP, WGS>; }
};

// Persistent blocks over the (C / BN) x ceil(M / 128) tiles of out.
template <int BN>
__global__ void __launch_bounds__(GG_THREADS, 2)
attention_block_out_kernel(const __grid_constant__ CUtensorMap mp, const __grid_constant__ CUtensorMap mwo,
                           const float* __restrict__ bo, const bf16* __restrict__ res, bf16* __restrict__ out, int M,
                           int C, int HD) {
    __shared__ __align__(8) uint64_t bars[2 * GG_STAGES];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int nt = C / BN;

    auto load = [&](int n, int m, int j, uint32_t a, uint32_t b, uint32_t bar) {
        tma_load_2d(a, &mp, j * 64, m * GG_BM, bar);
        tma_load_2d(b, &mwo, j * 64, n * BN, bar);
    };
    auto epi = [&](int n, int m, float (&acc)[BN / 2]) {
        const int row0 = m * GG_BM + (threadIdx.x / 32) * 16 + g;
#pragma unroll
        for (int i = 0; i < BN / 8; i += 4) {
            const int col = n * BN + 8 * (i + t);  // this thread's 8 columns after the transposes
            const float4 b0 = *reinterpret_cast<const float4*>(bo + col);
            const float4 b1 = *reinterpret_cast<const float4*>(bo + col + 4);
            const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                uint32_t ev[4], od[4];  // the f32 sums of even and of odd columns
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    ev[j] = __float_as_uint(acc[4 * (i + j) + 2 * half]);
                    od[j] = __float_as_uint(acc[4 * (i + j) + 2 * half + 1]);
                }
                quad_transpose(ev);
                quad_transpose(od);
                const int row = row0 + 8 * half;
                if (row >= M) continue;
                const uint4 rr = *reinterpret_cast<const uint4*>(res + (size_t)row * C + col);
                const bf16* r = reinterpret_cast<const bf16*>(&rr);
                uint32_t o[4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    o[k] = pack_bf16(__uint_as_float(ev[k]) + bs[2 * k] + __bfloat162float(r[2 * k]),
                                     __uint_as_float(od[k]) + bs[2 * k + 1] + __bfloat162float(r[2 * k + 1]));
                *reinterpret_cast<uint4*>(out + (size_t)row * C + col) = make_uint4(o[0], o[1], o[2], o[3]);
            }
        }
    };
    gg_tiles<BN>(smem, bars, HD / 64, nt, nt * ((M + GG_BM - 1) / GG_BM), load, epi);
}

template <int BN>
static cudaError_t launch_qkv(const void* x, const void* wq, const void* wk, const void* wv, bf16* qkv, int M, int C,
                              int HD, cudaStream_t s) {
    CUtensorMap mx, mwq, mwk, mwv;
    if (!bf16_map_sw128(&mx, x, M, C, GG_BM) || !bf16_map_sw128(&mwq, wq, HD, C, BN) ||
        !bf16_map_sw128(&mwk, wk, HD, C, BN) || !bf16_map_sw128(&mwv, wv, HD, C, BN))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_block_qkv_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GgCfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    const int ntiles = 3 * (HD / BN) * ((M + GG_BM - 1) / GG_BM);
    attention_block_qkv_kernel<BN><<<gg_grid(ntiles), GG_THREADS, GgCfg<BN>::SMEM, s>>>(mx, mwq, mwk, mwv, qkv, M, C,
                                                                                         HD);
    return cudaGetLastError();
}

template <int BN>
static cudaError_t launch_out(const bf16* packed, const void* wo, const float* bo, const bf16* res, bf16* out, int M,
                              int C, int HD, cudaStream_t s) {
    CUtensorMap mp, mwo;
    if (!bf16_map_sw128(&mp, packed, M, HD, GG_BM) || !bf16_map_sw128(&mwo, wo, C, HD, BN))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_block_out_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GgCfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    const int ntiles = (C / BN) * ((M + GG_BM - 1) / GG_BM);
    attention_block_out_kernel<BN><<<gg_grid(ntiles), GG_THREADS, GgCfg<BN>::SMEM, s>>>(mp, mwo, bo, res, out, M, C,
                                                                                         HD);
    return cudaGetLastError();
}

}  // namespace saspa

// x_ln, residual, out: (B, L, C) bf16; wq, wk, wv: (H*dp, C) bf16; wo: (C, H*dp)
// bf16; bo: (C,) f32; ws: 4 * B*L*H*dp bf16 scratch (Q, K, V, then the packed
// heads, each (B, L, H*dp)).  All contiguous and 16-byte aligned on the
// device; L % 128 == 0, C % 64 == 0, dp in {64, 128, 192} (so H*dp % 64 == 0:
// the Q/K/V product takes 64-column tiles where H*dp % 128 != 0, and the out
// product walks H*dp in 64-wide stages).  Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_block(const void* x_ln, const void* residual, const void* wq, const void* wk,
                                     const void* wv, const void* wo, const void* bo, void* ws, void* out, int B,
                                     int L, int C, int H, int dp, void* stream) {
    using namespace saspa;
    const int HD = H * dp;
    if (B <= 0 || H <= 0 || L <= 0 || L % 128 || C <= 0 || C % 64 || (dp != 64 && dp != 128 && dp != 192))
        return (int)cudaErrorInvalidValue;
    const int M = B * L;
    const size_t n = (size_t)M * HD;
    bf16* q = static_cast<bf16*>(ws);
    bf16* packed = q + 3 * n;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = HD % 128 == 0 ? launch_qkv<128>(x_ln, wq, wk, wv, q, M, C, HD, s)
                                    : launch_qkv<64>(x_ln, wq, wk, wv, q, M, C, HD, s);
    if (err == cudaSuccess) err = launch_packed_wgmma<K5Kernels>(q, q + n, q + 2 * n, packed, B, L, H, dp, s);
    if (err != cudaSuccess) return (int)err;
    const float* bop = static_cast<const float*>(bo);
    const bf16* rp = static_cast<const bf16*>(residual);
    bf16* op = static_cast<bf16*>(out);
    return (int)(C % 160 == 0 ? launch_out<160>(packed, wo, bop, rp, op, M, C, HD, s)
                              : launch_out<64>(packed, wo, bop, rp, op, M, C, HD, s));
}
