// Self-attention block for Hopper (K5).
//
// Replaces saspa_tpu/ops/attention.py::attention_block_fused (Pallas kernel
// _block_kernel).  For x_ln, residual: (B, L, C) bf16 and head-padded
// weights in torch's (out, in) layout, wq_scaled/wk/wv: (H*DP, C) with
// softmax_scale*log2(e) folded into wq, wo: (C, H*DP), bo: (C,) f32:
//     K, V   = bf16(x_ln wk^T), bf16(x_ln wv^T)
//     Q      = bf16(x_ln wq_scaled^T)
//     packed = bf16(softmax2(Q_h K_h^T) V_h) per head, packed (B, L, H*DP)
//     out    = bf16(packed wo^T + bo + residual)      (the sum in f32)
// with the TPU kernel's rounding points: every product accumulates in f32
// and is rounded to bf16 where the TPU kernel rounds it (the K/V scratch, Q,
// each head's output); P is rounded to bf16 before P.V.
//
// What bounds it on an H100: at the UNet's shapes (L = 4096/1024/256, C =
// 320/640/1280, H*DP = 512/1024/1536) the attention's 4*L^2*H*DP flops and the
// four projections' 8*L*C*H*DP flops per batch row dwarf the bytes (x_ln,
// residual and out are 3*L*C bf16, the weights 4*C*H*DP): tensor-core
// throughput bounds it.  The TPU kernel projected K/V for a whole batch row
// into VMEM scratch and kept it resident across that row's q-blocks; blocks
// here run in parallel and a 4096-row K/V does not fit in shared memory, so
// this first design runs three launches behind one wrapper:
//   (1) kv_proj: one GEMM writes K and V as bf16 to a workspace -- the
//       counterpart of the k_scr/v_scr scratch, rounded where it is rounded;
//   (2) block_attention: grid (q-tile, head, batch); each block projects its
//       64 x DP slice of Q (x_ln rows . wq_scaled head rows, f32 accumulate,
//       rounded to bf16) into shared memory, then runs K1's streamed exp2
//       attention (attention_tile.cuh) against K/V and writes the head's
//       output as bf16 into the packed workspace;
//   (3) out_proj: packed . wo^T with the epilogue f32 acc + bo + residual,
//       rounded to bf16.
// The streamed online softmax differs from the TPU kernel's one-pass softmax
// over a resident row only in summation order.  The extra HBM traffic against
// the TPU kernel is the K/V and packed workspaces (3 * B*L*H*DP bf16 written
// and read back).  Simple, not yet tuned: mma.sync, no wgmma/TMA.
#include "attention_tile.cuh"
#include "gemm_bf16.cuh"

namespace saspa {

// (1) grid (HD/64, ceil(M/64), 2): z = 0 writes K, z = 1 writes V
__global__ void __launch_bounds__(GM_THREADS)
kv_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
               bf16* __restrict__ kout, bf16* __restrict__ vout, int M, int C, int HD) {
    __shared__ __align__(16) uint16_t smem[2 * GM_BM * GM_S];
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sB = sA + GM_BM * GM_S;
    const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
    const bf16* w = blockIdx.z ? wv : wk;
    bf16* o = blockIdx.z ? vout : kout;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;

    float acc[2][4][4];
    zero_acc(acc);
    block_gemm_bt(acc, sA, sB, x, C, w, C, C, m0, n0, M);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
                if (row < M)
                    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * HD + col) =
                        __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
            }
        }
}

// (2) grid (L/64, H, B)
template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
block_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq, const bf16* __restrict__ kbuf,
                       const bf16* __restrict__ vbuf, bf16* __restrict__ packed, int L, int C, int HD) {
    using Cfg = AttnCfg<DP, DP>;
    constexpr int SQ = Cfg::SQ;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + Cfg::Q_ELEMS;
    bf16* sV = sK + Cfg::STAGES * Cfg::K_ELEMS;
    // the Q projection stages x and wq through the K buffers before the K/V loop
    bf16* sX = sK;                  // 64 x GM_S
    bf16* sW = sK + ATT_BM * GM_S;  // DP x GM_S
    static_assert(ATT_BM * GM_S + DP * GM_S <= Cfg::STAGES * Cfg::K_ELEMS, "Q staging exceeds the K buffers");

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bf16* xg = x + ((size_t)b * L + (size_t)qt * ATT_BM) * C;
    const bf16* wg = wq + (size_t)h * DP * C;

    // Q tile: this warp's 16 rows x DP columns, f32 accumulate over C
    float qacc[DP / 8][4];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) qacc[i][0] = qacc[i][1] = qacc[i][2] = qacc[i][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += GM_BK) {
        for (int i = threadIdx.x; i < (ATT_BM + DP) * (GM_BK / 8); i += ATT_THREADS) {
            const int r = i / (GM_BK / 8), c = (i % (GM_BK / 8)) * 8;
            if (r < ATT_BM)
                cp_async_16(sX + r * GM_S + c, xg + (size_t)r * C + k0 + c);
            else
                cp_async_16(sW + (r - ATT_BM) * GM_S + c, wg + (size_t)(r - ATT_BM) * C + k0 + c);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GM_BK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, sX + (warp * 16 + (lane % 16)) * GM_S + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int np = 0; np < DP / 16; ++np) {
                uint32_t bb[4];
                ldmatrix_x4(bb, sW + (np * 16 + (lane / 16) * 8 + (lane % 8)) * GM_S + kk * 16 + ((lane / 8) & 1) * 8);
                mma_bf16_16816(qacc[2 * np], a, bb[0], bb[1]);
                mma_bf16_16816(qacc[2 * np + 1], a, bb[2], bb[3]);
            }
        }
        __syncthreads();
    }
    bf16* q0 = sQ + (warp * 16 + g) * SQ;
    bf16* q1 = q0 + 8 * SQ;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
        const int c = i * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(q0 + c) = __floats2bfloat162_rn(qacc[i][0], qacc[i][1]);
        *reinterpret_cast<__nv_bfloat162*>(q1 + c) = __floats2bfloat162_rn(qacc[i][2], qacc[i][3]);
    }
    __syncthreads();

    const size_t head_base = (size_t)b * L * HD + (size_t)h * DP;
    attend_tile<DP, DP>(sQ, sK, sV, kbuf + head_base, vbuf + head_base,
                        packed + head_base + (size_t)qt * ATT_BM * HD, L, HD);
}

// (3) grid (C/64, ceil(M/64))
__global__ void __launch_bounds__(GM_THREADS)
out_proj_kernel(const bf16* __restrict__ packed, const bf16* __restrict__ wo, const float* __restrict__ bo,
                const bf16* __restrict__ res, bf16* __restrict__ out, int M, int HD, int C) {
    __shared__ __align__(16) uint16_t smem[2 * GM_BM * GM_S];
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sB = sA + GM_BM * GM_S;
    const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;

    float acc[2][4][4];
    zero_acc(acc);
    block_gemm_bt(acc, sA, sB, packed, HD, wo, HD, HD, m0, n0, M);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
            const float b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
                if (row >= M) continue;
                const float2 r = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * C + col));
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) = __floats2bfloat162_rn(
                    acc[mi][ni][2 * half] + b0 + r.x, acc[mi][ni][2 * half + 1] + b1 + r.y);
            }
        }
}

template <int DP>
static cudaError_t launch_attention(const bf16* x, const bf16* wq, const bf16* k, const bf16* v, bf16* packed,
                                    int B, int L, int C, int H, cudaStream_t stream) {
    const size_t smem = AttnCfg<DP, DP>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(block_attention_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    block_attention_kernel<DP><<<dim3(L / ATT_BM, H, B), ATT_THREADS, smem, stream>>>(x, wq, k, v, packed, L, C, H * DP);
    return cudaGetLastError();
}

}  // namespace saspa

// x_ln, residual, out: (B, L, C) bf16; wq, wk, wv: (H*dp, C) bf16; wo: (C, H*dp)
// bf16; bo: (C,) f32; kbuf, vbuf, packed: (B, L, H*dp) bf16 workspaces.  All
// contiguous on the device; L % 64 == 0, C % 64 == 0, dp in {64, 128, 192}.
// Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_block(const void* x_ln, const void* residual, const void* wq, const void* wk,
                                     const void* wv, const void* wo, const void* bo, void* kbuf, void* vbuf,
                                     void* packed, void* out, int B, int L, int C, int H, int dp, void* stream) {
    using saspa::bf16;
    if (B <= 0 || H <= 0 || L % saspa::ATT_BM || C % saspa::GM_BN || (dp != 64 && dp != 128 && dp != 192))
        return (int)cudaErrorInvalidValue;
    const int M = B * L, HD = H * dp, mb = (M + saspa::GM_BM - 1) / saspa::GM_BM;
    const bf16* x = static_cast<const bf16*>(x_ln);
    bf16* k = static_cast<bf16*>(kbuf);
    bf16* v = static_cast<bf16*>(vbuf);
    bf16* p = static_cast<bf16*>(packed);
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    saspa::kv_proj_kernel<<<dim3(HD / saspa::GM_BN, mb, 2), saspa::GM_THREADS, 0, s>>>(
        x, static_cast<const bf16*>(wk), static_cast<const bf16*>(wv), k, v, M, C, HD);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bf16* wqp = static_cast<const bf16*>(wq);
    switch (dp) {
        case 64: err = saspa::launch_attention<64>(x, wqp, k, v, p, B, L, C, H, s); break;
        case 128: err = saspa::launch_attention<128>(x, wqp, k, v, p, B, L, C, H, s); break;
        case 192: err = saspa::launch_attention<192>(x, wqp, k, v, p, B, L, C, H, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    saspa::out_proj_kernel<<<dim3(C / saspa::GM_BN, mb), saspa::GM_THREADS, 0, s>>>(
        p, static_cast<const bf16*>(wo), static_cast<const float*>(bo), static_cast<const bf16*>(residual),
        static_cast<bf16*>(out), M, HD, C);
    return (int)cudaGetLastError();
}
