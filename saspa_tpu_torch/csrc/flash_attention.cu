// Streamed flash attention over unpadded heads for Hopper (K6).
//
// Replaces saspa_tpu/ops/attention.py::_flash_attention_padded (Pallas kernel
// _flash_kernel, reached through flash_attention).  Computes, for every batch
// row b and head h,
//     out[b, :, h, :] = softmax(bf16(q[b, :, h, :] * scale) k_h^T) v_h
// with q: (B, Lq, H, dc), k, v: (B, Lk, H, dc) and out: (B, Lq, H, dc), all
// contiguous bf16, i.e. the (B, L, H*dc) projections as they leave the
// linear layers.  As the TPU kernel does: the scale is folded into q and
// rounded to bf16, the softmax is base e with f32 scores, running max, sum
// and accumulator, P is rounded to bf16 before the P.V product, and the
// output is bf16.
//
// What bounds it on an H100: at its main-path site (SD1.5 at 1024^2, UNet and
// ControlNet level 0: L = 16384, 8 heads of 40 padded to 64) the work is
// 4*L^2*64 flops per (b, h) against 8*L*40 bytes: thousands of flops per byte,
// so tensor-core throughput bounds it.  The TPU path padded and transposed
// q/k/v to (B*H, L, 64) through HBM before the kernel and sliced the output
// after it; here the kernel reads the unpadded rows by strides (16-byte
// cp.async per 8 columns; dc % 8 == 0 keeps every row start aligned) and
// pads to DP = 64/128/192 in shared memory, so no copy leaves the kernel.
//
// Design: the tile loop of K1 (attention_tile.cuh, UNPADDED layout): grid
// (q tile, head, batch), 4 warps of 16 query rows, 64-key K/V tiles
// double-buffered with cp.async, bf16 mma.sync with f32 accumulation, online
// softmax.  The TPU kernel's base-e softmax becomes the tile loop's base-2
// one by multiplying the f32 scores by log2(e) (the same exp(s - max) up to
// f32 rounding).  The TPU kernel streamed block_kv = 512 (or 256) keys per
// step against a resident q block; this one streams 64, so P is rounded to
// bf16 against a running max of other chunks (the tolerance covers it).
// Simple, not yet tuned: no wgmma/TMA, no warp specialisation.
#include "attention_tile.cuh"

namespace saspa {

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       bf16* __restrict__ o, int Lq, int Lk, int H, int dc, float scale) {
    using Cfg = AttnCfg<DP, DP>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + Cfg::Q_ELEMS;                  // STAGES x K tile
    bf16* sV = sK + Cfg::STAGES * Cfg::K_ELEMS;    // STAGES x V tile

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int ld = H * dc;
    const size_t q_tile = ((size_t)b * Lq + (size_t)qt * ATT_BM) * ld + (size_t)h * dc;
    const size_t kv_head = (size_t)b * Lk * ld + (size_t)h * dc;

    // zero the pad columns dc..DP-1 of Q and of every K/V stage once: the
    // loads below only ever fill columns 0..dc-1
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int pad = DP - dc;
    for (int i = threadIdx.x; i < ATT_BM * pad; i += ATT_THREADS) {
        const int r = i / pad, c = dc + i % pad;
        sQ[r * Cfg::SQ + c] = zero;
#pragma unroll
        for (int s = 0; s < Cfg::STAGES; ++s) {
            sK[s * Cfg::K_ELEMS + r * Cfg::SQ + c] = zero;
            sV[s * Cfg::V_ELEMS + r * Cfg::SV + c] = zero;
        }
    }

    load_tile<ATT_BM>(sQ, Cfg::SQ, q + q_tile, ld, dc);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // q * scale rounded to bf16, as the plain version (and the TPU path's
    // (q * scale).astype(q.dtype)) does; attend_tile's first barrier makes
    // these writes visible before any warp reads sQ
    for (int i = threadIdx.x; i < ATT_BM * dc; i += ATT_THREADS) {
        bf16* p = sQ + (i / dc) * Cfg::SQ + i % dc;
        *p = __float2bfloat16_rn(__bfloat162float(*p) * scale);
    }
    attend_tile<DP, DP, true>(sQ, sK, sV, k + kv_head, v + kv_head, o + q_tile, Lk, ld, dc);
}

template <int DP>
static cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Lq, int Lk, int H, int dc,
                          float scale, cudaStream_t stream) {
    const size_t smem = AttnCfg<DP, DP>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(Lq / ATT_BM, H, B);
    flash_attention_kernel<DP><<<grid, ATT_THREADS, smem, stream>>>(q, k, v, o, Lq, Lk, H, dc, scale);
    return cudaGetLastError();
}

}  // namespace saspa

// q, out: contiguous (B, Lq, H, dc) bf16; k, v: contiguous (B, Lk, H, dc)
// bf16, all 16-byte aligned; Lq % 64 == Lk % 64 == 0; dc % 8 == 0 with
// dc <= dp, dp in {64, 128, 192} the padded head dim.  scale: the softmax
// scale, already rounded to bf16.  Returns a cudaError_t (0 on success).
extern "C" int saspa_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
                                     int H, int dc, int dp, float scale, void* stream) {
    using saspa::bf16;
    if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || Lq <= 0 || Lk <= 0 || Lq % saspa::ATT_BM ||
        Lk % saspa::ATT_BN || dc <= 0 || dc % 8 || dc > dp)
        return (int)cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dp) {
        case 64: return (int)saspa::launch<64>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        case 128: return (int)saspa::launch<128>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        case 192: return (int)saspa::launch<192>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
