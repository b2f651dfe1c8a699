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
// The per-tile loop lives in attention_tile.cuh, shared with K5.
#include "attention_tile.cuh"

namespace saspa {

template <int DP, int DO>
__global__ void __launch_bounds__(ATT_THREADS)
attention_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int L, int HD) {
    using Cfg = AttnCfg<DP, DO>;
    constexpr int NSPLIT = DP / DO;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + Cfg::Q_ELEMS;                  // STAGES x K tile
    bf16* sV = sK + Cfg::STAGES * Cfg::K_ELEMS;    // STAGES x V tile

    const int qt = blockIdx.x / NSPLIT, split = blockIdx.x % NSPLIT;
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t head_base = (size_t)b * L * HD + (size_t)h * DP;
    const size_t tile = head_base + (size_t)qt * ATT_BM * HD;
    load_tile<ATT_BM>(sQ, Cfg::SQ, q + tile, HD, DP);
    cp_async_commit();
    attend_tile<DP, DO>(sQ, sK, sV, k + head_base, v + head_base + split * DO, o + tile + split * DO, L, HD);
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
