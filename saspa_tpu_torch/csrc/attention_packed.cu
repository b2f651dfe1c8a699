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
// What bounds it on an H100: operations.  The work is 4*B*H*L^2*DP flops
// against 8*B*H*L*DP bytes, i.e. L/2 flops per byte (128-2048 at the UNet's
// L = 256..4096), above the card's ~295 bf16 flops per byte of HBM: the
// tensor cores' bf16 rate bounds it.  The TPU kernel kept all of K/V for one
// row resident in VMEM; 4096 keys x DP do not fit in 227 KB of shared memory,
// so this kernel streams K/V tiles with an online (running max/sum) softmax.
//
// Design for head dims 64/128/192 (the UNet's 40/80/160, zero-padded): one
// block per 64*WGS query rows of one (b, h), grid (L/(64*WGS), H, B), WGS
// warpgroups of 64 rows each.  Only wgmma reaches the card's bf16 rate, so
// both products run on it: S = Q K^T as m64n{BN}k16 with Q and K read from
// shared memory (K-major), and O += P V as m64n{DP}k16 with bf16(P) in
// registers (repacked from S's accumulator) and V from shared memory
// (MN-major).  One thread issues TMA loads into a ring of K/V stages guarded
// by full/empty mbarriers (Q is loaded once by the same route), so no other
// thread spends an instruction on a load, and every K/V tile is read once
// per block from L2 and once per warpgroup from shared memory.  The softmax
// is exp2 in one MUFU instruction, and O is rescaled only where a row's max
// moved.  What hides a warpgroup's softmax is the other warpgroups' wgmmas
// on the same SM, so the block is as wide as registers allow: a warpgroup
// holds O (DP/2 f32), S (BN/2 f32) and P (BN/4), and the SM's 4
// sub-partitions each hold 16K registers, so 4 warpgroups (256 rows, 128
// registers a thread) fit at DP 64 (128-key tiles) and DP 128 (64-key tiles)
// where L % 256 == 0; DP 192 (64-key tiles, 154 registers) and other L run
// 2 warpgroups.  A separate producer warp would put 3 warps on one
// sub-partition and cap every thread at 168 registers, which spills at
// DP 128/192; so a consumer thread in the last warpgroup loads instead.
// The epilogue divides by the row sum and writes bf16 from registers.
// Tiles use the 128-byte swizzle (wgmma_tma.cuh); the per-tile step
// (products, softmax, repacking) is attention_wgmma.cuh, shared with K6, and
// the block itself is attention_packed_wgmma.cuh, which K5's attention phase
// runs too.
//
// The VAE's single 512-wide head (DP = 512) keeps the mma.sync tile loop of
// attention_tile.cuh: a 64 x 512 f32 accumulator does not fit one warpgroup's
// registers, so each block owns a 128-column slice of the output and
// recomputes the scores for its slice.
#include "attention_packed_wgmma.cuh"
#include "attention_tile.cuh"

namespace saspa {

// K1's __global__ for packed_attention_wgmma (attention_packed_wgmma.cuh).
template <int DP, int WGS>
__global__ void __launch_bounds__(WgCfg<DP, WGS>::THREADS, 1)
attention_packed_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int L, int HD) {
    packed_attention_wgmma<DP, WGS>(mq, mk, mv, o, L, HD);
}

struct K1Kernels {
    template <int DP, int WGS>
    static PackedWgmmaKernel get() { return attention_packed_wgmma_kernel<DP, WGS>; }
};

// DP = 512: the mma.sync tile loop, one 128-column output slice per block.
__global__ void __launch_bounds__(ATT_THREADS)
attention_packed_vae_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                            bf16* __restrict__ o, int L, int HD) {
    constexpr int DP = 512, DO = 128;
    using Cfg = AttnCfg<DP, DO>;
    constexpr int NSPLIT = DP / DO;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + Cfg::Q_ELEMS;
    bf16* sV = sK + Cfg::STAGES * Cfg::K_ELEMS;

    const int qt = blockIdx.x / NSPLIT, split = blockIdx.x % NSPLIT;
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t head_base = (size_t)b * L * HD + (size_t)h * DP;
    const size_t tile = head_base + (size_t)qt * ATT_BM * HD;
    load_tile<ATT_BM>(sQ, Cfg::SQ, q + tile, HD, DP);
    cp_async_commit();
    attend_tile<DP, DO>(sQ, sK, sV, k + head_base, v + head_base + split * DO, o + tile + split * DO, L, HD);
}

static cudaError_t launch_vae(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                              cudaStream_t stream) {
    const size_t smem = AttnCfg<512, 128>::SMEM;
    cudaError_t err =
        cudaFuncSetAttribute(attention_packed_vae_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((L / ATT_BM) * 4, H, B);
    attention_packed_vae_kernel<<<grid, ATT_THREADS, smem, stream>>>(q, k, v, o, L, H * 512);
    return cudaGetLastError();
}

}  // namespace saspa

// q, k, v, out: contiguous, 16-byte aligned (B, L, H*dp) bf16 on the device;
// dp in {64, 128, 192} with L % 128 == 0, or dp = 512 with L % 64 == 0.
// Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_packed(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int H, int dp, void* stream) {
    using saspa::bf16;
    if (B <= 0 || H <= 0 || L <= 0 || L % (dp == 512 ? 64 : 128) != 0)
        return (int)cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dp == 512) return (int)saspa::launch_vae(qp, kp, vp, op, B, L, H, s);
    return (int)saspa::launch_packed_wgmma<saspa::K1Kernels>(qp, kp, vp, op, B, L, H, dp, s);
}
