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
// Design for the VAE's single 512-wide head (DP = 512): one block of 3
// warpgroups per 64 query rows of one (b, h), grid (L/64, H, B).  The 64 x
// 512 f32 output accumulator is 128 KB of registers, half the SM's file, so
// two consumer warpgroups split its columns (256 each, 128 registers a
// thread), and a third warpgroup computes the scores once per 64-key tile:
// S = Q K^T (m64n64k16 over the 512 dims, Q and K from shared memory), the
// exp2 online softmax of attention_wgmma.cuh, then bf16(P) into shared
// memory in the 128-byte-swizzled layout with each row's rescale factor
// beside it.  The consumers take P as wgmma's shared-memory A operand (O +=
// P V as m64n256k16, V MN-major).  So the scores are computed once a tile,
// not once per output slice (a block per 128-column slice recomputing them
// would do 2.5x the minimal work), and the scores warpgroup runs up to two
// tiles ahead: its Q.K^T and softmax of tile j + 1 overlap the consumers'
// P.V of tile j (P and the factors double-buffered, handed over on named
// barriers).  Shared memory: Q (64 KB), one K and one V tile (64 KB each, 64
// keys), two P tiles (16 KB): 210 KB, one block an SM.  With one stage of
// each, K(j + 1) loads (TMA, issued by the scores warpgroup once its Q.K^T
// of tile j is done) behind the softmax and the consumers' P.V, and V(j + 1)
// (issued by a consumer once both are done with V(j)) behind the next
// Q.K^T.  What bounds it: besides the 2048 tensor-core clocks a tile (1024
// for the scores, 1024 for P.V), every block reads all of K and V from L2,
// 128 KB a tile (8 MB a block at L4096, 4 GB over B8's 512 blocks); 64 query
// rows is the most the output accumulator lets one SM hold, so that traffic
// is the design's floor.  The output warpgroups fit in the 168 registers a
// thread that 3 warpgroups leave (the scores warpgroup needs few), so no
// setmaxnreg.  The epilogue divides by the row sums the scores warpgroup
// hands over and writes bf16 from registers.
#include "attention_packed_wgmma.cuh"

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

// DP = 512: the scores warpgroup (0) and the two output warpgroups (1, 2).
struct D512Cfg {
    static constexpr int DP = 512, BM = 64, BN = 64;
    static constexpr int THREADS = 384;
    static constexpr int ATOMS = DP / 64;      // 64-column TMA boxes per row
    static constexpr int BOX = 64 * 128;       // bytes of one 64-row box (Q, K, V and P alike)
    static constexpr int TILE = ATOMS * BOX;   // Q, one K or one V tile: 64 KB
    static constexpr int V_LOADER = 128;       // the thread that issues the V loads
    static constexpr size_t SMEM = 3 * TILE + 2 * BOX + 3 * BM * sizeof(float) + 1024;  // + factors, sums, alignment
    static_assert(SMEM + 64 <= 232448, "shared memory per block (the barriers are static)");
};

// Named barriers (0 is __syncthreads): P and the factors of buffer b written
// (P_FULL + b) and read (P_EMPTY + b); the row sums written (SUMS); the
// scores warpgroup done with a K tile (SCORES_WG).
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 3, BAR_SUMS = 5, BAR_SCORES_WG = 6;

__global__ void __launch_bounds__(D512Cfg::THREADS, 1)
attention_packed_d512_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int L, int HD) {
    using C = D512Cfg;
    constexpr int BN = C::BN;
    __shared__ __align__(8) uint64_t bars[4];  // Q, K full, V full, V empty
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t sQ = (raw + 1023u) & ~1023u;
    const uint32_t sK = sQ + C::TILE, sV = sK + C::TILE, sP = sV + C::TILE;
    unsigned char* pgen = smem_raw + (sP - raw);                 // P's two buffers, generic address
    float* alpha = reinterpret_cast<float*>(pgen + 2 * C::BOX);  // [2][64] rescale factors
    float* sums = alpha + 2 * C::BM;                             // [64] row sums
    const uint32_t qbar = smem_addr(&bars[0]), kfull = smem_addr(&bars[1]);
    const uint32_t vfull = smem_addr(&bars[2]), vempty = smem_addr(&bars[3]);

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    const int nkv = L / BN;
    const int row0 = b * L;  // this batch row's first row of the (B*L, HD) matrices
    const int col0 = h * C::DP;

    auto load_tile = [&](uint32_t dst, const CUtensorMap* map, int row, uint32_t bar) {
        mbar_arrive_expect_tx(bar, C::TILE);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) tma_load_2d(dst + a * C::BOX, map, col0 + 64 * a, row, bar);
    };
    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        mbar_init(kfull, 1);
        mbar_init(vfull, 1);
        mbar_init(vempty, 8);  // lane 0 of each output warp
        mbar_fence_init();
        load_tile(sQ, &mq, row0 + qt * C::BM, qbar);
        load_tile(sK, &mk, row0, kfull);
        load_tile(sV, &mv, row0, vfull);
    }
    __syncthreads();

    // this thread's rows of the block's 64, in every warpgroup: r0 and r0 + 8
    const int r0 = 16 * (warp % 4) + g;
    if (wg == 0) {
        // ---- scores, softmax, P ---------------------------------------------
        float s[BN / 2];
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
        mbar_wait(qbar, 0);
        for (int j = 0; j < nkv; ++j) {
            mbar_wait(kfull, j & 1);
            wgmma_fence();
            issue_qk<C::DP, BN, C::BOX>(s, sQ, sK);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            named_bar_sync(BAR_SCORES_WG, 128);  // the warpgroup's product has read K(j)
            if (threadIdx.x == 0 && j + 1 < nkv) load_tile(sK, &mk, row0 + (j + 1) * BN, kfull);
            __syncwarp();
            float al0, al1;
            online_softmax<BN>(s, 1.f, m0, m1, l0, l1, al0, al1);  // scores are base 2
            const int buf = j & 1;
            if (j >= 2) named_bar_sync(BAR_P_EMPTY + buf, C::THREADS);  // P.V of tile j - 2 is done
            // bf16(P), 128-byte swizzle: row r's 16-byte chunk i lands at chunk i ^ (r % 8), and r % 8 == g
            unsigned char* p = pgen + buf * C::BOX;
#pragma unroll
            for (int i = 0; i < BN / 8; ++i) {
                const int off = ((i ^ g) << 4) + 4 * t;
                *reinterpret_cast<uint32_t*>(p + r0 * 128 + off) = pack_bf16(s[4 * i], s[4 * i + 1]);
                *reinterpret_cast<uint32_t*>(p + (r0 + 8) * 128 + off) = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
            }
            if (t == 0) {
                alpha[buf * C::BM + r0] = al0;
                alpha[buf * C::BM + r0 + 8] = al1;
            }
            fence_proxy_async();  // P is read by wgmma, in the async proxy
            named_bar_arrive(BAR_P_FULL + buf, C::THREADS);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        if (t == 0) {
            sums[r0] = l0;
            sums[r0 + 8] = l1;
        }
        named_bar_arrive(BAR_SUMS, C::THREADS);
        return;
    }

    // ---- output columns 256 * (wg - 1) .. + 255: O += P V --------------------
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t vb = sV + (wg - 1) * 4 * C::BOX;
    for (int j = 0; j < nkv; ++j) {
        const int buf = j & 1;
        named_bar_sync(BAR_P_FULL + buf, C::THREADS);
        mbar_wait(vfull, j & 1);
        rescale(acc, alpha[buf * C::BM + r0], alpha[buf * C::BM + r0 + 8]);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc)
            wgmma_ss_n256_tb(acc, sw128_desc(sP + buf * C::BOX + kc * 32, 16, 1024),
                             sw128_desc(vb + kc * 16 * 128, C::BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(vempty);  // this warp is done with V(j)
        if (j + 2 < nkv) named_bar_arrive(BAR_P_EMPTY + buf, C::THREADS);
        if (threadIdx.x == C::V_LOADER && j + 1 < nkv) {
            mbar_wait(vempty, j & 1);
            load_tile(sV, &mv, row0 + (j + 1) * BN, vfull);
        }
        __syncwarp();
    }
    named_bar_sync(BAR_SUMS, C::THREADS);
    const float inv0 = 1.f / sums[r0], inv1 = 1.f / sums[r0 + 8];
    bf16* o0 = o + (size_t)(row0 + qt * C::BM + r0) * HD + col0 + (wg - 1) * 256;
    bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const int c = i * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
            __floats2bfloat162_rn(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
}

static cudaError_t launch_d512(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                               cudaStream_t stream) {
    using C = D512Cfg;
    const uint64_t rows = (uint64_t)B * L, cols = (uint64_t)H * C::DP;
    CUtensorMap mq, mk, mv;
    if (!bf16_map_sw128(&mq, q, rows, cols, C::BM) || !bf16_map_sw128(&mk, k, rows, cols, C::BN) ||
        !bf16_map_sw128(&mv, v, rows, cols, C::BN))
        return cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(attention_packed_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(L / C::BM, H, B);
    attention_packed_d512_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, o, L, H * C::DP);
    return cudaGetLastError();
}

}  // namespace saspa

// q, k, v, out: contiguous, 16-byte aligned (B, L, H*dp) bf16 on the device;
// dp in {64, 128, 192} with L % 128 == 0, or dp = 512 with L % 64 == 0.
// Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_packed(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int H, int dp, void* stream) {
    using saspa::bf16;
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || L % (dp == 512 ? 64 : 128) != 0)
        return (int)cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dp == 512) return (int)saspa::launch_d512(qp, kp, vp, op, B, L, H, s);
    return (int)saspa::launch_packed_wgmma<saspa::K1Kernels>(qp, kp, vp, op, B, L, H, dp, s);
}
