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
// (products, softmax, repacking) is attention_wgmma.cuh, shared with K6.
//
// The VAE's single 512-wide head (DP = 512) keeps the mma.sync tile loop of
// attention_tile.cuh: a 64 x 512 f32 accumulator does not fit one warpgroup's
// registers, so each block owns a 128-column slice of the output and
// recomputes the scores for its slice.
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace saspa {

// WGS warpgroups of 64 query rows each (4 or 2, see the head comment).
template <int DP, int WGS>
struct WgCfg {
    static constexpr int BM = 64 * WGS;                     // query rows per block
    static constexpr int THREADS = 128 * WGS;
    static constexpr int LOADER = 128 * (WGS - 1);          // the thread that issues the TMA loads
    static constexpr int BN = DP == 64 ? 128 : 64;          // keys per K/V tile
    static constexpr int ATOMS = DP / 64;                   // 64-column TMA boxes per row
    static constexpr int Q_BOX = BM * 128;                  // bytes of one BM-row box
    static constexpr int KV_BOX = BN * 128;                 // bytes of one BN-row box
    static constexpr int Q_BYTES = ATOMS * Q_BOX;
    static constexpr int TILE_BYTES = ATOMS * KV_BOX;       // one K or one V tile
    static constexpr int STAGES = 3;                        // K/V ring depth
    static constexpr size_t SMEM = Q_BYTES + STAGES * 2 * TILE_BYTES + 1024;  // + 1024-byte alignment
    static_assert(SMEM + 128 <= 232448, "shared memory per block (the barriers are static)");
};

template <int DP, int WGS>
__global__ void __launch_bounds__(WgCfg<DP, WGS>::THREADS, 1)
attention_packed_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int L, int HD) {
    using C = WgCfg<DP, WGS>;
    constexpr int BN = C::BN, STAGES = C::STAGES;
    __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // Q, full[STAGES], empty[STAGES]
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t sK = sQ + C::Q_BYTES, sV = sK + STAGES * C::TILE_BYTES;
    const uint32_t qbar = smem_addr(&bars[0]);
    auto full = [&](int s) { return smem_addr(&bars[1 + s]); };
    auto empty = [&](int s) { return smem_addr(&bars[1 + STAGES + s]); };

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nkv = L / BN;
    const int row0 = b * L;  // this batch row's first row of the (B*L, HD) matrices

    // One thread (LOADER) issues every TMA load: tile j into stage j % STAGES.
    auto load_kv = [&](int j) {
        const int st = j % STAGES;
        mbar_arrive_expect_tx(full(st), 2 * C::TILE_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
            const uint32_t off = st * C::TILE_BYTES + a * C::KV_BOX;
            tma_load_2d(sK + off, &mk, h * DP + 64 * a, row0 + j * BN, full(st));
            tma_load_2d(sV + off, &mv, h * DP + 64 * a, row0 + j * BN, full(st));
        }
    };
    if (threadIdx.x == C::LOADER) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 4 * WGS);  // lane 0 of each warp
        }
        mbar_fence_init();
        mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
            tma_load_2d(sQ + a * C::Q_BOX, &mq, h * DP + 64 * a, row0 + qt * C::BM, qbar);
        for (int j = 0; j < STAGES && j < nkv; ++j) load_kv(j);
    }
    __syncthreads();

    // warpgroup wg owns query rows wg*64 .. wg*64+63 of the block
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const uint32_t qa = sQ + wg * 64 * 128;
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float sacc[BN / 2];
    uint32_t pa[BN / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of the warp's 16
    mbar_wait(qbar, 0);

    for (int j = 0; j < nkv; ++j) {
        const int st = j % STAGES;
        // The loader refills the stage released at step j - 1 with tile
        // j - 1 + STAGES, once every warp has released it.  It sits in the
        // last warpgroup: that wait holds its warpgroup back until it trails
        // the others, after which the stage is found released.
        const int r = j - 1 + STAGES;
        if (threadIdx.x == C::LOADER && j >= 1 && r < nkv) {
            mbar_wait(empty(r % STAGES), ((r / STAGES) - 1) & 1);
            load_kv(r);
        }
        __syncwarp();
        mbar_wait(full(st), (j / STAGES) & 1);

        wgmma_fence();
        issue_qk<DP, BN, C::Q_BOX>(sacc, qa, sK + st * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        float al0, al1;
        online_softmax<BN>(sacc, 1.f, m0, m1, l0, l1, al0, al1);  // scores are base 2
        rescale(oacc, al0, al1);
        pack_p<BN>(pa, sacc);
        fence_regs(oacc);
        wgmma_fence();
        issue_pv<DP, BN>(oacc, pa, sV + st * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_p<BN>(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage's K and V
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int row = qt * C::BM + wg * 64 + (warp % 4) * 16 + g;
    bf16* o0 = o + (size_t)(row0 + row) * HD + h * DP;
    bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
        const int c = i * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(oacc[4 * i] / l0, oacc[4 * i + 1] / l0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(oacc[4 * i + 2] / l1, oacc[4 * i + 3] / l1);
    }
}

template <int DP, int WGS>
static cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                                cudaStream_t stream) {
    using C = WgCfg<DP, WGS>;
    const uint64_t rows = (uint64_t)B * L, cols = (uint64_t)H * DP;
    CUtensorMap mq, mk, mv;
    if (!bf16_map_sw128(&mq, q, rows, cols, C::BM) || !bf16_map_sw128(&mk, k, rows, cols, C::BN) ||
        !bf16_map_sw128(&mv, v, rows, cols, C::BN))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_packed_wgmma_kernel<DP, WGS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(L / C::BM, H, B);
    attention_packed_wgmma_kernel<DP, WGS><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, o, L, H * DP);
    return cudaGetLastError();
}

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
    switch (dp) {
        case 64: return L % 256 == 0 ? (int)saspa::launch_wgmma<64, 4>(qp, kp, vp, op, B, L, H, s)
                                     : (int)saspa::launch_wgmma<64, 2>(qp, kp, vp, op, B, L, H, s);
        case 128: return L % 256 == 0 ? (int)saspa::launch_wgmma<128, 4>(qp, kp, vp, op, B, L, H, s)
                                      : (int)saspa::launch_wgmma<128, 2>(qp, kp, vp, op, B, L, H, s);
        case 192: return (int)saspa::launch_wgmma<192, 2>(qp, kp, vp, op, B, L, H, s);
        case 512: return (int)saspa::launch_vae(qp, kp, vp, op, B, L, H, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
