// The persistent wgmma + TMA product walk shared by K2 (ln_geglu.cu: both
// products) and K5 (attention_block.cu: the Q/K/V and out projections).
//
// A block of GG_THREADS (two consumer warpgroups of 64 rows) owns 128-row x
// BN-column output tiles of A B^T, A (M, K) and B (N, K) both K-major bf16.
// Each stage of a 3-deep ring holds one 64-wide slice of K: A as a 128-row
// TMA box and B as BN rows of boxes, all with the 128-byte swizzle, guarded by
// full/empty mbarriers.  One thread of the second warpgroup (GG_LOADER)
// issues every load; a separate producer warp would cap every thread's
// registers (see attention_packed_wgmma.cuh).  A block needs <= 128 registers
// a thread and <= 112 KB of shared memory, so two blocks share an SM and one's
// epilogue overlaps the other's products.
#pragma once

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace saspa {

constexpr int GG_BM = 128;        // rows a block: two consumer warpgroups of 64
constexpr int GG_THREADS = 256;
constexpr int GG_LOADER = 128;    // thread 0 of the second warpgroup issues every TMA load
constexpr int GG_STAGES = 3;      // ring depth; a stage is 64 deep along K (one 128-byte box row)
constexpr int GG_A_BYTES = GG_BM * 128;

template <int BN>
struct GgCfg {
    static constexpr int STAGE_BYTES = GG_A_BYTES + BN * 128;
    static constexpr size_t SMEM = GG_STAGES * STAGE_BYTES + 1024;  // + 1024-byte alignment
    static_assert(2 * (SMEM + 1024 + 64) <= 233472, "two blocks an SM");
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db) {
    if constexpr (BN == 64) wgmma_ss_n64(d, da, db, 1);
    else if constexpr (BN == 128) wgmma_ss_n128(d, da, db, 1);
    else wgmma_ss_n160(d, da, db, 1);
}

// A persistent block's walk over output tiles t = blockIdx.x, + gridDim.x, ...
// (tile t: N tile t % nt, 128-row block t / nt, so that the blocks working
// at one time share their A rows and B tiles in L2).  For each tile, acc
// (this warpgroup's 64 x BN) = A B^T over nk stages of 64 along K, then
// epi(n, m, acc).  load(n, m, j, a, b, bar), called by GG_LOADER only,
// issues stage j of tile (n, m) (A: 128 rows, B: BN rows) to shared
// addresses a and b, completing on bar.  The ring's loads are numbered
// across the block's tiles, and a stage released is refilled at once with
// the load GG_STAGES further on, so the next tile's first stages land while
// this tile's epilogue runs.  Accumulator layout: wgmma_tma.cuh (warp w of
// the block holds rows 16w .. 16w + 15 of the tile).
template <int BN, class Load, class Epi>
__device__ __forceinline__ void gg_tiles(uint32_t smem, uint64_t* bars, int nk, int nt, int ntiles, Load load,
                                         Epi epi) {
    using Cf = GgCfg<BN>;
    auto full = [&](int s) { return smem_addr(&bars[s]); };
    auto empty = [&](int s) { return smem_addr(&bars[GG_STAGES + s]); };
    const int mine = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // tiles of this block
    auto issue = [&](int n) {  // the block's n-th load: stage j = n % nk of its (n / nk)-th tile
        if (n >= mine * nk) return;
        const int st = n % GG_STAGES, t = blockIdx.x + (n / nk) * gridDim.x;
        if (n >= GG_STAGES) mbar_wait(empty(st), ((n / GG_STAGES) - 1) & 1);
        const uint32_t a = smem + st * Cf::STAGE_BYTES;
        mbar_arrive_expect_tx(full(st), Cf::STAGE_BYTES);
        load(t % nt, t / nt, n % nk, a, a + GG_A_BYTES, full(st));
    };
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    if (threadIdx.x == GG_LOADER) {
        for (int s = 0; s < GG_STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), GG_THREADS / 32);  // lane 0 of each warp
        }
        mbar_fence_init();
        for (int n = 0; n < GG_STAGES; ++n) issue(n);
    }
    __syncthreads();

    // stage `it` is done: release it, and the loader refills it with load
    // it + GG_STAGES once all 8 warps have released it
    auto release = [&](int it) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(it % GG_STAGES));
        if (threadIdx.x == GG_LOADER) issue(it + GG_STAGES);
        __syncwarp();  // the warp reconverges before the next .aligned wgmma
    };
    int it = 0;  // the block's stages consumed so far
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int j = 0; j < nk; ++j, ++it) {
            const int st = it % GG_STAGES;
            const uint32_t a = smem + st * Cf::STAGE_BYTES + wg * 64 * 128, b = smem + st * Cf::STAGE_BYTES + GG_A_BYTES;
            mbar_wait(full(st), (it / GG_STAGES) & 1);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes into the 128-byte row
                wgmma_ss<BN>(acc, sw128_desc(a + kk * 32, 16, 1024), sw128_desc(b + kk * 32, 16, 1024));
            wgmma_commit();
            if (j == 0) continue;
            wgmma_wait<1>();  // stage it - 1's products are done
            fence_regs(acc);
            release(it - 1);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(it - 1);
        epi(t % nt, t / nt, acc);
    }
}

// The 4 x 4 transpose of 32-bit words across the 4 lanes of a quad (lanes
// 4g .. 4g + 3, t = lane % 4): lane t's w[j] becomes lane j's old w[t], in
// two butterfly stages of two shuffles each.  With w[j] the accumulator's
// columns 8(i + j) + 2t, + 1 (i a multiple of 4), lane t then holds the 8
// consecutive columns 8(i + t) .. + 7 of its row, so the epilogue stores
// 16 bytes a thread instead of 4.  Every lane of the warp must call it.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
    const int t = threadIdx.x % 4;
    const bool lo = t < 2, even = t % 2 == 0;
    // lanes t and t ^ 2 swap their off-diagonal 2 x 2 blocks
    uint32_t a = __shfl_xor_sync(0xffffffffu, lo ? w[2] : w[0], 2);
    uint32_t b = __shfl_xor_sync(0xffffffffu, lo ? w[3] : w[1], 2);
    if (lo) { w[2] = a; w[3] = b; } else { w[0] = a; w[1] = b; }
    // lanes t and t ^ 1 transpose each 2 x 2 block
    a = __shfl_xor_sync(0xffffffffu, even ? w[1] : w[0], 1);
    b = __shfl_xor_sync(0xffffffffu, even ? w[3] : w[2], 1);
    if (even) { w[1] = a; w[3] = b; } else { w[0] = a; w[2] = b; }
}

// Blocks of a persistent grid: two an SM (each needs at most half of the
// SM's registers and shared memory), no more than there are tiles.
static int gg_grid(int ntiles) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return ntiles < 2 * sms ? ntiles : 2 * sms;
}

}  // namespace saspa
