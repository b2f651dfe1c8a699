// K1's wgmma attention block for head dims 64/128/192, shared by K1
// (attention_packed.cu) and K5's attention phase (attention_block.cu): each
// .cu builds its own library, so each instantiates it.  Design: the head
// comment of attention_packed.cu.
#pragma once

#include "attention_wgmma.cuh"

namespace saspa {

// WGS warpgroups of 64 query rows each (4 or 2, see attention_packed.cu).
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

// The block's body: a __global__ of each library that runs it (K1's
// attention_packed_wgmma_kernel, K5's attention_block_attend_kernel) passes
// its __grid_constant__ tensor maps by reference, so the profiler tells the
// two apart.
template <int DP, int WGS>
__device__ __forceinline__ void packed_attention_wgmma(const CUtensorMap& mq, const CUtensorMap& mk,
                                                       const CUtensorMap& mv, bf16* __restrict__ o, int L, int HD) {
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

typedef void (*PackedWgmmaKernel)(CUtensorMap, CUtensorMap, CUtensorMap, bf16*, int, int);

template <int DP, int WGS>
static cudaError_t launch_wgmma(PackedWgmmaKernel kernel, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                int B, int L, int H, cudaStream_t stream) {
    using C = WgCfg<DP, WGS>;
    const uint64_t rows = (uint64_t)B * L, cols = (uint64_t)H * DP;
    CUtensorMap mq, mk, mv;
    if (!bf16_map_sw128(&mq, q, rows, cols, C::BM) || !bf16_map_sw128(&mk, k, rows, cols, C::BN) ||
        !bf16_map_sw128(&mv, v, rows, cols, C::BN))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(L / C::BM, H, B);
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, o, L, H * DP);
    return cudaGetLastError();
}

// The launch for head dims 64/128/192 (L % 128 == 0): 4 warpgroups where
// L % 256 == 0 at DP 64 and 128, else 2.  Kernels::get<DP, WGS>() names the
// library's __global__ that runs packed_attention_wgmma<DP, WGS>.
template <class Kernels>
static cudaError_t launch_packed_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                                       int dp, cudaStream_t s) {
    if (L % 128) return cudaErrorInvalidValue;
    switch (dp) {
        case 64: return L % 256 == 0 ? launch_wgmma<64, 4>(Kernels::template get<64, 4>(), q, k, v, o, B, L, H, s)
                                     : launch_wgmma<64, 2>(Kernels::template get<64, 2>(), q, k, v, o, B, L, H, s);
        case 128: return L % 256 == 0 ? launch_wgmma<128, 4>(Kernels::template get<128, 4>(), q, k, v, o, B, L, H, s)
                                      : launch_wgmma<128, 2>(Kernels::template get<128, 2>(), q, k, v, o, B, L, H, s);
        case 192: return launch_wgmma<192, 2>(Kernels::template get<192, 2>(), q, k, v, o, B, L, H, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace saspa
