// Streamed flash attention over unpadded heads for Hopper (K6).
//
// Replaces saspa_tpu/ops/attention.py::_flash_attention_padded (Pallas kernel
// _flash_kernel, reached through flash_attention).  Computes, for every batch
// row b and head h,
//     out[b, :, h, :] = softmax(bf16(q[b, :, h, :] * scale) k_h^T) v_h
// with q: (B, Lq, H, dc), k, v: (B, Lk, H, dc) and out: (B, Lq, H, dc), all
// contiguous bf16, i.e. the (B, L, H*dc) projections as they leave the
// linear layers; scale arrives rounded to bf16.  As the TPU kernel does: the
// scale is folded into q and rounded to bf16, scores, running max, sum and
// accumulator are f32, the softmax is base e (computed as exp2(s*log2(e) -
// m*log2(e)), the same function), P is rounded to bf16 before the P.V
// product, and the output is bf16.
//
// What bounds it on an H100: the exponentials.  At its main-path site (SD1.5
// at 1024^2, level 0: L = 16384, 8 heads of dc = 40) each score needs 176
// tensor-core flops here (k = 48 for Q.K^T, n = 40 for P.V) and one exp2 on
// the special-function unit, which returns 16 results a clock per SM: at B16
// the 3.4e10 scores take >= 8.2 ms of exp2 at 1.98 GHz against ~6.1 ms of
// bf16 tensor-core work at its 989 TFLOP/s peak.  So the design keeps the
// exp unit fed and lets the wgmmas run behind it.
//
// Design (K1's wgmma/TMA core, attention_packed.cu, on unpadded heads): one
// block per 64*WGS query rows of one (b, h), grid (Lq/(64*WGS), H, B), WGS
// warpgroups of 64 rows each.
// - Loads by TMA, padded by the copy engine: q, k and v are rank-3 tensor
//   maps (dc, H, B*L) with 64-column boxes of one head and the 128-byte
//   swizzle.  Columns dc..63 of a box lie past the head's last column: TMA
//   reads only the dc real columns from HBM and writes zeros for the rest, so
//   no pass in shared memory pads the heads and no neighbouring head is read.
//   dc 80 and 160 take 2 and 3 boxes.  One thread of the last warpgroup fills
//   a 3-stage ring of K/V tiles guarded by full/empty mbarriers.
// - The scale fold stays exact: bf16(q * bf16(scale)) is not a rescaling of
//   the scores, so each block rewrites its Q tile once in shared memory, then
//   fences the generic-proxy writes for wgmma's async-proxy reads.
// - Trimmed widths for dc <= 40 (SD1.5's 40): Q.K^T over 48 columns (3 k-steps
//   of 16, the 8 zero columns included) and P.V at n = 40 (m64n40k16); other
//   dc run both at their padded width 64/128/192.
// - exp2 is one MUFU instruction after one FFMA that folds log2(e) and the row
//   max; O is rescaled only where a row max moved.
// - What hides a warpgroup's softmax is the other warpgroups' wgmmas, so the
//   warpgroups take turns to issue Q.K^T (a ring of named barriers), which
//   staggers their softmaxes; k6_probe.py's no_turns variant measures what
//   the turns save.  FA3's intra-warpgroup pipeline (S(j+1) in flight
//   during the softmax of tile j) was slower here: at 128-key tiles its extra
//   64-register S spills at the 128-register cap of 4 warpgroups, and at
//   64-key tiles each tile's fixed costs double.
// - Block shape: 4 warpgroups (256 rows) where Lq % 256 == 0 (2 at DP = 192,
//   whose 96-register O leaves no room for 4), else 2 or 1; 128-key tiles at
//   DP = 64 where Lk % 128 == 0, else 64.  Shared memory at dc = 40: Q 32 KB +
//   3 x 2 x 16 KB of K/V.
#include "attention_wgmma.cuh"

namespace saspa {

constexpr float LOG2E_F = 1.4426950408889634f;

// TRIM: dc <= 40 (Q.K^T over 48 columns, P.V over 40); else DP for both.
template <int DP, bool TRIM, int BN, int WGS>
struct FlashCfg {
    static constexpr int KQ = TRIM ? 48 : DP;               // depth of Q.K^T
    static constexpr int NO = TRIM ? 40 : DP;               // output columns of P.V
    static constexpr bool RING = WGS > 1;                   // warpgroups take turns to issue Q.K^T
    static constexpr int BM = 64 * WGS;                     // query rows per block
    static constexpr int THREADS = 128 * WGS;
    static constexpr int LOADER = 128 * (WGS - 1);          // the thread that issues the TMA loads
    static constexpr int ATOMS = DP / 64;                   // 64-column TMA boxes per row
    static constexpr int Q_BOX = BM * 128;                  // bytes of one BM-row box
    static constexpr int KV_BOX = BN * 128;                 // bytes of one BN-row box
    static constexpr int Q_BYTES = ATOMS * Q_BOX;
    static constexpr int TILE_BYTES = ATOMS * KV_BOX;       // one K or one V tile
    static constexpr int STAGES = 3;                        // K/V ring depth
    static constexpr size_t SMEM = Q_BYTES + STAGES * 2 * TILE_BYTES + 1024;  // + 1024-byte alignment
    static_assert(SMEM + 128 <= 232448, "shared memory per block (the barriers are static)");
};

// Two bf16 times a bf16 scale, rounded to bf16 (the product is exact in f32).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
    return pack_bf16(f.x * s, f.y * s);
}

template <int DP, bool TRIM, int BN, int WGS>
__global__ void __launch_bounds__(FlashCfg<DP, TRIM, BN, WGS>::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int Lq, int Lk, int H,
                       int dc, float scale) {
    using C = FlashCfg<DP, TRIM, BN, WGS>;
    constexpr int STAGES = C::STAGES;
    __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // Q, full[STAGES], empty[STAGES]
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t base = smem_addr(smem_raw);
    const uint32_t sQ = (base + 1023u) & ~1023u;
    const uint32_t sK = sQ + C::Q_BYTES, sV = sK + STAGES * C::TILE_BYTES;
    uint4* q_tile = reinterpret_cast<uint4*>(smem_raw + (sQ - base));  // Q's boxes, for the scale fold
    const uint32_t qbar = smem_addr(&bars[0]);
    auto full = [&](int s) { return smem_addr(&bars[1 + s]); };
    auto empty = [&](int s) { return smem_addr(&bars[1 + STAGES + s]); };

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nkv = Lk / BN;
    const int krow0 = b * Lk;  // this batch row's first row of the (B*Lk, H, dc) k and v

    // One thread (LOADER) issues every TMA load: tile j into stage j % STAGES.
    auto load_kv = [&](int j) {
        const int st = j % STAGES;
        mbar_arrive_expect_tx(full(st), 2 * C::TILE_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
            const uint32_t off = st * C::TILE_BYTES + a * C::KV_BOX;
            tma_load_3d(sK + off, &mk, 64 * a, h, krow0 + j * BN, full(st));
            tma_load_3d(sV + off, &mv, 64 * a, h, krow0 + j * BN, full(st));
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
        for (int a = 0; a < C::ATOMS; ++a) tma_load_3d(sQ + a * C::Q_BOX, &mq, 64 * a, h, b * Lq + qt * C::BM, qbar);
        for (int j = 0; j < STAGES && j < nkv; ++j) load_kv(j);
    }
    __syncthreads();

    // bf16(q * scale), as the TPU path's (q * scale).astype(q.dtype); the zero
    // columns stay zero.  The proxy fence and the barrier make the rewrite
    // visible to every warpgroup's wgmmas.
    mbar_wait(qbar, 0);
    for (int i = threadIdx.x; i < C::Q_BYTES / 16; i += C::THREADS) {
        uint4 u = q_tile[i];
        u.x = scale_bf16x2(u.x, scale);
        u.y = scale_bf16x2(u.y, scale);
        u.z = scale_bf16x2(u.z, scale);
        u.w = scale_bf16x2(u.w, scale);
        q_tile[i] = u;
    }
    fence_proxy_async();
    __syncthreads();

    // warpgroup wg owns query rows wg*64 .. wg*64+63 of the block
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const uint32_t qa = sQ + wg * 64 * 128;
    float oacc[C::NO / 2];
#pragma unroll
    for (int i = 0; i < C::NO / 2; ++i) oacc[i] = 0.f;
    float sacc[BN / 2];
    uint32_t pa[BN / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of the warp's 16

    // The loader refills the stage released at step j - 1 with tile j - 1 +
    // STAGES, once every warp has released it.  It sits in the last
    // warpgroup: that wait holds its warpgroup back until it trails the
    // others, after which the stage is found released.
    auto refill = [&](int j) {
        const int r = j - 1 + STAGES;
        if (threadIdx.x == C::LOADER && j >= 1 && r < nkv) {
            mbar_wait(empty(r % STAGES), ((r / STAGES) - 1) & 1);
            load_kv(r);
        }
        __syncwarp();
    };
    auto release = [&](int st) {  // this warp is done with the stage's K and V
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
    };

    // Turns: the warpgroups issue their Q.K^T one after another in a ring
    // (named barrier 1 + wg is warpgroup wg's turn), so their softmaxes start
    // staggered and the exp units work while the tensor cores run the other
    // warpgroups' products.  Warpgroup WGS - 1 hands warpgroup 0 its first
    // turn; warpgroup 0 takes the last hand-over after the loop.
    if constexpr (C::RING) {
        if (wg == WGS - 1) named_bar_arrive(1, 256);
    }
    for (int j = 0; j < nkv; ++j) {
        const int st = j % STAGES;
        refill(j);
        mbar_wait(full(st), (j / STAGES) & 1);
        if constexpr (C::RING) named_bar_sync(1 + wg, 256);
        wgmma_fence();
        issue_qk<C::KQ, BN, C::Q_BOX>(sacc, qa, sK + st * C::TILE_BYTES);
        wgmma_commit();
        if constexpr (C::RING) named_bar_arrive(1 + (wg + 1) % WGS, 256);
        wgmma_wait<0>();
        fence_regs(sacc);
        float al0, al1;
        online_softmax<BN>(sacc, LOG2E_F, m0, m1, l0, l1, al0, al1);
        rescale(oacc, al0, al1);
        pack_p<BN>(pa, sacc);
        fence_regs(oacc);
        wgmma_fence();
        issue_pv<C::NO, BN>(oacc, pa, sV + st * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_p<BN>(pa);
        release(st);
    }
    if constexpr (C::RING) {
        if (wg == 0) named_bar_sync(1, 256);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const size_t ld = (size_t)H * dc;
    const int row = qt * C::BM + wg * 64 + (warp % 4) * 16 + g;
    bf16* o0 = o + ((size_t)b * Lq + row) * ld + (size_t)h * dc;
    bf16* o1 = o0 + 8 * ld;
#pragma unroll
    for (int i = 0; i < C::NO / 8; ++i) {
        const int c = i * 8 + 2 * t;
        if (i * 8 >= dc) continue;  // dc % 8 == 0: whole 8-column groups
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(oacc[4 * i] / l0, oacc[4 * i + 1] / l0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(oacc[4 * i + 2] / l1, oacc[4 * i + 3] / l1);
    }
}

template <int DP, bool TRIM, int BN, int WGS>
static cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Lq, int Lk, int H,
                          int dc, float scale, cudaStream_t stream) {
    using C = FlashCfg<DP, TRIM, BN, WGS>;
    CUtensorMap mq, mk, mv;
    if (!bf16_map3_sw128(&mq, q, (uint64_t)B * Lq, H, dc, C::BM) ||
        !bf16_map3_sw128(&mk, k, (uint64_t)B * Lk, H, dc, BN) || !bf16_map3_sw128(&mv, v, (uint64_t)B * Lk, H, dc, BN))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP, TRIM, BN, WGS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(Lq / C::BM, H, B);
    flash_attention_kernel<DP, TRIM, BN, WGS><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, o, Lq, Lk, H, dc,
                                                                                     scale);
    return cudaGetLastError();
}

// The block: 4 warpgroups where Lq % 256 == 0 (at most 2 at DP = 192), else 2 or 1.
template <int DP, bool TRIM, int BN>
static cudaError_t launch_rows(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Lq, int Lk, int H,
                               int dc, float scale, cudaStream_t s) {
    if constexpr (DP != 192) {
        if (Lq % 256 == 0) return launch<DP, TRIM, BN, 4>(q, k, v, o, B, Lq, Lk, H, dc, scale, s);
    }
    if (Lq % 128 == 0) return launch<DP, TRIM, BN, 2>(q, k, v, o, B, Lq, Lk, H, dc, scale, s);
    return launch<DP, TRIM, BN, 1>(q, k, v, o, B, Lq, Lk, H, dc, scale, s);
}

// The K/V tile: 128 keys at DP = 64 where Lk % 128 == 0, else 64.
template <int DP, bool TRIM>
static cudaError_t launch_keys(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Lq, int Lk, int H,
                               int dc, float scale, cudaStream_t s) {
    if constexpr (DP == 64) {
        if (Lk % 128 == 0) return launch_rows<DP, TRIM, 128>(q, k, v, o, B, Lq, Lk, H, dc, scale, s);
    }
    return launch_rows<DP, TRIM, 64>(q, k, v, o, B, Lq, Lk, H, dc, scale, s);
}

}  // namespace saspa

// q, out: contiguous (B, Lq, H, dc) bf16; k, v: contiguous (B, Lk, H, dc)
// bf16, all 16-byte aligned; Lq % 64 == Lk % 64 == 0; dc % 8 == 0 with
// dc <= dp, dp in {64, 128, 192} the padded head dim.  scale: the softmax
// scale, already rounded to bf16.  Returns a cudaError_t (0 on success).
extern "C" int saspa_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
                                     int H, int dc, int dp, float scale, void* stream) {
    using saspa::bf16;
    if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || Lq <= 0 || Lk <= 0 || Lq % 64 || Lk % 64 || dc <= 0 ||
        dc % 8 || dc > dp)
        return (int)cudaErrorInvalidValue;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dp) {
        case 64: return dc <= 40 ? (int)saspa::launch_keys<64, true>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s)
                                 : (int)saspa::launch_keys<64, false>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        case 128: return (int)saspa::launch_keys<128, false>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        case 192: return (int)saspa::launch_keys<192, false>(qp, kp, vp, op, B, Lq, Lk, H, dc, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
