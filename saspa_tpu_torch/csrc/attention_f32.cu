// Self-attention in f32 on the CUDA cores for Hopper: K1's f32 variant at
// the UNet's heads and K6's f32 variant, one core; and K5's f32 variant, the
// whole self-attention block around that core.
//
// Replaces, on f32 activations (a pipeline built with dtype=float32):
//   saspa_tpu/ops/attention.py::flash_attention_packed (Pallas kernel
//     _packed_kernel) at d_pad 64/128/192: packed (B, L, H*d_pad) q, k, v,
//     q pre-scaled by softmax_scale*log2(e) in f32, softmax in base 2
//     (entry saspa_attention_f32_packed; the caller names the real head dim
//     d <= d_pad, and the columns d .. d_pad of q, k and v are zero);
//   saspa_tpu/ops/attention.py::_flash_attention_padded (Pallas kernel
//     _flash_kernel, via flash_attention) on (B, L, H, d) q, k, v at the
//     real head dim d (a multiple of 8 up to 192), q * scale folded in f32,
//     softmax in base e with a running max and sum
//     (entry saspa_flash_attention_f32);
//   saspa_tpu/ops/attention.py::attention_block_fused (Pallas kernel
//     _block_kernel, under SASPA_ATTN_MEGAKERNEL=1) on an f32 block
//     (entry saspa_attention_block_f32): Q, K, V = x_ln wq_scaled^T,
//     x_ln wk^T, x_ln wv^T; the packed heads = the K1 entry's attention on
//     them; out = packed wo^T + bo + residual; all f32, nothing rounded.
//     Three kernels behind the entry, as K5 in bf16 runs (attention_block.cu):
//     the Q/K/V product (attention_block_f32_qkv_kernel), this core at exp2
//     on Q, K, V, and the out product (attention_block_f32_out_kernel), whose
//     epilogue adds bo and the residual; Q, K, V and the packed heads
//     round-trip device memory in f32 (a workspace of 4 * B*L*H*D_PAD
//     floats).  The products are gemm_f32.cuh's register-tiled FFMA tiles
//     (64 columns: SD2.1's H*D_PAD = 320 needs no other tile, and no tile
//     straddles two projections).  What bounds it: operations, the
//     attention's 4*B*H*L^2*d flops against the four projections'
//     8*B*L*C*H*d (about 89% and 11% at SD1.5's level 0).
// For every batch row b and head h: out = softmax(q_h k_h^T) v_h, with the
// scores, probabilities, the running max and sum, the P.V product and the
// output all f32, as the TPU kernels compute an f32 block (P cast to v's
// dtype is f32 there).
//
// What bounds it on an H100: operations.  The work is 4*B*H*Lq*Lk*d flops
// against 4*B*H*(2*Lq + 2*Lk)*d bytes; in f32 outside the tensor cores the
// card does 67 TFLOP/s.  TF32 tensor cores would be faster but round q, k, P
// and v to 10 mantissa bits, other numerics than the TPU kernels' f32: this
// core is FFMA on the CUDA cores, and what the design has to do is keep the
// FFMA pipes issuing: no work on padded columns, few shared-memory loads an
// FFMA, few block barriers, copies behind the arithmetic.  The shared-memory
// pipe binds before the FFMA pipes do: a warp's 16-byte load is four
// wavefronts of one a clock an SM, against four FFMA instructions a clock,
// so register tiles of 4 x 8 (10.7 FFMAs a load) leave the score product at
// most two thirds of the FFMA rate, and any bank conflict costs twice.
//
// Design.  The core is instantiated at computed widths D = 40, 64, 80, 128,
// 160, 192: the real head dims of the f32 UNets (SD1.5's 40, 80, 160; SD2.1's
// and SDXL's 64) and the padded widths; a head of d runs at the least D >= d,
// its columns d .. D zeroed once in shared memory (d 120 at 128, say), so the
// UNet's heads compute no padded column.  A block takes 64 query rows of one
// (b, h), grid (Lq/64, H, B); its warps own RW of those rows each (16 at D <=
// 80: 4 warps; 8 above: 8 warps) for the whole run, and a lane owns 4 of its
// warp's rows in both products (rows rg + RG*i, RG = RW/4 row groups):
//   S = Q K^T: the row group's KS = 32/RG lanes split the tile's 64 keys
//     (keys kg + KS*e); each step over 4 dims reads 4 float4 of q and 64/KS
//     of k: 4 x 8 scores, 10.7 FFMAs a 16-byte load at RW 16 (4 x 4, 8, at
//     RW 8).  The scores stay in registers: each row's max is three (four)
//     shuffles among the lanes that share it, its sum a lane's partial,
//     added across them once at the end.
//   P goes to the warp's own slice of shared memory behind one __syncwarp.
//   O += P V: the KS lanes split CG column groups (16-byte chunks cg + CG*j,
//     NCH a lane) times KG = KS/CG key groups (key quads kgp + KG*t); each
//     quad reads 4 float4 of P and 4*NCH of V for 64*NCH FFMAs (10.7 at
//     NCH 2, 13.3 at 5), and the key groups' partial sums are added by
//     shuffles once, at the end.  D 40: CG 2, KG 4, NCH 5; D 80: 4, 2, 5;
//     D 64: 8, 1, 2; D 128: 8, 2, 4; D 160: 8, 2, 5; D 192: 16, 1, 3.  At
//     D 40 the key groups take single keys (kgp + 4u) from unpadded V rows
//     (10 quads: the 4 groups' rows in distinct bank quads; quads of keys
//     put two groups in one), and P is stored by key group.
// K and V stream through shared memory by cp.async, each tile issued a whole
// tile ahead: as (K, V) pairs, double-buffered, behind one block barrier a
// tile (D 40, 64, 128, 160), or where that would not leave two blocks an SM
// (D 80) or does not fit (D 192) through a 3-slot ring K(j), V(j), K(j + 1),
// ... behind two (one where K(j) lands, one where V(j) does).  Rows are
// padded by 4 floats, so the keys a warp reads sit in distinct bank quads.
// Shared memory: Q (64 rows), 4 or 3 K/V slots of 64 rows, and P (64 x 72,
// or x 80 at RW 8 and D 40): 73 / 103 / 102 / 185 / 225 / 216 KB at D 40 / 64 / 80 /
// 128 / 160 / 192, so 3, 2 and 2 blocks an SM at D 40, 64 and 80 (12, 8
// and 8 warps; registers sized for them by __launch_bounds__), one block of
// 8 warps above.
#include "gemm_f32.cuh"
#include "mma_bf16.cuh"

#include <math.h>

namespace saspa {

constexpr int AF_BM = 64;  // query rows a block
constexpr int AF_BN = 64;  // keys a K/V tile

// The core's shape at computed width D (see the note above): RW query rows a
// warp, CG column groups of the P.V lanes, MINB blocks an SM the registers
// are sized for, PAIR: (K, V) pairs double-buffered (else the 3-slot ring),
// SU / PU: the unrolling of the two products' loops (over 4 dims, over key
// quads); at D 40 the third block an SM leaves 168 registers, which an
// unrolled score loop would spill.  KEY1: the P.V key groups take single
// keys (kgp + KG*u) instead of quads, P is stored by key group and V
// unpadded: at D 40 the quads' V rows would put two of a quarter-warp's 8
// chunks in one bank quad (every V load twice the wavefronts).
template <int D>
struct AfCfg;
template <>
struct AfCfg<40> {
    static constexpr int RW = 16, CG = 2, MINB = 3, SU = 1, PU = 2;
    static constexpr bool PAIR = true, KEY1 = true;
};
template <>
struct AfCfg<64> {
    static constexpr int RW = 16, CG = 8, MINB = 2, SU = 4, PU = 4;
    static constexpr bool PAIR = true, KEY1 = false;
};
template <>
struct AfCfg<80> {
    static constexpr int RW = 16, CG = 4, MINB = 2, SU = 4, PU = 4;
    static constexpr bool PAIR = false, KEY1 = false;
};
template <>
struct AfCfg<128> {
    static constexpr int RW = 8, CG = 8, MINB = 1, SU = 4, PU = 4;
    static constexpr bool PAIR = true, KEY1 = false;
};
template <>
struct AfCfg<160> {
    static constexpr int RW = 8, CG = 8, MINB = 1, SU = 4, PU = 4;
    static constexpr bool PAIR = true, KEY1 = false;
};
template <>
struct AfCfg<192> {
    static constexpr int RW = 8, CG = 16, MINB = 1, SU = 4, PU = 4;
    static constexpr bool PAIR = false, KEY1 = false;
};

template <int D>
struct AfShape {
    static constexpr int RW = AfCfg<D>::RW, NW = AF_BM / RW, THREADS = 32 * NW;
    static constexpr int RG = RW / 4, KS = 32 / RG, NE = AF_BN / KS;  // row groups, lanes a row group, keys a lane
    static constexpr int CG = AfCfg<D>::CG, KG = KS / CG, NCH = D / 4 / CG;
    static constexpr bool PAIR = AfCfg<D>::PAIR, KEY1 = AfCfg<D>::KEY1;
    static constexpr int SD = D + 4;             // Q, K (and V) row stride (floats)
    static constexpr int SV = KEY1 ? D : SD;     // V's: D/4 = 2 mod 8, so key groups 0..3 hit distinct quads
    // P: KEY1 stores a row's keys in KG runs of PSEG floats (key groups' loads in distinct quads), else in order;
    // the row stride puts a warp's P loads (and, KEY1 aside, its stores) in distinct quads
    static constexpr int PSEG = AF_BN / KG + 4, PS = KEY1 ? KG * PSEG : AF_BN + 32 / RG;
    static constexpr int SLOTS = PAIR ? 4 : 3;
    // the copies: thread (lr, lc) moves chunk lc (< d/4) of rows lr + RSTEP*r, NCP >= D/4 a power of two
    static constexpr int NCP = D <= 64 ? 16 : D <= 128 ? 32 : 64, RSTEP = THREADS / NCP;
    static constexpr size_t SMEM =
        4 * ((size_t)AF_BM * SD + (size_t)AF_BN * (PAIR ? 2 * (SD + SV) : 3 * SD) + (size_t)AF_BM * PS);
    static_assert(RW % 4 == 0 && (D / 4) % CG == 0 && KS % CG == 0 && 16 % KG == 0 && AF_BN % RSTEP == 0,
                  "lane split");
    static_assert(!KEY1 || (PAIR && KG == 4 && KS % KG == 0 && (SV / 4) % 8 == 2 && PS == 80), "KEY1 layout");
    static_assert(SMEM <= 232448, "shared memory per block");
};

__device__ __forceinline__ float af_dot4(const float4& a, const float4& b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void af_fma(float4& acc, float p, const float4& v) {
    acc.x = fmaf(p, v.x, acc.x);
    acc.y = fmaf(p, v.y, acc.y);
    acc.z = fmaf(p, v.z, acc.z);
    acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float4 af_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float af_get(const float4& x, int c) {
    return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

template <bool EXP2>
__device__ __forceinline__ float af_exp(float x) {
    return EXP2 ? exp2f(x) : expf(x);
}

// q, o: element (b, l, h, j) at ((b*Lq + l)*H + h)*ld + j; k, v the same with
// Lk.  ld: the stored head width (K1: d_pad; K6: d), ld % 4 == 0; d: the real
// head dim, d % 4 == 0, d <= D, d <= ld: columns d .. D are zero in shared
// memory, o's columns d .. ld come out exactly 0.  q is multiplied by `scale`
// in f32 as it lands (K1: 1).
template <int D, bool EXP2>
__global__ void __launch_bounds__(AfShape<D>::THREADS, AfCfg<D>::MINB)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int Lq, int Lk, int H, int ld, int d, float scale) {
    using S = AfShape<D>;
    constexpr int RW = S::RW, RG = S::RG, KS = S::KS, NE = S::NE, CG = S::CG, KG = S::KG, NCH = S::NCH;
    constexpr int SD = S::SD, SV = S::SV, PS = S::PS, SLOTS = S::SLOTS, THREADS = S::THREADS, RSTEP = S::RSTEP;
    constexpr bool PAIR = S::PAIR, KEY1 = S::KEY1;
    extern __shared__ __align__(16) float af_smem[];
    float* sQ = af_smem;           // [64][SD], q * scale
    float* sKV = sQ + AF_BM * SD;  // SLOTS x [64][SD or SV]: K(j) in slot (2j) % SLOTS, V(j) in (2j + 1) % SLOTS
    float* sP = sKV + AF_BN * (PAIR ? 2 * (SD + SV) : 3 * SD);  // [NW][RW][PS]: each warp's probabilities
    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int rg = lane / KS, kg = lane % KS;  // S: rows rg + RG*i, keys kg + KS*e
    const int cg = kg % CG, kgp = kg / CG;     // P.V: chunks cg + CG*j, key quads kgp + KG*t
    const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * AF_BM;
    const size_t rs = (size_t)H * ld;  // a token's row (floats)
    const float* qg = q + ((size_t)b * Lq + q0) * rs + (size_t)h * ld;
    const float* kg0 = k + (size_t)b * Lk * rs + (size_t)h * ld;
    const float* vg0 = v + (size_t)b * Lk * rs + (size_t)h * ld;
    const int nc = d / 4, nkv = Lk / AF_BN;
    const float* sQw = sQ + w * RW * SD;
    float* sPw = sP + w * RW * PS;
    // slot sl (PAIR: K, V, K, V; else three of one stride) and its row stride
    auto slot = [&](int sl) { return sKV + (PAIR ? (sl / 2) * AF_BN * (SD + SV) + (sl % 2) * AF_BN * SD : sl * AF_BN * SD); };
    auto slot_stride = [&](int sl) { return PAIR && sl % 2 ? SV : SD; };

    // item n of the stream: K(n / 2) for even n, V(n / 2) for odd, into slot n % SLOTS
    const int lc = tid % S::NCP, lr = tid / S::NCP;
    auto load = [&](int n) {
        if (lc < nc) {
            const float* g = (n & 1 ? vg0 : kg0) + ((size_t)(n / 2) * AF_BN + lr) * rs + 4 * lc;
            const int st = slot_stride(n % SLOTS);
            float* dst = slot(n % SLOTS) + lr * st + 4 * lc;
#pragma unroll
            for (int r = 0; r < AF_BN / RSTEP; ++r) cp_async_16(dst + r * RSTEP * st, g + (size_t)r * RSTEP * rs);
        }
    };
    load(0);
    if (!PAIR) cp_async_commit();
    load(1);
    cp_async_commit();
    // the columns d .. D of Q and of every K/V slot: zero once, no load writes them
    if (d < D) {
        const int pc = D - d;
        for (int i = tid; i < (AF_BM + SLOTS * AF_BN) * pc; i += THREADS) {
            const int r = i / pc, sl = r / AF_BN - 1, c = d + i % pc;
            (sl < 0 ? sQ + r * SD : slot(sl) + (r % AF_BN) * slot_stride(sl))[c] = 0.f;
        }
    }
    for (int i = tid; i < AF_BM * nc; i += THREADS) {
        const int r = i / nc, c = (i % nc) * 4;
        const float4 x = __ldg(reinterpret_cast<const float4*>(qg + (size_t)r * rs + c));
        *reinterpret_cast<float4*>(sQ + r * SD + c) =
            make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }

    float4 acc[4][NCH];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NCH; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m_run[4], l_run[4];  // each row's running max; the lane's share of its running sum
#pragma unroll
    for (int i = 0; i < 4; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

    for (int j = 0; j < nkv; ++j) {
        // K(j) landed (PAIR: and V(j)); every warp done with the slots the next items take
        if (PAIR)
            cp_async_wait<0>();
        else
            cp_async_wait<1>();
        __syncthreads();
        if (j + 1 < nkv) {
            load(2 * j + 2);
            if (PAIR) load(2 * j + 3);
        }
        cp_async_commit();  // (an empty group on the last tile keeps the wait counts)

        // ---- S = Q K^T: rows rg + RG*i, keys kg + KS*e
        const float* sK = slot((2 * j) % SLOTS);
        float s[4][NE];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < NE; ++e) s[i][e] = 0.f;
#pragma unroll(AfCfg<D>::SU)
        for (int c = 0; c < D; c += 4) {
            float4 qv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = af_ld4(sQw + (rg + RG * i) * SD + c);
#pragma unroll
            for (int e = 0; e < NE; ++e) {
                const float4 kv = af_ld4(sK + (kg + KS * e) * SD + c);
#pragma unroll
                for (int i = 0; i < 4; ++i) s[i][e] = af_dot4(qv[i], kv, s[i][e]);
            }
        }

        // ---- online softmax of the 4 rows over the tile's keys, in registers; P to the warp's slice
        // (KEY1: key kg + KS*e at (key % KG) * PSEG + key / KG, each P.V key group's keys in a run)
        const int pk = KEY1 ? (kg % KG) * S::PSEG + kg / KG : kg;
        constexpr int PE = KEY1 ? KS / KG : KS;
        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = s[i][0];
#pragma unroll
            for (int e = 1; e < NE; ++e) mx = fmaxf(mx, s[i][e]);
#pragma unroll
            for (int off = 1; off < KS; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mn = fmaxf(m_run[i], mx);
            alpha[i] = af_exp<EXP2>(m_run[i] - mn);
            m_run[i] = mn;
            float sum = 0.f;
#pragma unroll
            for (int e = 0; e < NE; ++e) {
                const float p = af_exp<EXP2>(s[i][e] - mn);
                sum += p;
                sPw[(rg + RG * i) * PS + pk + PE * e] = p;
            }
            l_run[i] = l_run[i] * alpha[i] + sum;
        }
        __syncwarp();
        if (!PAIR) {
            cp_async_wait<1>();
            __syncthreads();  // V(j) landed, every warp done with K(j)
            if (j + 1 < nkv) load(2 * j + 3);
            cp_async_commit();
        }

        // ---- O = O * alpha + P V: rows rg + RG*i, chunks cg + CG*jj, key quads kgp + KG*t (KEY1: keys
        // kgp + KG*(4t + cc))
        const float* sV = slot((2 * j + 1) % SLOTS) + 4 * cg;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < NCH; ++jj) {
                acc[i][jj].x *= alpha[i];
                acc[i][jj].y *= alpha[i];
                acc[i][jj].z *= alpha[i];
                acc[i][jj].w *= alpha[i];
            }
#pragma unroll(AfCfg<D>::PU)
        for (int t = 0; t < AF_BN / 4 / KG; ++t) {
            const int pat = KEY1 ? kgp * S::PSEG + 4 * t : 4 * (kgp + KG * t);
            float4 p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = af_ld4(sPw + (rg + RG * i) * PS + pat);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int key = KEY1 ? kgp + KG * (4 * t + cc) : pat + cc;
#pragma unroll
                for (int jj = 0; jj < NCH; ++jj) {
                    const float4 vv = af_ld4(sV + key * SV + 4 * CG * jj);
#pragma unroll
                    for (int i = 0; i < 4; ++i) af_fma(acc[i][jj], af_get(p[i], cc), vv);
                }
            }
        }
    }
    cp_async_wait<0>();

    // the rows' sums and the key groups' partial outputs, added across the lanes that hold them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < KS; off *= 2) l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], off);
#pragma unroll
        for (int jj = 0; jj < NCH; ++jj)
#pragma unroll
            for (int off = CG; off < KS; off *= 2) {
                acc[i][jj].x += __shfl_xor_sync(0xffffffffu, acc[i][jj].x, off);
                acc[i][jj].y += __shfl_xor_sync(0xffffffffu, acc[i][jj].y, off);
                acc[i][jj].z += __shfl_xor_sync(0xffffffffu, acc[i][jj].z, off);
                acc[i][jj].w += __shfl_xor_sync(0xffffffffu, acc[i][jj].w, off);
            }
    }
    float* ow = o + ((size_t)b * Lq + q0 + w * RW) * rs + (size_t)h * ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float l = l_run[i];
        float* orow = ow + (size_t)(rg + RG * i) * rs;
#pragma unroll
        for (int jj = 0; jj < NCH; ++jj) {
            const int col = 4 * (cg + CG * jj);
            if (jj % KG == kgp && col < ld) {  // each key group stores its share of the chunks
                const float4 a = acc[i][jj];
                *reinterpret_cast<float4*>(orow + col) = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
            }
        }
    }
    // K1's stored columns past the computed width: exactly 0
    if (ld > D) {
        const int zc = (ld - D) / 4;
        for (int i = lane; i < RW * zc; i += 32)
            *reinterpret_cast<float4*>(ow + (size_t)(i / zc) * rs + D + 4 * (i % zc)) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

template <int D, bool EXP2>
static cudaError_t attention_f32_launch(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                                        int Lk, int H, int ld, int d, float scale, cudaStream_t s) {
    using S = AfShape<D>;
    auto kern = attention_f32_kernel<D, EXP2>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err == cudaSuccess)  // the whole carveout for shared memory, so MINB blocks fit an SM
        err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kern<<<dim3(Lq / AF_BM, H, B), S::THREADS, S::SMEM, s>>>(static_cast<const float*>(q),
                                                             static_cast<const float*>(k),
                                                             static_cast<const float*>(v), static_cast<float*>(out),
                                                             Lq, Lk, H, ld, d, scale);
    return cudaGetLastError();
}

// The least computed width D >= d runs the head.
template <bool EXP2>
static int attention_f32_dispatch(const void* q, const void* k, const void* v, void* out, int B, int Lq, int Lk,
                                  int H, int ld, int d, float scale, void* stream) {
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Lq <= 0 || Lk <= 0 || Lq % AF_BM || Lk % AF_BN ||
        d <= 0 || d % 4 || d > 192 || ld < d || ld % 4)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d <= 40) return (int)attention_f32_launch<40, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
    if (d <= 64) return (int)attention_f32_launch<64, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
    if (d <= 80) return (int)attention_f32_launch<80, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
    if (d <= 128) return (int)attention_f32_launch<128, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
    if (d <= 160) return (int)attention_f32_launch<160, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
    return (int)attention_f32_launch<192, EXP2>(q, k, v, out, B, Lq, Lk, H, ld, d, scale, s);
}

// K5 in f32, phase 1: [Q | K | V] = x [wq | wk | wv]^T.  blockIdx.x walks
// the 3 * HD / GF_BN column tiles (Q's, then K's, then V's: tile n reads
// rows (n % per) * 64 .. + 63 of one projection's weights), blockIdx.y the
// ceil(M / GF_BM) row tiles; the three outputs are (M, HD) planes one after
// another in qkv.
__global__ void __launch_bounds__(GF_THREADS, 2)
attention_block_f32_qkv_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                               const float* __restrict__ wk, const float* __restrict__ wv, float* __restrict__ qkv,
                               int M, int C, int HD) {
    extern __shared__ __align__(16) float gf_smem[];
    const int per = HD / GF_BN, which = blockIdx.x / per, n0 = (blockIdx.x % per) * GF_BN;
    const int m0 = blockIdx.y * GF_BM, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][4];
    gf_tile(x, C, which == 0 ? wq : which == 1 ? wk : wv, C, M, C, m0, n0, gf_smem, acc);
    float* o = qkv + (size_t)which * M * HD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e) o[(size_t)row * HD + n0 + tx + 16 * e] = acc[i][e];
        }
    }
}

// K5 in f32, phase 3: out = packed wo^T + bo + residual, the sum in that
// order (the TPU kernel's and the plain version's); blockIdx.x walks the C /
// GF_BN column tiles, blockIdx.y the row tiles.
__global__ void __launch_bounds__(GF_THREADS, 2)
attention_block_f32_out_kernel(const float* __restrict__ packed, const float* __restrict__ wo,
                               const float* __restrict__ bo, const float* __restrict__ res, float* __restrict__ out,
                               int M, int C, int HD) {
    extern __shared__ __align__(16) float gf_smem[];
    const int n0 = blockIdx.x * GF_BN, m0 = blockIdx.y * GF_BM, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][4];
    gf_tile(packed, HD, wo, HD, M, HD, m0, n0, gf_smem, acc);
    float bs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bs[e] = __ldg(bo + n0 + tx + 16 * e);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const size_t at = (size_t)row * C + n0 + tx + 16 * e;
                out[at] = (acc[i][e] + bs[e]) + __ldg(res + at);
            }
        }
    }
}

static cudaError_t attention_block_f32_run(const float* x, const float* res, const float* wq, const float* wk,
                                           const float* wv, const float* wo, const float* bo, float* ws, float* out,
                                           int B, int L, int C, int H, int dp, int d, cudaStream_t s) {
    const int HD = H * dp, M = B * L, mt = (M + GF_BM - 1) / GF_BM;
    if (mt > 65535) return cudaErrorInvalidValue;
    const size_t n = (size_t)M * HD;
    float *q = ws, *k = ws + n, *v = ws + 2 * n, *packed = ws + 3 * n;
    cudaError_t err = cudaFuncSetAttribute(attention_block_f32_qkv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GF_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(attention_block_f32_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)GF_SMEM);
    if (err != cudaSuccess) return err;
    attention_block_f32_qkv_kernel<<<dim3(3 * HD / GF_BN, mt), GF_THREADS, GF_SMEM, s>>>(x, wq, wk, wv, q, M, C, HD);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = (cudaError_t)attention_f32_dispatch<true>(q, k, v, packed, B, L, L, H, dp, d, 1.0f, s);
    if (err != cudaSuccess) return err;
    attention_block_f32_out_kernel<<<dim3(C / GF_BN, mt), GF_THREADS, GF_SMEM, s>>>(packed, wo, bo, res, out, M, C,
                                                                                    HD);
    return cudaGetLastError();
}

}  // namespace saspa

// K1 in f32: q, k, v, out contiguous, 16-byte aligned (B, L, H*dp) f32 on the
// device, q pre-scaled by softmax_scale*log2(e); dp 64, 128 or 192; d the
// real head dim (d % 4 == 0, d <= dp; the columns d .. dp of q, k and v are
// zero, out's come out exactly 0); L % 64 == 0.  Returns a cudaError_t (0 on
// success).
extern "C" int saspa_attention_f32_packed(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, int dp, int d, void* stream) {
    if (dp != 64 && dp != 128 && dp != 192) return (int)cudaErrorInvalidValue;
    return saspa::attention_f32_dispatch<true>(q, k, v, out, B, L, L, H, dp, d, 1.0f, stream);
}

// K6 in f32: q, out (B, Lq, H, d), k, v (B, Lk, H, d), contiguous, 16-byte
// aligned f32 on the device; d % 8 == 0, d <= 192; Lq % 64 == 0, Lk % 64 ==
// 0; q is multiplied by scale in f32.  Returns a cudaError_t (0 on success).
extern "C" int saspa_flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                                         int Lk, int H, int d, float scale, void* stream) {
    if (d % 8) return (int)cudaErrorInvalidValue;
    return saspa::attention_f32_dispatch<false>(q, k, v, out, B, Lq, Lk, H, d, d, scale, stream);
}

// K5 in f32: x_ln, residual, out (B, L, C); wq (pre-scaled by
// softmax_scale*log2(e)), wk, wv (H*dp, C); wo (C, H*dp); bo (C,); ws 4 *
// B*L*H*dp floats (Q, K, V, then the packed heads, each (B, L, H*dp)).  All
// f32, contiguous and 16-byte aligned on the device; L % 64 == 0 (the
// core's 64-row query tiles and 64-key tiles), C % 64 == 0 (the products'
// 64-column tiles and 32-deep stages), dp 64, 128 or 192, d the real head
// dim (d % 4 == 0, d <= dp; the weights' rows d .. dp of each head zero, so
// Q's, K's and V's columns are, and the packed heads' come out exactly 0).
// Returns a cudaError_t (0 on success).
extern "C" int saspa_attention_block_f32(const void* x_ln, const void* residual, const void* wq, const void* wk,
                                         const void* wv, const void* wo, const void* bo, void* ws, void* out, int B,
                                         int L, int C, int H, int dp, int d, void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || L % AF_BM || C <= 0 || C % GF_BN ||
        (dp != 64 && dp != 128 && dp != 192) || d <= 0 || d % 4 || d > dp)
        return (int)cudaErrorInvalidValue;
    return (int)attention_block_f32_run(
        static_cast<const float*>(x_ln), static_cast<const float*>(residual), static_cast<const float*>(wq),
        static_cast<const float*>(wk), static_cast<const float*>(wv), static_cast<const float*>(wo),
        static_cast<const float*>(bo), static_cast<float*>(ws), static_cast<float*>(out), B, L, C, H, dp, d,
        static_cast<cudaStream_t>(stream));
}
