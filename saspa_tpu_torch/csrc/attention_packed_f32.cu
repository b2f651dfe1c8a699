// Packed-heads self-attention in f32 at head dim 512 for Hopper (K1, f32).
//
// Replaces saspa_tpu/ops/attention.py::flash_attention_packed (Pallas kernel
// _packed_kernel) on f32 activations: the XL VAE's one head of 512 under
// SASPA_XL_VAE_FP32=1 (the reference's upcast_vae), at the token counts
// packed_flash_eligible admits for 4-byte items (4096 at 512^2; at 1024^2
// JAX sends f32 to _xla_attention, and the port to its plain attention).
// Computes, for every batch row b and head h,
//     out[b, :, h*512:(h+1)*512] = softmax2(q_h k_h^T) v_h
// over packed (B, L, H*512) f32 tensors, where q arrives pre-scaled by
// softmax_scale*log2(e) in f32, so the softmax uses exp2.  Scores,
// probabilities, the running max and sum, the P.V product and the output
// are all f32, as the TPU kernel computes an f32 block (P cast to v's dtype
// is f32 there).
//
// What bounds it on an H100: operations.  The work is 4*B*H*L^2*512 flops
// against 16*B*H*L*512 bytes, L/4 flops a byte (1024 at L = 4096); in f32
// outside the tensor cores the card does 67 TFLOP/s, so that rate bounds it
// (4.1 ms at B8 L4096).  TF32 wgmma would be faster but rounds q, k, P and v
// to 10 mantissa bits, other numerics than the TPU kernel's f32: this kernel
// is f32 FFMA on the CUDA cores.  An SM issues one warp instruction a clock
// on each of its 4 sub-partitions, and a FFMA needs that slot, so what keeps
// a FFMA loop from its rate is every other instruction, above all the
// shared-memory reads, and the shared-memory bandwidth (one 128-byte
// wavefront a clock an SM) those reads take.
//
// Design: one block of 8 warps (256 threads) per 64 query rows of one (b,
// h), grid (L/64, H, B), one block an SM: Q (64 rows of 516 floats, 132 KB)
// stays in shared memory, and K and V stream through it in 16-key tiles (32
// KB each), so each K/V tile fetched from L2 serves 64 rows.  Both products
// are register-tiled, and the lanes of a warp are laid out so that their
// shared-memory reads are mostly broadcasts:
//   S = Q K^T: warp w owns a 32-row x 16-key tile of S over one quarter of
//     the 512 dims (rows 32*(w % 2) .., quarter w / 2); a lane owns 4 rows
//     (rg + 8*i) x 4 keys (kg + 4*e).  Each step reads 4 float4 of q and 4
//     of k and does 64 FFMAs, 8 a read; a warp's q reads are 8 distinct rows
//     (one wavefront) and its k reads 4 distinct keys (one), against 12
//     wavefronts for the same work when the quarters were neighbouring
//     lanes summed by shuffles.  The four quarters' partial tiles meet in
//     shared memory (16 KB).
//   O += P V: warp w owns 8 query rows and a lane 16 output columns
//     (lane*4 + 128*c, c < 4): 128 f32 accumulators a thread for the whole
//     loop.  Each key reads the warp's 8 probabilities as two broadcast
//     float4 (P is kept transposed, keys x rows) and 4 float4 of the V row,
//     and does 128 FFMAs, 21 a read.
// The softmax (base 2, as the TPU kernel's) of a row runs in the 4 lanes of
// the warp that owns the row in P.V: they sum the row's 4 partials, take its
// max over the tile's 16 keys by two shuffles, keep the running max and
// their share of the row sum, and write P transposed and the row's rescale
// factor, which only their own warp reads (a __syncwarp, not a block
// barrier); O is rescaled only where a factor is not 1 (warp-uniform).  K
// and V arrive by TMA (one thread issues them; K in 32-float boxes with the
// 128-byte swizzle, which keeps a warp's 4 key rows off each other's banks,
// V in plain 256-float boxes), one tile ahead of their use: K(j + 1) behind
// the softmax and P.V of tile j, V(j + 1) behind the scores of tile j + 1.
// Two block barriers a tile: the partial scores written (K free), P.V done
// (V and the partials free).  Q is loaded once by cp.async.  Shared memory
// 215 KB; the 128 accumulators and the S tile's operands take about 246
// registers a thread, no spills.  What bounds it below the FFMA rate: the
// accumulators cap the block at 8 warps, 2 a scheduler, too few to hide
// the shared-memory reads' latency behind each other's FFMAs, and S's loop
// spends one issue slot in 9 on a read.
#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

#include <math.h>

namespace saspa {

constexpr int F32_DP = 512;          // head dim
constexpr int F32_BM = 64;           // query rows a block
constexpr int F32_BN = 16;           // keys a K/V tile
constexpr int F32_THREADS = 256;
constexpr int F32_SQ = F32_DP + 4;   // Q's row stride (floats): a row's chunk c sits 4 banks past the row above's
constexpr int F32_SPT = F32_BM + 4;  // transposed P's row stride (floats)
constexpr int F32_K_BOX = F32_BN * 128;         // K: 16 boxes of 16 keys x 32 floats, 128-byte swizzle
constexpr int F32_V_BOX = F32_BN * 256 * 4;     // V: 2 boxes of 16 keys x 256 floats
constexpr int F32_TILE = F32_BN * F32_DP * 4;   // one K or V tile: 32 KB
constexpr int F32_Q_BYTES = F32_BM * F32_SQ * 4;
constexpr int F32_RED = 4 * F32_BM * F32_BN;  // the 4 quarters' partial scores
constexpr size_t F32_SMEM = 1024 + F32_Q_BYTES + 2 * F32_TILE + 4 * (F32_BN * F32_SPT + 2 * F32_BM + F32_RED);
static_assert(F32_Q_BYTES % 1024 == 0, "K's swizzled boxes start 1024-byte aligned");
static_assert(F32_SMEM + 64 <= 232448, "shared memory per block (the barriers are static)");

__device__ __forceinline__ float4 f4_scale(float4 a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ void f4_fma(float4& acc, float p, const float4& v) {
    acc.x = fmaf(p, v.x, acc.x);
    acc.y = fmaf(p, v.y, acc.y);
    acc.z = fmaf(p, v.z, acc.z);
    acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
}

__global__ void __launch_bounds__(F32_THREADS, 1)
attention_packed_f32_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, float* __restrict__ o, int L, int HD) {
    __shared__ __align__(8) uint64_t bars[2];  // K full, V full
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* gbase = smem_raw + (base - raw);
    float* sQ = reinterpret_cast<float*>(gbase);
    const unsigned char* gK = gbase + F32_Q_BYTES;
    const unsigned char* gV = gK + F32_TILE;
    float* sPt = reinterpret_cast<float*>(gbase + F32_Q_BYTES + 2 * F32_TILE);  // [key][row]
    float* sAlpha = sPt + F32_BN * F32_SPT;
    float* sSum = sAlpha + F32_BM;
    float* sRed = sSum + F32_BM;  // [quarter][row][key]
    const uint32_t sK = base + F32_Q_BYTES, sV = sK + F32_TILE;
    const uint32_t kfull = smem_addr(&bars[0]), vfull = smem_addr(&bars[1]);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const int row0 = b * L, col0 = h * F32_DP;
    const size_t q0 = (size_t)blockIdx.x * F32_BM;
    const int nkv = L / F32_BN;

    auto load_k = [&](int j) {
        mbar_arrive_expect_tx(kfull, F32_TILE);
#pragma unroll
        for (int a = 0; a < F32_DP / 32; ++a)
            tma_load_2d(sK + a * F32_K_BOX, &mk, col0 + 32 * a, row0 + j * F32_BN, kfull);
    };
    auto load_v = [&](int j) {
        mbar_arrive_expect_tx(vfull, F32_TILE);
#pragma unroll
        for (int a = 0; a < 2; ++a) tma_load_2d(sV + a * F32_V_BOX, &mv, col0 + 256 * a, row0 + j * F32_BN, vfull);
    };
    if (threadIdx.x == 0) {
        mbar_init(kfull, 1);
        mbar_init(vfull, 1);
        mbar_fence_init();
        load_k(0);
        load_v(0);
    }
    {
        const float* qg = q + ((size_t)row0 + q0) * HD + col0;
        for (int i = threadIdx.x; i < F32_BM * (F32_DP / 4); i += F32_THREADS) {
            const int r = i / (F32_DP / 4), c = (i % (F32_DP / 4)) * 4;
            cp_async_16(sQ + r * F32_SQ + c, qg + (size_t)r * HD + c);
        }
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();

    // scores: warp w owns rows 32*(w % 2) + rg + 8*i (i < 4) and keys kg + 4*e (e < 4) of the tile over
    // the dims' quarter w / 2 (chunks 32*(w/2) .. +31); lanes: rg = lane % 8, kg = lane / 8
    const int rg = lane & 7, kg = lane >> 3, half = warp & 1, quarter = warp >> 1;
    const float* qr = sQ + (32 * half + rg) * F32_SQ + 128 * quarter;
    // key kg + 4*e's chunk c (= 32*quarter + 8*box' + cc) in the 128-byte swizzle: chunk cc ^ (key % 8) of its row
    const unsigned char* kr = gK + (4 * quarter) * F32_K_BOX;
    // softmax: thread owns row sr and keys 4*sk .. +3
    const int sr = threadIdx.x >> 2, sk = threadIdx.x & 3;
    // P.V: rows 8*warp .. +7, columns lane*4 + 128*c
    const int pr = 8 * warp;

    float4 acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m0 = -INFINITY, l0 = 0.f;  // row sr's running max, this thread's share of its sum (its 4 keys)

    for (int j = 0; j < nkv; ++j) {
        mbar_wait(kfull, j & 1);
        // ---- S = Q K^T: this warp's 32 x 16 tile over its quarter of the dims
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
        for (int bx = 0; bx < 4; ++bx) {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
                float4 qv[4], kv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    qv[i] = *reinterpret_cast<const float4*>(qr + 8 * i * F32_SQ + 32 * bx + 4 * cc);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = kg + 4 * e;
                    kv[e] = *reinterpret_cast<const float4*>(kr + bx * F32_K_BOX + key * 128 + 16 * (cc ^ (key & 7)));
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[i][e] = dot4(qv[i], kv[e], s[i][e]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                sRed[(quarter * F32_BM + 32 * half + rg + 8 * i) * F32_BN + kg + 4 * e] = s[i][e];
        __syncthreads();  // the partials written, every warp done with K tile j
        if (threadIdx.x == 0 && j + 1 < nkv) load_k(j + 1);
        // ---- online softmax, base 2: row sr, keys 4*sk .. +3 (the row's 4 threads are neighbouring lanes)
        float4 sv = *reinterpret_cast<const float4*>(sRed + sr * F32_BN + 4 * sk);
#pragma unroll
        for (int qq = 1; qq < 4; ++qq) {
            const float4 t4 = *reinterpret_cast<const float4*>(sRed + (qq * F32_BM + sr) * F32_BN + 4 * sk);
            sv.x += t4.x;
            sv.y += t4.y;
            sv.z += t4.z;
            sv.w += t4.w;
        }
        float mx = fmaxf(fmaxf(sv.x, sv.y), fmaxf(sv.z, sv.w));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m0, mx);
        const float al = exp2f(m0 - mn);
        m0 = mn;
        sv = make_float4(exp2f(sv.x - mn), exp2f(sv.y - mn), exp2f(sv.z - mn), exp2f(sv.w - mn));
        l0 = l0 * al + ((sv.x + sv.y) + (sv.z + sv.w));
        sPt[(4 * sk) * F32_SPT + sr] = sv.x;
        sPt[(4 * sk + 1) * F32_SPT + sr] = sv.y;
        sPt[(4 * sk + 2) * F32_SPT + sr] = sv.z;
        sPt[(4 * sk + 3) * F32_SPT + sr] = sv.w;
        if (sk == 0) sAlpha[sr] = al;
        mbar_wait(vfull, j & 1);
        __syncwarp();  // the warp's own rows: P and the factors written by its lanes

        // ---- O = O * alpha + P V over the tile's 16 keys
        const float4 a0 = *reinterpret_cast<const float4*>(sAlpha + pr);
        const float4 a1 = *reinterpret_cast<const float4*>(sAlpha + pr + 4);
        if (a0.x != 1.f || a0.y != 1.f || a0.z != 1.f || a0.w != 1.f || a1.x != 1.f || a1.y != 1.f ||
            a1.z != 1.f || a1.w != 1.f) {  // the same for every lane of the warp
            const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = f4_scale(acc[i][c], ar[i]);
        }
        const unsigned char* vr = gV + lane * 16;
#pragma unroll 2
        for (int key = 0; key < F32_BN; ++key) {
            const float4 p0 = *reinterpret_cast<const float4*>(sPt + key * F32_SPT + pr);
            const float4 p1 = *reinterpret_cast<const float4*>(sPt + key * F32_SPT + pr + 4);
            const float pk[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float4 vv =
                    *reinterpret_cast<const float4*>(vr + (c >> 1) * F32_V_BOX + key * 1024 + (c & 1) * 512);
#pragma unroll
                for (int i = 0; i < 8; ++i) f4_fma(acc[i][c], pk[i], vv);
            }
        }
        __syncthreads();  // every warp done with V tile j and P
        if (threadIdx.x == 0 && j + 1 < nkv) load_v(j + 1);
    }

    // row sums: the row's 4 threads' shares
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    if (sk == 0) sSum[sr] = l0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float sum = sSum[pr + i];
        float* orow = o + ((size_t)row0 + q0 + pr + i) * HD + col0 + lane * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float4 a = acc[i][c];
            *reinterpret_cast<float4*>(orow + 128 * c) = make_float4(a.x / sum, a.y / sum, a.z / sum, a.w / sum);
        }
    }
}

}  // namespace saspa

// q, k, v, out: contiguous, 16-byte aligned (B, L, H*512) f32 on the device,
// q pre-scaled by softmax_scale*log2(e); L % 64 == 0.  Returns a cudaError_t
// (0 on success).
extern "C" int saspa_attention_packed_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || L % F32_BM != 0) return (int)cudaErrorInvalidValue;
    const uint64_t rows = (uint64_t)B * L, cols = (uint64_t)H * F32_DP;
    CUtensorMap mk, mv;
    if (!f32_map(&mk, k, rows, cols, F32_BN, 32, true) || !f32_map(&mv, v, rows, cols, F32_BN, 256, false))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_packed_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(L / F32_BM, H, B);
    attention_packed_f32_kernel<<<grid, F32_THREADS, F32_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), mk, mv, static_cast<float*>(out), L, H * F32_DP);
    return (int)cudaGetLastError();
}
