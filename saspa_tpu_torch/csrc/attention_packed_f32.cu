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
// is f32 FFMA on the CUDA cores.
//
// Design: one block of 8 warps (256 threads) per 32 query rows of one
// (b, h), grid (L/32, H, B).  A 32 x 512 f32 output accumulator is 64 KB:
// each warp owns 4 query rows for the whole loop, and a lane holds those
// rows' 16 output columns lane*4 + 128*k (k < 4) as float4s, 64 registers.
// K and V stream through shared memory in 32-key tiles with an online
// (running max/sum) softmax: Q (64 KB), one K tile (66 KB, rows padded to
// 516 floats so a warp's float4 reads of 32 key rows hit every bank once a
// quarter-warp), one V tile (64 KB) and each warp's P tile (4 KB) make
// 201,216 bytes, one block an SM.  The V tile loads (cp.async) while the
// scores are computed, the next K tile while P.V is.  Scores: lane = key,
// 4 rows, each q float4 a broadcast and each k float4 a conflict-free
// read; the warp reduces the row max with shuffles, keeps the row sum per
// lane until the end, and writes exp2(s - max) to its P tile; P.V: each key
// reads the warp's 4 probabilities as one broadcast float4 and 4 float4s of
// the V row.  Shared-memory reads bound the inner loops (about 8 wavefronts
// per 16 FFMAs a thread in the scores, 17 per 64 in P.V), not the FFMA
// issue rate.
#include "mma_bf16.cuh"

#include <math.h>

namespace saspa {

constexpr int F32_DP = 512;     // head dim
constexpr int F32_BM = 32;      // query rows a block
constexpr int F32_BN = 32;      // keys a K/V tile
constexpr int F32_THREADS = 256;
constexpr int F32_SK = F32_DP + 4;  // K tile row stride (floats)
constexpr size_t F32_SMEM =
    sizeof(float) * ((size_t)F32_BM * F32_DP + (size_t)F32_BN * F32_SK + (size_t)F32_BN * F32_DP +
                     (F32_THREADS / 32) * F32_BN * 4);

// ROWS x 512 f32 tile from global (row stride ld floats) into shared memory
// (row stride sstride floats), 16 bytes a cp.async.
template <int ROWS>
__device__ __forceinline__ void load_f32_tile(float* s, int sstride, const float* g, int ld) {
    constexpr int CPR = F32_DP / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CPR; i += F32_THREADS) {
        const int r = i / CPR, c = (i % CPR) * 4;
        cp_async_16(s + r * sstride + c, g + (size_t)r * ld + c);
    }
}

__global__ void __launch_bounds__(F32_THREADS, 1)
attention_packed_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, int L, int HD) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + F32_BM * F32_DP;
    float* sV = sK + F32_BN * F32_SK;
    float* sP = sV + F32_BN * F32_DP;  // [warp][key][4 rows]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t head = (size_t)b * L * HD + (size_t)h * F32_DP;
    const size_t q0 = (size_t)blockIdx.x * F32_BM;
    const float* kg = k + head;
    const float* vg = v + head;
    const int nkv = L / F32_BN;

    load_f32_tile<F32_BM>(sQ, F32_DP, q + head + q0 * HD, HD);
    cp_async_commit();
    load_f32_tile<F32_BN>(sK, F32_SK, kg, HD);
    cp_async_commit();

    float4 acc[4][4];  // [row][column chunk k]: columns lane*4 + 128*k
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m[4], l[4];  // running max (the warp's, per row) and this lane's share of the row sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
    }
    const float* qr = sQ + warp * 4 * F32_DP;
    float* pw = sP + warp * F32_BN * 4;

    for (int j = 0; j < nkv; ++j) {
        load_f32_tile<F32_BN>(sV, F32_DP, vg + (size_t)j * F32_BN * HD, HD);
        cp_async_commit();
        cp_async_wait<1>();  // Q and K tile j
        __syncthreads();

        // scores of the warp's 4 rows against key `lane` of the tile
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const float* kr = sK + lane * F32_SK;
#pragma unroll 4
        for (int d = 0; d < F32_DP; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + i * F32_DP + d);
                s[i] = fmaf(qv.x, kv.x, s[i]);
                s[i] = fmaf(qv.y, kv.y, s[i]);
                s[i] = fmaf(qv.z, kv.z, s[i]);
                s[i] = fmaf(qv.w, kv.w, s[i]);
            }
        }

        // online softmax, base 2
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = s[i];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mn = fmaxf(m[i], mx);
            const float alpha = exp2f(m[i] - mn);
            m[i] = mn;
            p[i] = exp2f(s[i] - mn);
            l[i] = l[i] * alpha + p[i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                acc[i][c].x *= alpha;
                acc[i][c].y *= alpha;
                acc[i][c].z *= alpha;
                acc[i][c].w *= alpha;
            }
        }
        *reinterpret_cast<float4*>(pw + lane * 4) = make_float4(p[0], p[1], p[2], p[3]);
        __syncthreads();  // every warp is done with K tile j; P is written

        if (j + 1 < nkv) load_f32_tile<F32_BN>(sK, F32_SK, kg + (size_t)(j + 1) * F32_BN * HD, HD);
        cp_async_commit();
        cp_async_wait<1>();  // V tile j
        __syncthreads();

        // acc += P V over the tile's 32 keys
        const float* vr = sV + lane * 4;
#pragma unroll 4
        for (int key = 0; key < F32_BN; ++key) {
            const float4 pk = *reinterpret_cast<const float4*>(pw + key * 4);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float4 vv = *reinterpret_cast<const float4*>(vr + key * F32_DP + 128 * c);
                const float pr[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i][c].x = fmaf(pr[i], vv.x, acc[i][c].x);
                    acc[i][c].y = fmaf(pr[i], vv.y, acc[i][c].y);
                    acc[i][c].z = fmaf(pr[i], vv.z, acc[i][c].z);
                    acc[i][c].w = fmaf(pr[i], vv.w, acc[i][c].w);
                }
            }
        }
        __syncthreads();  // V tile j and the P tiles are read before they are refilled
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float sum = l[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        float* orow = o + head + (q0 + warp * 4 + i) * HD + lane * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float4 a = acc[i][c];
            *reinterpret_cast<float4*>(orow + 128 * c) = make_float4(a.x / sum, a.y / sum, a.z / sum, a.w / sum);
        }
    }
}

}  // namespace saspa

// q, k, v, out: contiguous, 16-byte aligned (B, L, H*512) f32 on the device,
// q pre-scaled by softmax_scale*log2(e); L % 32 == 0.  Returns a cudaError_t
// (0 on success).
extern "C" int saspa_attention_packed_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, void* stream) {
    using namespace saspa;
    if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || L % F32_BM != 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_packed_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(L / F32_BM, H, B);
    attention_packed_f32_kernel<<<grid, F32_THREADS, F32_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), L, H * F32_DP);
    return (int)cudaGetLastError();
}
