// Small helpers shared by the port's kernels: shared-memory addresses, bf16
// packing and rounding, and cp.async copies.
//
// The m16n8k16 fragment layouts, which wgmma's register A operand and its
// f32 accumulator repeat (PTX ISA, "mma.m16n8k16" with .bf16):
//   A (16x16, row):  a0 = (row g,   k 2t..2t+1)  a1 = (row g+8, k 2t..2t+1)
//                    a2 = (row g,   k 2t+8..9)   a3 = (row g+8, k 2t+8..9)
//   B (16x8,  col):  b0 = (k 2t..2t+1, col g)    b1 = (k 2t+8..9, col g)
//   C (16x8, f32):   c0,c1 = (row g, cols 2t, 2t+1)  c2,c3 = (row g+8, same)
// with g = lane / 4 and t = lane % 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace saspa {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats -> one register of two bf16 (round to nearest even); lo in bits 0..15.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// 16-byte global -> shared copy without staging through registers.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

}  // namespace saspa
