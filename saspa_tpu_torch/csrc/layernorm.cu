// One-pass LayerNorm for Hopper (K4).
//
// Replaces saspa_tpu/ops/layernorm.py::layer_norm_one_pass (Pallas kernel
// _ln_kernel).  For x of shape (M, C) bf16:
//     mean = E[x], var = E[x^2] - mean^2 (f32, no clamp), rs = rsqrt(var + eps)
//     out  = bf16(bf16(bf16(x - bf16(mean)) * bf16(rs * scale)) + bf16(bias))
// i.e. the normalize in bf16 in flax's association, with a bf16 rounding
// after each op, exactly as _ln_kernel and models/unet.py::_ln32_forward.
// For x f32 (an f32 UNet's norm1/norm2/norm3: _ln_kernel's f32 branch):
//     out  = (x - mean) * (rs * scale) + bias
// all in f32, each product and sum rounded on its own.
//
// What bounds it on an H100: a handful of flops per element against 4 bytes
// (bf16) or 8 bytes (f32) of one read and one write: HBM bandwidth.  The TPU
// kernel kept a q-block of rows in VMEM for one read and one write; here a
// few lanes of a warp own one row and keep it in registers between the
// statistics and the normalize, with a host-chosen plan that leaves no lane
// idle at the UNet's widths (layernorm_row.cuh, shared with K2's first
// stage; f32 rows hold 4 elements a 16-byte vector, so up to 12 vectors a
// lane for C up to 1536).
#include "layernorm_row.cuh"

namespace saspa {

template <int V, typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, int M, int C, int lanes, float eps) {
    extern __shared__ __align__(16) float ln_params[];
    layernorm_rows<V, T>(x, scale, bias, out, ln_params, M, C, lanes, eps);
}

static const LayerNormKernelT<bf16> kLayerNormKernels[LN_MAXV] = {
    layernorm_kernel<1, bf16>, layernorm_kernel<2, bf16>, layernorm_kernel<3, bf16>, layernorm_kernel<4, bf16>,
    layernorm_kernel<5, bf16>, layernorm_kernel<6, bf16>, layernorm_kernel<7, bf16>, layernorm_kernel<8, bf16>};

static const LayerNormKernelT<float> kLayerNormKernelsF32[LN_MAXV_F32] = {
    layernorm_kernel<1, float>, layernorm_kernel<2, float>,  layernorm_kernel<3, float>,
    layernorm_kernel<4, float>, layernorm_kernel<5, float>,  layernorm_kernel<6, float>,
    layernorm_kernel<7, float>, layernorm_kernel<8, float>,  layernorm_kernel<9, float>,
    layernorm_kernel<10, float>, layernorm_kernel<11, float>, layernorm_kernel<12, float>};

}  // namespace saspa

// x, out: (M, C) bf16 (f32 = 0) or f32 (f32 = 1); scale, bias: (C,) f32;
// all contiguous and 16-byte aligned on the device; C % 8 == 0 and C <= 2048
// (bf16) or 1536 (f32).  lanes, vecs, blocks: the launch plan
// (ops/layernorm.py::ln_plan).  Returns a cudaError_t (0 on success).
extern "C" int saspa_layernorm(const void* x, const void* scale, const void* bias, void* out, int M, int C,
                               int lanes, int vecs, int blocks, float eps, int f32, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (f32)
        return (int)saspa::layernorm_launch<float>(saspa::kLayerNormKernelsF32, x, scale, bias, out, M, C, lanes,
                                                   vecs, blocks, eps, s);
    return (int)saspa::layernorm_launch<saspa::bf16>(saspa::kLayerNormKernels, x, scale, bias, out, M, C, lanes, vecs,
                                              blocks, eps, s);
}
