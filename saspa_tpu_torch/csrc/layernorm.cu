// One-pass LayerNorm for Hopper (K4).
//
// Replaces saspa_tpu/ops/layernorm.py::layer_norm_one_pass (Pallas kernel
// _ln_kernel).  For x of shape (M, C) bf16:
//     mean = E[x], var = E[x^2] - mean^2 (f32, no clamp), rs = rsqrt(var + eps)
//     out  = bf16(bf16(bf16(x - bf16(mean)) * bf16(rs * scale)) + bf16(bias))
// i.e. the normalize in bf16 in flax's association, with a bf16 rounding
// after each op, exactly as _ln_kernel and models/unet.py::_ln32_forward.
//
// What bounds it on an H100: a handful of flops per element against 4 bytes
// (one bf16 read, one bf16 write): HBM bandwidth.  The TPU kernel kept a
// q-block of rows in VMEM for one read and one write; here a few lanes of a
// warp own one row and keep it in registers between the statistics and the
// normalize, with a host-chosen plan that leaves no lane idle at the UNet's
// widths (layernorm_row.cuh, shared with K2's first stage).
#include "layernorm_row.cuh"

namespace saspa {

template <int V>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int C, int lanes, float eps) {
    extern __shared__ __align__(16) float ln_params[];
    layernorm_rows<V>(x, scale, bias, out, ln_params, M, C, lanes, eps);
}

static const LayerNormKernel kLayerNormKernels[LN_MAXV] = {
    layernorm_kernel<1>, layernorm_kernel<2>, layernorm_kernel<3>, layernorm_kernel<4>,
    layernorm_kernel<5>, layernorm_kernel<6>, layernorm_kernel<7>, layernorm_kernel<8>};

}  // namespace saspa

// x, out: (M, C) bf16; scale, bias: (C,) f32; all contiguous and 16-byte
// aligned on the device; C % 8 == 0 and C <= 2048.  lanes, vecs, blocks: the
// launch plan (ops/layernorm.py::ln_plan).  Returns a cudaError_t (0 on
// success).
extern "C" int saspa_layernorm(const void* x, const void* scale, const void* bias, void* out, int M, int C,
                               int lanes, int vecs, int blocks, float eps, void* stream) {
    return (int)saspa::layernorm_launch(saspa::kLayerNormKernels, x, scale, bias, out, M, C, lanes, vecs, blocks,
                                        eps, static_cast<cudaStream_t>(stream));
}
