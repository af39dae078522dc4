// K3: fused rmsnorm + per-row INT8 quantization, one pass over device memory.
//
// Replaces tpu_llama/ops/quant.py:340 rmsnorm_quantize_pallas (its Pallas
// kernel _rmsnorm_quant_kernel, quant.py:324).  x [M, N] (f32 or bf16) and
// w [N] (f32 or bf16) -> q int8 [M, N], s f32 [M]:
//   ms = f32(sum_i x_i^2) * f32(1/N),   r = 1 / sqrt(1e-5 + ms),
//   xf_i = (x_i * r) * w_i,             then the row quant of common.cuh.
//
// Numerics kept from the TPU kernel, and why:
// - xf is quantized from f32, WITHOUT the unfused path's rounding of the
//   normalised row to the activation dtype (quant.py:325-329): that is the
//   fused prefill's definition, and the int8 it feeds to K1 is what the
//   JAX package's fused prefill multiplies.
// - The scale is absmax * f32(1/127), the product XLA makes of the Pallas
//   body's absmax / 127 (see common.cuh), so the bytes stay the JAX
//   package's.
// - The mean is the sum times f32(1/N), XLA's rewrite of jnp.mean's divide
//   by a constant.  The sum of squares accumulates in f64 (each square is
//   exact there) and rounds once to f32, so it does not depend on the order
//   of the sum: the plain version (ops/quant.py) does the same, and the two
//   agree bit for bit unless the exact sum lies within ~1e-13 of an f32
//   rounding boundary.  Every f32 product and sum is an explicit
//   round-to-nearest intrinsic (nvcc would contract a*b + c into an FMA),
//   and 1 / sqrt is two correctly rounded operations.  The plain version
//   takes that sqrt in f64 and rounds it once to f32 (the same value):
//   PyTorch's vectorised f32 sqrt is not correctly rounded on AVX-512 hosts.
//
// Bound on the H100: bytes.  At the 7B prefill shape, bf16 [4096, 4096],
// the pass must read 33.6 MB and write 16.8 MB of int8 + 16 KB of scales:
// 15 us at 3.35 TB/s, at ~5 operations per byte.  Design: row_quant.cuh's
// stream -- each row read once into the registers of a team of warps, the
// f64 sum of squares and then the absmax of xf shuffle reductions over
// those registers, the int8 written from them (bf16 rows in 16-byte
// stores), one row a team (ops/quant.py rq_plan).  xf is formed from the
// registers in the absmax pass and again in the quant pass (two rounded
// products an element): holding it as f32 doubles a bf16 row's registers,
// and measured slower (PERF.md section 6).  w (8 KB at 7B) is
// copied once per block into shared memory.
#include "row_quant.cuh"

namespace {

template <typename T, typename W, int TW>
__global__ void __launch_bounds__(kRqThreads, kRqBlocksPerSm)
rmsnorm_quantize_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        int8_t* __restrict__ q, float* __restrict__ s, long long M, long long N,
                        int vec, int q16) {
    row_quant<T, W, true, TW>(x, w, q, s, M, N, vec, q16);
}

template <typename T, typename W>
int launch(const void* x, const void* w, int8_t* q, float* s, long long M, long long N, int vec,
           int q16, int tw, int grid, cudaStream_t st) {
    const size_t smem = static_cast<size_t>(N) * sizeof(W);
    return rq_dispatch(tw, [&](auto twc) {
        auto* kern = rmsnorm_quantize_kernel<T, W, decltype(twc)::value>;
        if (smem > 48 * 1024) {  // rows of more than 12288 f32 or 24576 bf16 weights
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        kern<<<grid, kRqThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                                             q, s, M, N, vec, q16);
        return static_cast<int>(cudaGetLastError());
    });
}

}  // namespace

// vec != 0 promises 16-byte aligned rows of x (N * sizeof(T) % 16 == 0 and
// x 16-byte aligned); q16 != 0 asks for 16-byte int8 stores (bf16 x, vec
// and N % 16 == 0); tw and grid come from ops/quant.py rq_plan.
extern "C" int tl_rmsnorm_quantize(const void* x, int x_dtype, const void* w, int w_dtype,
                                   int8_t* q, float* s, long long M, long long N, int vec,
                                   int q16, int tw, int grid, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using bf = __nv_bfloat16;
    if (x_dtype == TL_F32 && w_dtype == TL_F32)
        return launch<float, float>(x, w, q, s, M, N, vec, q16, tw, grid, st);
    if (x_dtype == TL_F32 && w_dtype == TL_BF16)
        return launch<float, bf>(x, w, q, s, M, N, vec, q16, tw, grid, st);
    if (x_dtype == TL_BF16 && w_dtype == TL_F32)
        return launch<bf, float>(x, w, q, s, M, N, vec, q16, tw, grid, st);
    if (x_dtype == TL_BF16 && w_dtype == TL_BF16)
        return launch<bf, bf>(x, w, q, s, M, N, vec, q16, tw, grid, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
