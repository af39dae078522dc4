// K2: per-row dynamic symmetric INT8 quantization of activations.
//
// Replaces tpu_llama/ops/quant.py:275 quantize_activations_pallas (its
// Pallas kernel _quant_rows_kernel, quant.py:266).  x [M, N] (f32 or bf16)
// -> q int8 [M, N], s f32 [M] with the row-quant formula of common.cuh
// (quant_scale, quant_inv; quant_byte = quant_i8): the formula of
// quant.py:255-263 as XLA compiles it, so the int8 bytes equal the JAX
// package's.
//
// Bound on the H100: bytes (each input read once, one int8 written per
// element; ~0.3 operations per byte).  Design: row_quant.cuh's stream --
// each row read once into the registers of a team of warps, its absmax a
// shuffle reduction, the int8 written from registers (bf16 rows in 16-byte
// stores), one row a team (the launch plan is ops/quant.py rq_plan).  CUDA
// rather than Triton: the kernel shares the ctypes build of the other
// kernels, so it adds no second toolchain to the build.
#include "row_quant.cuh"

namespace {

template <typename T, int TW>
__global__ void __launch_bounds__(kRqThreads, kRqBlocksPerSm)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                     long long M, long long N, int vec, int q16) {
    row_quant<T, float, false, TW>(x, nullptr, q, s, M, N, vec, q16);
}

template <typename T>
int launch(const void* x, int8_t* q, float* s, long long M, long long N, int vec, int q16,
           int tw, int grid, cudaStream_t st) {
    return rq_dispatch(tw, [&](auto twc) {
        quantize_rows_kernel<T, decltype(twc)::value><<<grid, kRqThreads, 0, st>>>(
            static_cast<const T*>(x), q, s, M, N, vec, q16);
        return static_cast<int>(cudaGetLastError());
    });
}

}  // namespace

// vec != 0 promises 16-byte aligned rows of x (N * sizeof(T) % 16 == 0 and
// x 16-byte aligned); q16 != 0 asks for 16-byte int8 stores (bf16 x, vec
// and N % 16 == 0); tw (warps a row: 1, 2, 4, 8) and grid come from
// ops/quant.py rq_plan.
extern "C" int tl_quantize_rows(const void* x, int x_dtype, int8_t* q, float* s, long long M,
                                long long N, int vec, int q16, int tw, int grid, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_dtype == TL_F32) return launch<float>(x, q, s, M, N, vec, q16, tw, grid, st);
    if (x_dtype == TL_BF16) return launch<__nv_bfloat16>(x, q, s, M, N, vec, q16, tw, grid, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
