// K2: per-row dynamic symmetric INT8 quantization of activations.
//
// Replaces tpu_llama/ops/quant.py:275 quantize_activations_pallas.
// x [M, N] (f32 or bf16) -> q int8 [M, N], s f32 [M] with the row-quant
// formula of common.cuh (quant_scale, quant_inv, quant_i8): the formula of
// quant.py:255-263 as XLA compiles it, so the int8 bytes equal the JAX
// package's.
//
// Bound on the H100: bytes.  The pass reads each input once and writes one
// int8 per element (3 bytes per bf16 element, ~0.3 operations per byte).
// Design: one block per row.  The absmax pass and the quantize pass both
// stream the row with 16-byte vector loads when the row length allows; the
// second pass finds the row in L2 (a 7B row is at most 22 KB).  The block
// reduction is a warp-shuffle max, then one warp over the per-warp maxima.
// CUDA rather than Triton: the kernel shares the ctypes build of the other
// kernels, so it adds no second toolchain to the build.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long N, int vec) {
    constexpr int V = Vec<T>::n;
    __shared__ float red[kThreads / 32];
    const long long row = blockIdx.x;
    const T* xr = x + row * N;
    int8_t* qr = q + row * N;
    const long long nvec = vec ? N / V : 0;

    float amax = 0.f;
    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        float f[V];
        load_vec(xr + c * V, f);
#pragma unroll
        for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(f[k]));
    }
    for (long long i = nvec * V + threadIdx.x; i < N; i += kThreads)
        amax = fmaxf(amax, fabsf(to_f32(xr[i])));
    amax = block_max<kThreads>(amax, red);
    const float sc = quant_scale(amax);
    const float inv = quant_inv(sc);

    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        float f[V];
        load_vec(xr + c * V, f);
        typename Vec<T>::q_t packed;
        int8_t* pq = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
        for (int k = 0; k < V; ++k) pq[k] = quant_i8(f[k], inv);
        reinterpret_cast<typename Vec<T>::q_t*>(qr)[c] = packed;
    }
    for (long long i = nvec * V + threadIdx.x; i < N; i += kThreads)
        qr[i] = quant_i8(to_f32(xr[i]), inv);
    if (threadIdx.x == 0) s[row] = sc;
}

}  // namespace

// vec != 0 promises 16-byte aligned rows of x (and 16 / sizeof(T)-aligned
// rows of q): the wrapper sets it when N * sizeof(T) % 16 == 0.
extern "C" int tl_quantize_rows(const void* x, int x_dtype, int8_t* q, float* s,
                                long long M, long long N, int vec, void* stream) {
    if (M <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_dtype == TL_F32) {
        quantize_rows_kernel<float><<<dim3(M), kThreads, 0, st>>>(
            static_cast<const float*>(x), q, s, N, vec);
    } else if (x_dtype == TL_BF16) {
        quantize_rows_kernel<__nv_bfloat16><<<dim3(M), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), q, s, N, vec);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
