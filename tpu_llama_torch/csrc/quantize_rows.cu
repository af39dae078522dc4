// K2: per-row dynamic symmetric INT8 quantization of activations.
//
// Replaces tpu_llama/ops/quant.py:275 quantize_activations_pallas.
// x [M, N] (f32 or bf16) -> q int8 [M, N], s f32 [M] with
//   s = absmax(row) * f32(1/127),  inv = s > 0 ? 1 / s : 0,
//   q = clip(rint(x * inv), -127, 127)        (rint: round half to even)
// -- the formula of quant.py:255-263 as XLA compiles it (see ops/quant.py):
// a multiply by the reciprocal, not a division, so the int8 bytes equal
// the JAX package's.
//
// Bound on the H100: bytes.  The pass reads each input once and writes one
// int8 per element (3 bytes per bf16 element, ~0.3 operations per byte).
// Design: one block per row.  The absmax pass and the quantize pass both
// stream the row with 16-byte vector loads when the row length allows; the
// second pass finds the row in L2 (a 7B row is at most 22 KB).  The block
// reduction is a warp-shuffle max, then one warp over the per-warp maxima.
// CUDA rather than Triton: the kernel shares the ctypes build of the other
// three kernels, so it adds no second toolchain to the build.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;  // 16-byte vector of T and its int8 image
template <>
struct Vec<float> {
    static constexpr int n = 4;
    using q_t = uint32_t;
};
template <>
struct Vec<__nv_bfloat16> {
    static constexpr int n = 8;
    using q_t = uint2;
};

template <typename T>
__device__ __forceinline__ int8_t quant1(T v, float inv) {
    float r = rintf(to_f32(v) * inv);
    return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long N, int vec) {
    constexpr int V = Vec<T>::n;
    const long long row = blockIdx.x;
    const T* xr = x + row * N;
    int8_t* qr = q + row * N;
    const long long nvec = vec ? N / V : 0;

    float amax = 0.f;
    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        uint4 raw = reinterpret_cast<const uint4*>(xr)[c];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(to_f32(e[k])));
    }
    for (long long i = nvec * V + threadIdx.x; i < N; i += kThreads)
        amax = fmaxf(amax, fabsf(to_f32(xr[i])));

    __shared__ float red[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    amax = warp_max(amax);
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    if (warp == 0) {
        float v = lane < kThreads / 32 ? red[lane] : 0.f;
        v = warp_max(v);
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    amax = red[0];

    // the JAX package computes absmax / 127 inside jit, where XLA rewrites
    // it as absmax * f32(1/127); the same product keeps the bytes equal
    const float sc = amax * (1.0f / 127.0f);
    const float inv = sc > 0.f ? 1.0f / sc : 0.f;

    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        uint4 raw = reinterpret_cast<const uint4*>(xr)[c];
        const T* e = reinterpret_cast<const T*>(&raw);
        typename Vec<T>::q_t packed;
        int8_t* pq = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
        for (int k = 0; k < V; ++k) pq[k] = quant1(e[k], inv);
        reinterpret_cast<typename Vec<T>::q_t*>(qr)[c] = packed;
    }
    for (long long i = nvec * V + threadIdx.x; i < N; i += kThreads) qr[i] = quant1(xr[i], inv);
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
