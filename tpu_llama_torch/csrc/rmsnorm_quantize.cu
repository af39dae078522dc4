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
// 15 us at 3.35 TB/s, at ~5 operations per byte.  Design: one block per row
// reads x from device memory once, with 16-byte loads, and keeps the row as
// f32 in shared memory (the first kCapFloats values; a longer row re-reads
// its tail, from L2); a block reduction of the f64 sum of squares; a second
// pass over shared memory for the absmax of xf; a third that recomputes xf
// and writes the int8 row.  w (8 KB at 7B) stays in L1/L2 across rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCapFloats = 11264;  // 44 KB: under the 48 KB a block gets without opting in

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quantize_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        int8_t* __restrict__ q, float* __restrict__ s, long long N,
                        int cap, int vec) {
    constexpr int V = Vec<T>::n;
    extern __shared__ float xs[];  // [cap]: the row as f32
    __shared__ double dred[kThreads / 32];
    __shared__ float fred[kThreads / 32];
    const long long row = blockIdx.x;
    const T* xr = x + row * N;
    int8_t* qr = q + row * N;
    const long long nvec = vec ? N / V : 0;

    double ss = 0.0;
    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        float f[V];
        load_vec(xr + c * V, f);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (c * V + k < cap) xs[c * V + k] = f[k];
            ss += static_cast<double>(f[k]) * static_cast<double>(f[k]);
        }
    }
    for (long long i = nvec * V + threadIdx.x; i < N; i += kThreads) {
        const float f = to_f32(xr[i]);
        if (i < cap) xs[i] = f;
        ss += static_cast<double>(f) * static_cast<double>(f);
    }
    ss = block_sum<kThreads>(ss, dred);  // its barrier also publishes xs

    const float r = rms_factor(ss, N);
    auto xf = [&](long long i) {
        const float xi = i < cap ? xs[i] : to_f32(xr[i]);
        return __fmul_rn(__fmul_rn(xi, r), to_f32(w[i]));
    };

    float amax = 0.f;
    for (long long i = threadIdx.x; i < N; i += kThreads) amax = fmaxf(amax, fabsf(xf(i)));
    amax = block_max<kThreads>(amax, fred);
    const float sc = quant_scale(amax);
    const float inv = quant_inv(sc);
    for (long long i = threadIdx.x; i < N; i += kThreads) qr[i] = quant_i8(xf(i), inv);
    if (threadIdx.x == 0) s[row] = sc;
}

template <typename T, typename W>
int launch(const void* x, const void* w, int8_t* q, float* s, long long M, long long N,
           int vec, cudaStream_t st) {
    const int cap = static_cast<int>(N < kCapFloats ? N : kCapFloats);
    rmsnorm_quantize_kernel<T, W><<<dim3(M), kThreads, cap * sizeof(float), st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), q, s, N, cap, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec != 0 promises 16-byte aligned rows of x: the wrapper sets it when
// N * sizeof(T) % 16 == 0 and x is 16-byte aligned.
extern "C" int tl_rmsnorm_quantize(const void* x, int x_dtype, const void* w, int w_dtype,
                                   int8_t* q, float* s, long long M, long long N, int vec,
                                   void* stream) {
    if (M <= 0 || N <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using bf = __nv_bfloat16;
    if (x_dtype == TL_F32 && w_dtype == TL_F32) return launch<float, float>(x, w, q, s, M, N, vec, st);
    if (x_dtype == TL_F32 && w_dtype == TL_BF16) return launch<float, bf>(x, w, q, s, M, N, vec, st);
    if (x_dtype == TL_BF16 && w_dtype == TL_F32) return launch<bf, float>(x, w, q, s, M, N, vec, st);
    if (x_dtype == TL_BF16 && w_dtype == TL_BF16) return launch<bf, bf>(x, w, q, s, M, N, vec, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
