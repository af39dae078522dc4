// K4: fused SwiGLU gate (silu(gate) * up) + per-row INT8 quantization.
//
// Replaces tpu_llama/ops/quant.py:396 silu_mul_quantize_pallas (its Pallas
// kernel _silu_mul_quant_kernel, quant.py:384).  gate, up [M, H] (f32 or
// bf16), each row `ld` elements after the last -- the two column halves of
// the fused w13 product [M, 2H] are read where they lie, without a copy --
// -> q int8 [M, H], s f32 [M]:
//   p_i = (g_i * sigmoid(g_i)) * u_i,  sigmoid(g) = 1 / (1 + exp(-g)),
// then the row quant of common.cuh.
//
// Numerics kept from the TPU kernel, and why: p is quantized from f32
// (quant.py:387-388), never rounded to the activation dtype, as the JAX
// package's fused prefill defines it; the scale is absmax * f32(1/127),
// XLA's form of the Pallas body's absmax / 127 (common.cuh), so the bytes
// stay the JAX package's.  sigmoid is PyTorch's formula with CUDA's expf
// (no fast math) and each product and sum an explicit round-to-nearest
// intrinsic, so the kernel repeats the plain version's arithmetic
// (ops/quant.py) step for step.
//
// Bound on the H100: bytes.  At the 7B prefill shape, gate and up bf16
// [4096, 11008] each, the pass must read 180 MB and write 45 MB of int8 +
// 16 KB of scales: 67 us at 3.35 TB/s.  Design: one block per row reads g
// and u from device memory once, with 16-byte loads, computes p once and
// keeps it in shared memory (the first kCapFloats values: all of a 7B row;
// a longer row recomputes its tail from L2), reduces the absmax, then
// quantizes from shared memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCapFloats = 11264;  // 44 KB: under the 48 KB a block gets without opting in

__device__ __forceinline__ float silu_mul(float g, float u) {
    const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-g)));
    return __fmul_rn(__fmul_rn(g, sig), u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
silu_mul_quantize_kernel(const T* __restrict__ g, const T* __restrict__ u, long long ld,
                         int8_t* __restrict__ q, float* __restrict__ s, long long H, int cap,
                         int vec) {
    constexpr int V = Vec<T>::n;
    extern __shared__ float ps[];  // [cap]: p as f32
    __shared__ float red[kThreads / 32];
    const long long row = blockIdx.x;
    const T* gr = g + row * ld;
    const T* ur = u + row * ld;
    int8_t* qr = q + row * H;
    const long long nvec = vec ? H / V : 0;

    float amax = 0.f;
    for (long long c = threadIdx.x; c < nvec; c += kThreads) {
        float fg[V], fu[V];
        load_vec(gr + c * V, fg);
        load_vec(ur + c * V, fu);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const float p = silu_mul(fg[k], fu[k]);
            if (c * V + k < cap) ps[c * V + k] = p;
            amax = fmaxf(amax, fabsf(p));
        }
    }
    for (long long i = nvec * V + threadIdx.x; i < H; i += kThreads) {
        const float p = silu_mul(to_f32(gr[i]), to_f32(ur[i]));
        if (i < cap) ps[i] = p;
        amax = fmaxf(amax, fabsf(p));
    }
    amax = block_max<kThreads>(amax, red);  // its barrier also publishes ps
    const float sc = quant_scale(amax);
    const float inv = quant_inv(sc);
    for (long long i = threadIdx.x; i < H; i += kThreads) {
        const float p = i < cap ? ps[i] : silu_mul(to_f32(gr[i]), to_f32(ur[i]));
        qr[i] = quant_i8(p, inv);
    }
    if (threadIdx.x == 0) s[row] = sc;
}

template <typename T>
int launch(const void* g, const void* u, long long ld, int8_t* q, float* s, long long M,
           long long H, int vec, cudaStream_t st) {
    const int cap = static_cast<int>(H < kCapFloats ? H : kCapFloats);
    silu_mul_quantize_kernel<T><<<dim3(M), kThreads, cap * sizeof(float), st>>>(
        static_cast<const T*>(g), static_cast<const T*>(u), ld, q, s, H, cap, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec != 0 promises 16-byte aligned rows of gate and up: the wrapper sets
// it when H * sizeof(T) and ld * sizeof(T) are multiples of 16 and both
// pointers are 16-byte aligned.
extern "C" int tl_silu_mul_quantize(const void* g, const void* u, int dtype, long long ld,
                                    int8_t* q, float* s, long long M, long long H, int vec,
                                    void* stream) {
    if (M <= 0 || H <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == TL_F32) return launch<float>(g, u, ld, q, s, M, H, vec, st);
    if (dtype == TL_BF16) return launch<__nv_bfloat16>(g, u, ld, q, s, M, H, vec, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
