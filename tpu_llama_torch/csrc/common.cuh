// Shared helpers for the port's hand-written Hopper kernels.
//
// Every source in this directory compiles on its own (one nvcc per file)
// into a shared library with a plain C interface that
// tpu_llama_torch/ops/_kernels.py loads through ctypes.  Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Built WITHOUT --use_fast_math: the kernels rely on IEEE division for the
// quant scales (absmax / 127, 1 / s), on rintf's round-half-to-even and on
// an accurate expf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, kept in step with _DTYPE_CODES in ops/_kernels.py
enum TlDtype : int { TL_F32 = 0, TL_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

extern "C" const char* tl_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
