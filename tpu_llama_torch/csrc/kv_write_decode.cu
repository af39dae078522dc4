// K28: write one decode step's K/V row of one layer into the dense cache at
// each slot's position, in place; an INT8 cache quantizes the row in the
// kernel.
//
// Replaces tpu_llama/ops/attention.py:2345 kv_cache_write_decode (its
// Pallas kernel _kv_write_kernel, attention.py:2293).
//   ck[layer, b, h, pos[b], :] = quant or cast of k[b, h, :]   (and v)
//   cks[layer, b, h, pos[b]]   = its scale                      (INT8 only)
// k, v f32 [B, KVH, hd] (the JAX function casts them to f32 first); ck, cv
// [L, B, KVH, S, hd] of one element type T (int8, f32 or bf16), cks, cvs
// f32 [L, B, KVH, S] for an INT8 cache (null for an fp one); pos int32 [B]
// on the device.  INT8: the per-row quant of the JAX kernel as XLA
// compiles it inside jit -- s = absmax * f32(1/127), inv = s > 0 ? 1 / s :
// 0, q = clip(rint(x * inv), -127, 127) (common.cuh quant_*; a zero row
// gets scale 0 and zeros); fp: the value rounded to T (ties to even).  JAX
// leaves a pos outside [0, S) undefined; here such a slot is SKIPPED, as
// K10 skips it (kv_flush_rows.cu).
//
// Bound on the H100: bytes, and at decode shapes launch latency -- at
// Llama-2 7B batch 8, 8 x 32 x 2 rows of 128 f32 read and as many int8
// rows (plus scales) written: 0.33 MB, 0.1 us at 3.35 TB/s.  Design: one
// block per slot, one warp per (head, K or V) row, the row's absmax a warp
// reduction.  One kernel templated on T serves the three cache types.  No
// path of the port or of the JAX package's models calls it (the JAX
// package's only caller is tools/kernel_bench.py); it is held to its plain
// version and to the JAX function.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ void put_row(const float* __restrict__ x, T* __restrict__ dst,
                                        float* scale, int hd) {
    const int lane = threadIdx.x & 31;
    if constexpr (sizeof(T) == 1) {
        float amax = 0.f;
        for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(x[d]));
        const float s = quant_scale(warp_max(amax));
        const float inv = quant_inv(s);
        for (int d = lane; d < hd; d += 32) dst[d] = quant_i8(x[d], inv);
        if (lane == 0) *scale = s;
    } else {
        for (int d = lane; d < hd; d += 32) store_as(dst + d, x[d]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_write_decode_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       const int* __restrict__ pos, T* __restrict__ ck, T* __restrict__ cv,
                       float* __restrict__ cks, float* __restrict__ cvs, int layer, int B,
                       int KVH, int S, int hd) {
    const int b = blockIdx.x;
    const int p = pos[b];
    if (p < 0 || p >= S) return;  // out of range: never written
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < 2 * KVH; r += kThreads / 32) {
        const int h = r >> 1;
        const long long src = (long long)b * KVH + h;                      // row (b, h)
        const long long dst = (((long long)layer * B + b) * KVH + h) * S + p;  // (layer, b, h, p)
        if (r & 1)
            put_row(v + src * hd, cv + dst * hd, cvs ? cvs + dst : nullptr, hd);
        else
            put_row(k + src * hd, ck + dst * hd, cks ? cks + dst : nullptr, hd);
    }
}

template <typename T>
int launch(const float* k, const float* v, const int* pos, void* ck, void* cv, float* cks,
           float* cvs, int layer, int B, int KVH, int S, int hd, cudaStream_t st) {
    kv_write_decode_kernel<T><<<B, kThreads, 0, st>>>(k, v, pos, static_cast<T*>(ck),
                                                      static_cast<T*>(cv), cks, cvs, layer, B,
                                                      KVH, S, hd);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: the element type of ck/cv (TL_I8, TL_F32 or TL_BF16); the scale
// pointers are non-null exactly for int8.  0 <= layer < L, checked by the
// wrapper.
extern "C" int tl_kv_write_decode(const float* k, const float* v, const int* pos, void* ck,
                                  void* cv, float* cks, float* cvs, int kv_dtype, int layer,
                                  int B, int KVH, int S, int hd, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if ((kv_dtype == TL_I8) != (cks != nullptr) || hd < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K28_ARGS k, v, pos, ck, cv, cks, cvs, layer, B, KVH, S, hd, st
    if (kv_dtype == TL_I8) return launch<int8_t>(TL_K28_ARGS);
    if (kv_dtype == TL_F32) return launch<float>(TL_K28_ARGS);
    if (kv_dtype == TL_BF16) return launch<__nv_bfloat16>(TL_K28_ARGS);
#undef TL_K28_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
