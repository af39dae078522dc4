// K10: write every layer's fresh K/V row (INT8 with its f32 scales, or f32
// or bf16) into the dense cache at each slot's position, in place, in one
// launch per decode step.
//
// Replaces tpu_llama/ops/attention.py:2470 kv_cache_flush_rows (its Pallas
// kernels _flush_kernel :2438 and _flush_scale_kernel :2456, two calls for
// an INT8 cache, the first alone for an fp one).
//   ck[l, b, h, pos[b], :] = rk[l, b, h, :]   (and v)
//   cks[l, b, h, pos[b]]   = rks[l, b, h]     (and vs; INT8 only)
// rk/rv [L, B, KVH, hd] and ck/cv [L, B, KVH, S, hd] of one element type T
// (int8, f32 or bf16), rks/rvs f32 [L, B, KVH] and cks/cvs f32
// [L, B, KVH, S] for an INT8 cache (null for an fp one), pos int32 [B] on
// the device.  A slot whose pos[b] lies outside [0, S) is SKIPPED, never
// written: in CUDA it would be a silent out-of-bounds write (the xla path's
// indexed write drops such a row too).
//
// Bound on the H100: bytes, and at the decode shape launch latency -- at
// Llama-2 7B, 32 layers x 8 slots x 32 heads x (2 * 128 + 8) B = 2.2 MB read
// and as much written for INT8 (4x and 2x the row bytes, no scales, for f32
// and bf16), 1.3 us at 3.35 TB/s.  Design: values and scales in one launch
// (the TPU needed two calls); one block per (slot, layer) copies its KVH
// rows of K and V with 16-byte vectors when a row's bytes allow, plus the
// scales; pos is read on the device, so the step needs no host sync.  One
// kernel templated on T serves the three cache types.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_flush_rows_kernel(const T* __restrict__ rk, const T* __restrict__ rv,
                     const float* __restrict__ rks, const float* __restrict__ rvs,
                     const int* __restrict__ pos, T* __restrict__ ck,
                     T* __restrict__ cv, float* __restrict__ cks, float* __restrict__ cvs,
                     int B, int KVH, int S, int hd, int vec) {
    const int b = blockIdx.x, l = blockIdx.y;
    const int p = pos[b];
    if (p < 0 || p >= S) return;  // out of range: never written
    const long long src0 = ((long long)l * B + b) * KVH;  // row (l, b, head 0)
    constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
    const int per_row = vec ? hd / V : hd;  // copy units per row
    for (int e = threadIdx.x; e < KVH * per_row; e += kThreads) {
        const int hh = e / per_row, u = e % per_row;
        const long long src = src0 + hh;
        const long long dst = src * S + p;
        if (vec) {
            reinterpret_cast<uint4*>(ck + dst * hd)[u] = reinterpret_cast<const uint4*>(rk + src * hd)[u];
            reinterpret_cast<uint4*>(cv + dst * hd)[u] = reinterpret_cast<const uint4*>(rv + src * hd)[u];
        } else {
            ck[dst * hd + u] = rk[src * hd + u];
            cv[dst * hd + u] = rv[src * hd + u];
        }
    }
    if (rks == nullptr) return;  // an fp cache has no scales
    for (int hh = threadIdx.x; hh < KVH; hh += kThreads) {
        const long long src = src0 + hh;
        cks[src * S + p] = rks[src];
        cvs[src * S + p] = rvs[src];
    }
}

template <typename T>
int launch(const void* rk, const void* rv, const float* rks, const float* rvs, const int* pos,
           void* ck, void* cv, float* cks, float* cvs, int L, int B, int KVH, int S, int hd,
           int vec, cudaStream_t st) {
    kv_flush_rows_kernel<T><<<dim3(B, L), kThreads, 0, st>>>(
        static_cast<const T*>(rk), static_cast<const T*>(rv), rks, rvs, pos, static_cast<T*>(ck),
        static_cast<T*>(cv), cks, cvs, B, KVH, S, hd, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: the element type of rk/rv/ck/cv (TL_I8, TL_F32 or TL_BF16); the
// scale pointers are non-null exactly for int8.  vec != 0 promises rows of
// a multiple of 16 bytes and 16-byte aligned row and cache pointers.
extern "C" int tl_kv_flush_rows(const void* rk, const void* rv, const float* rks,
                                const float* rvs, const int* pos, void* ck, void* cv, float* cks,
                                float* cvs, int kv_dtype, int L, int B, int KVH, int S, int hd,
                                int vec, void* stream) {
    if (L <= 0 || B <= 0) return 0;
    if ((kv_dtype == TL_I8) != (rks != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K10_ARGS rk, rv, rks, rvs, pos, ck, cv, cks, cvs, L, B, KVH, S, hd, vec, st
    if (kv_dtype == TL_I8) return launch<int8_t>(TL_K10_ARGS);
    if (kv_dtype == TL_F32) return launch<float>(TL_K10_ARGS);
    if (kv_dtype == TL_BF16) return launch<__nv_bfloat16>(TL_K10_ARGS);
#undef TL_K10_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
