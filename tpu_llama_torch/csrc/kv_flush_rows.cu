// K10: write every layer's fresh INT8 K/V row and its f32 scales into the
// dense cache at each slot's position, in place, in one launch per decode
// step.
//
// Replaces tpu_llama/ops/attention.py:2470 kv_cache_flush_rows (its Pallas
// kernels _flush_kernel :2438 and _flush_scale_kernel :2456, two calls).
//   ck[l, b, h, pos[b], :] = rk[l, b, h, :]   (and v)
//   cks[l, b, h, pos[b]]   = rks[l, b, h]     (and vs)
// rk/rv int8 [L, B, KVH, hd], rks/rvs f32 [L, B, KVH], pos int32 [B] on the
// device, ck/cv int8 [L, B, KVH, S, hd], cks/cvs f32 [L, B, KVH, S].  A slot
// whose pos[b] lies outside [0, S) is SKIPPED, never written: in CUDA it
// would be a silent out-of-bounds write (the xla path's indexed write drops
// such a row too).
//
// Bound on the H100: bytes, and at the decode shape launch latency -- at
// Llama-2 7B, 32 layers x 8 slots x 32 heads x (2 * 128 + 8) B = 2.2 MB read
// and as much written, 1.3 us at 3.35 TB/s.  Design: values and scales in
// one launch (the TPU needed two calls); one block per (slot, layer) copies
// its KVH rows of K and V with 16-byte vectors when hd allows, plus the
// scales; pos is read on the device, so the step needs no host sync.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kv_flush_rows_kernel(const int8_t* __restrict__ rk, const int8_t* __restrict__ rv,
                     const float* __restrict__ rks, const float* __restrict__ rvs,
                     const int* __restrict__ pos, int8_t* __restrict__ ck,
                     int8_t* __restrict__ cv, float* __restrict__ cks, float* __restrict__ cvs,
                     int B, int KVH, int S, int hd, int vec) {
    const int b = blockIdx.x, l = blockIdx.y;
    const int p = pos[b];
    if (p < 0 || p >= S) return;  // out of range: never written
    const long long src0 = ((long long)l * B + b) * KVH;  // row (l, b, head 0)
    const int per_row = vec ? hd / 16 : hd;  // copy units per row
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
    for (int hh = threadIdx.x; hh < KVH; hh += kThreads) {
        const long long src = src0 + hh;
        cks[src * S + p] = rks[src];
        cvs[src * S + p] = rvs[src];
    }
}

}  // namespace

// vec != 0 promises hd % 16 == 0 and 16-byte aligned row and cache pointers.
extern "C" int tl_kv_flush_rows(const int8_t* rk, const int8_t* rv, const float* rks,
                                const float* rvs, const int* pos, int8_t* ck, int8_t* cv,
                                float* cks, float* cvs, int L, int B, int KVH, int S, int hd,
                                int vec, void* stream) {
    if (L <= 0 || B <= 0) return 0;
    kv_flush_rows_kernel<<<dim3(B, L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rk, rv, rks, rvs, pos, ck, cv, cks, cvs, B, KVH, S, hd, vec);
    return static_cast<int>(cudaGetLastError());
}
