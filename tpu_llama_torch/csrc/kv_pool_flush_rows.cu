// K14: write every layer's fresh INT8 K/V row and its scales into each
// slot's page of the pool, in place, in one launch per decode step.
//
// Replaces tpu_llama/ops/attention.py:1301 kv_pool_flush_rows (its two
// Pallas calls, values and scales, on the grid (L, B)).
//   page = pos[b] / ps < MP ? page_table[b, pos[b] / ps] : 0,  row = pos[b] % ps
//   ck[l, page, h, row, :] = rk[l, b, h, :]   (and v)
//   cks[l, page, h, row]   = rks[l, b, h]     (and vs)
// rk/rv int8 [L, B, KVH, hd], rks/rvs f32 [L, B, KVH], pos int32 [B] and
// page_table int32 [B, MP] on the device; the pools ck/cv int8
// [L, P, KVH, ps, hd] and cks/cvs f32 [L, P, KVH, ps].  A position past the
// slot's table (pos >= MP * ps) goes to the trash page 0, as in the JAX
// package (attention.py:1324-1330): a parked slot (table row all 0) lands
// there too.  Two cases the JAX package leaves undefined are defined here,
// because in CUDA either would be a silent out-of-bounds write into the
// pool: a negative pos, and a page id outside [0, P), are SKIPPED (never
// written).
//
// Bound on the H100: bytes, and at the decode shape launch latency -- at
// Llama-2 7B, 32 layers x 8 slots x 32 heads x (2 * 128 + 8) B = 2.2 MB
// read and as much written, 1.3 us at 3.35 TB/s.  Design: K10's
// (kv_flush_rows.cu) with the row address looked up in the page table:
// values and scales in one launch (the TPU needed two), one block per
// (slot, layer) copies its KVH rows of K and V with 16-byte vectors when a
// row's bytes allow, plus the scales; pos and the table are read on the
// device, so the step needs no host sync.  Row offsets in 64-bit
// arithmetic (one pool array at 7B is past 2^31 bytes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kv_pool_flush_rows_kernel(const int8_t* __restrict__ rk, const int8_t* __restrict__ rv,
                          const float* __restrict__ rks, const float* __restrict__ rvs,
                          const int* __restrict__ pos, const int* __restrict__ page_table,
                          int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                          float* __restrict__ cks, float* __restrict__ cvs, int B, int KVH,
                          int P, int ps, int MP, int hd, int vec) {
    const int b = blockIdx.x, l = blockIdx.y;
    const int p = pos[b];
    if (p < 0) return;  // undefined in the JAX package: never written
    const int col = p / ps;
    const int page = col < MP ? page_table[(long long)b * MP + col] : 0;  // past the table: trash
    if (page < 0 || page >= P) return;  // a bad table entry: never written
    const long long src0 = ((long long)l * B + b) * KVH;            // row (l, b, head 0)
    const long long dst0 = ((long long)l * P + page) * KVH * ps + p % ps;  // (l, page, head 0, row)
    const int per_row = vec ? hd / 16 : hd;  // copy units per row
    for (int e = threadIdx.x; e < KVH * per_row; e += kThreads) {
        const int hh = e / per_row, u = e % per_row;
        const long long src = src0 + hh;
        const long long dst = dst0 + (long long)hh * ps;
        if (vec) {
            reinterpret_cast<uint4*>(ck + dst * hd)[u] = reinterpret_cast<const uint4*>(rk + src * hd)[u];
            reinterpret_cast<uint4*>(cv + dst * hd)[u] = reinterpret_cast<const uint4*>(rv + src * hd)[u];
        } else {
            ck[dst * hd + u] = rk[src * hd + u];
            cv[dst * hd + u] = rv[src * hd + u];
        }
    }
    for (int hh = threadIdx.x; hh < KVH; hh += kThreads) {
        const long long dst = dst0 + (long long)hh * ps;
        cks[dst] = rks[src0 + hh];
        cvs[dst] = rvs[src0 + hh];
    }
}

}  // namespace

// vec != 0 promises rows of a multiple of 16 bytes and 16-byte aligned row
// and pool pointers.
extern "C" int tl_kv_pool_flush_rows(const void* rk, const void* rv, const float* rks,
                                     const float* rvs, const int* pos, const int* page_table,
                                     void* ck, void* cv, float* cks, float* cvs, int L, int B,
                                     int KVH, int P, int ps, int MP, int hd, int vec,
                                     void* stream) {
    if (L <= 0 || B <= 0) return 0;
    if (ps < 1 || MP < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
    kv_pool_flush_rows_kernel<<<dim3(B, L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(rk), static_cast<const int8_t*>(rv), rks, rvs, pos, page_table,
        static_cast<int8_t*>(ck), static_cast<int8_t*>(cv), cks, cvs, B, KVH, P, ps, MP, hd, vec);
    return static_cast<int>(cudaGetLastError());
}
