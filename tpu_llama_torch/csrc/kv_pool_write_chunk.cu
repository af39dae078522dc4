// K17: land one prefill chunk's INT8 K/V rows and their f32 scales in each
// slot's page of one layer of the page pool, in place.
//
// Replaces tpu_llama/ops/attention.py:2189 kv_pool_write_chunk.  For slot b
// with page = page_table[b, start[b] / ps] and r = start[b] % ps:
//   ck[layer, page, h, r + t, :] = rk[b, h, t, :]   for t < Tc (and v)
//   cks[layer, page, h, r + t]   = rks[b, h, t]      (and vs)
// rk/rv int8 [B, KVH, Tc, hd], rks/rvs f32 [B, KVH, Tc], ck/cv int8
// [L, P, KVH, ps, hd], cks/cvs f32 [L, P, KVH, ps], page_table int32
// [B, MP] (the admitted slots' rows), start int32 [B] (device).  A start
// whose page column lies past the table writes to the trash page 0
// (attention.py:2231-2238), as does a table entry of an unreserved column
// (0); a negative start, or a page id outside [0, P), writes nothing.  The
// wrapper checks on the host that ps % Tc == 0, and start % Tc == 0 for
// host starts (a device start's caller checks it), so a chunk never
// crosses a page; the kernel skips one that would.  The TPU
// kernel's Tc % 128 rule and row split were Mosaic layout rules.  Distinct
// live slots hold distinct pages; several slots' rows past their
// reservations all land on page 0, in no set order, as in K14 and K15.
//
// Bound on the H100: bytes (a pure copy).  At a 7B admission wave (B 16,
// KVH 32, Tc 256, hd 128): 2 x 16.8 MB of int8 and 2 x 0.52 MB of scales,
// each read once and written once, 69.2 MB, 20.7 us at 3.35 TB/s.  Design:
// K18's (kv_write_chunk.cu) with a page-table destination: the Tc rows of
// one (slot, head) are contiguous in the chunk and in the page, so each is
// one run of Tc * hd bytes; grid (row tile, kv head, slot), each block
// copying kRows rows of K and V with 16-byte vectors when hd allows, and
// their scales in the same launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows of one (slot, head) per block

__global__ void __launch_bounds__(kThreads)
kv_pool_write_chunk_kernel(const int8_t* __restrict__ rk, const int8_t* __restrict__ rv,
                           const float* __restrict__ rks, const float* __restrict__ rvs,
                           const int* __restrict__ start, const int* __restrict__ page_table,
                           int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                           float* __restrict__ cks, float* __restrict__ cvs, int KVH, int Tc,
                           int P, int ps, int MP, int hd, int layer, int vec) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int r0 = blockIdx.x * kRows;
    const int nr = min(kRows, Tc - r0);
    const int st = start[b];
    if (nr <= 0 || st < 0) return;
    const int col = st / ps;
    const int page = col < MP ? page_table[(long long)b * MP + col] : 0;  // past the table: trash
    const int off = st % ps;
    if (page < 0 || page >= P || off + Tc > ps) return;
    const long long src = ((long long)b * KVH + h) * Tc + r0;                      // first row
    const long long dst = (((long long)layer * P + page) * KVH + h) * ps + off + r0;
    if (vec) {
        const long long n16 = (long long)nr * hd / 16;
        const uint4* sk = reinterpret_cast<const uint4*>(rk + src * hd);
        const uint4* sv = reinterpret_cast<const uint4*>(rv + src * hd);
        uint4* dk = reinterpret_cast<uint4*>(ck + dst * hd);
        uint4* dv = reinterpret_cast<uint4*>(cv + dst * hd);
        for (long long e = threadIdx.x; e < n16; e += kThreads) {
            dk[e] = sk[e];
            dv[e] = sv[e];
        }
    } else {
        const long long n1 = (long long)nr * hd;
        for (long long e = threadIdx.x; e < n1; e += kThreads) {
            ck[dst * hd + e] = rk[src * hd + e];
            cv[dst * hd + e] = rv[src * hd + e];
        }
    }
    for (int r = threadIdx.x; r < nr; r += kThreads) {
        cks[dst + r] = rks[src + r];
        cvs[dst + r] = rvs[src + r];
    }
}

}  // namespace

// vec != 0 promises hd % 16 == 0 and 16-byte aligned row and pool pointers.
extern "C" int tl_kv_pool_write_chunk(const int8_t* rk, const int8_t* rv, const float* rks,
                                      const float* rvs, const int* start, const int* page_table,
                                      int8_t* ck, int8_t* cv, float* cks, float* cvs, int B,
                                      int KVH, int Tc, int hd, int P, int ps, int MP, int layer,
                                      int vec, void* stream) {
    if (B <= 0 || KVH <= 0 || Tc <= 0) return 0;
    if (P < 1 || ps < 1 || MP < 1) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(static_cast<unsigned>((Tc + kRows - 1) / kRows), KVH, B);
    kv_pool_write_chunk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rk, rv, rks, rvs, start, page_table, ck, cv, cks, cvs, KVH, Tc, P, ps, MP, hd, layer, vec);
    return static_cast<int>(cudaGetLastError());
}
