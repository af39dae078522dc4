// K15: write a compact prefilled INT8 K/V block into the page pool, whole
// pages at a time through the page table, in place.
//
// Replaces tpu_llama/ops/attention.py:1095 kv_pool_scatter_pages (its
// Pallas kernel on the grid (L, n, pages x sub-blocks)).  For layer l, block
// slot i and page j < npg = ceil(T / ps):
//   page = page_table[slots[i], j]
//   ck[l, page, h, r, :] = sk[l, i, h, j * ps + r, :]  if j * ps + r < T, else 0
//   cks[l, page, h, r]   = sks[l, i, h, j * ps + r]     if j * ps + r < T, else 0
// (and v, vs).  The JAX function pads T up to a page multiple with zeros and
// writes whole pages, so the rows past T in a slot's last page hold int8 0
// with scale 0: so do they here, and the pool equals the JAX package's
// outside the trash page.  A page past the slot's reservation is 0 in the
// table, the trash page (attention.py:1116-1120); cells of several slots
// may write it at once, a benign race on rows nobody reads.  sk/sv int8
// [L, n, KVH, T, hd], sks/svs f32 [L, n, KVH, T], slots int32 [n] and
// page_table int32 [B, MP] on the device; pools ck/cv int8
// [L, P, KVH, ps, hd], cks/cvs f32 [L, P, KVH, ps].  The wrapper checks
// 0 <= slots < B, distinct slots and T <= MP * ps; a page id outside
// [0, P) is SKIPPED (never written) -- it would be a silent out-of-bounds
// write.
//
// Bound on the H100: bytes (a pure copy): at a 7B 8 x 512 admission with
// ps 512, 32 layers x 8 slots x 32 heads x 512 rows x (2 * 128 + 8) B =
// 1.1 GB read and as much written, 0.66 ms at 3.35 TB/s.  Design: K7's
// (kv_scatter.cu) with the destination looked up per page: grid (row
// chunks of a page, n x npg, L); each block copies kRows (head, row) rows
// of one page of K and V with 16-byte vectors when a row's bytes allow,
// plus their scales; reads and writes are coalesced row runs.  Row offsets
// in 64-bit arithmetic (one pool array at 7B is past 2^31 bytes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // (head, row) rows of a page per block

__global__ void __launch_bounds__(kThreads)
kv_pool_scatter_kernel(const int8_t* __restrict__ sk, const int8_t* __restrict__ sv,
                       const float* __restrict__ sks, const float* __restrict__ svs,
                       const int* __restrict__ slots, const int* __restrict__ page_table,
                       int8_t* __restrict__ ck, int8_t* __restrict__ cv, float* __restrict__ cks,
                       float* __restrict__ cvs, int n, int KVH, int T, int hd, int P, int ps,
                       int MP, int npg, int vec) {
    const int l = blockIdx.z, i = blockIdx.y / npg, j = blockIdx.y % npg;
    const long long rows = (long long)KVH * ps;  // (head, row) rows of one page
    const long long rbeg = (long long)blockIdx.x * kRows;
    const long long rcnt = min((long long)kRows, rows - rbeg);
    if (rcnt <= 0) return;
    const int page = page_table[(long long)slots[i] * MP + j];
    if (page < 0 || page >= P) return;  // a bad table entry: never written
    const long long src0 = ((long long)l * n + i) * KVH * T;     // (l, i, head 0, t 0)
    const long long dst0 = ((long long)l * P + page) * KVH * ps;  // (l, page, head 0, row 0)
    const int t0 = j * ps;
    const int per_row = vec ? hd / 16 : hd;  // copy units per row
    for (long long e = threadIdx.x; e < rcnt * per_row; e += kThreads) {
        const long long rr = rbeg + e / per_row;
        const int u = static_cast<int>(e % per_row);
        const int hh = static_cast<int>(rr / ps), r = static_cast<int>(rr % ps);
        const int t = t0 + r;
        const long long dst = dst0 + rr;
        const long long src = src0 + (long long)hh * T + t;
        if (vec) {
            uint4 kz = make_uint4(0, 0, 0, 0), vz = kz;
            if (t < T) {
                kz = reinterpret_cast<const uint4*>(sk + src * hd)[u];
                vz = reinterpret_cast<const uint4*>(sv + src * hd)[u];
            }
            reinterpret_cast<uint4*>(ck + dst * hd)[u] = kz;
            reinterpret_cast<uint4*>(cv + dst * hd)[u] = vz;
        } else {
            ck[dst * hd + u] = t < T ? sk[src * hd + u] : int8_t(0);
            cv[dst * hd + u] = t < T ? sv[src * hd + u] : int8_t(0);
        }
    }
    for (long long e = threadIdx.x; e < rcnt; e += kThreads) {
        const long long rr = rbeg + e;
        const int hh = static_cast<int>(rr / ps), t = t0 + static_cast<int>(rr % ps);
        const long long src = src0 + (long long)hh * T + t;
        cks[dst0 + rr] = t < T ? sks[src] : 0.f;
        cvs[dst0 + rr] = t < T ? svs[src] : 0.f;
    }
}

}  // namespace

// vec != 0 promises rows of a multiple of 16 bytes and 16-byte aligned K/V
// pointers.
extern "C" int tl_kv_pool_scatter(const void* sk, const void* sv, const float* sks,
                                  const float* svs, const int* slots, const int* page_table,
                                  void* ck, void* cv, float* cks, float* cvs, int L, int n,
                                  int KVH, int T, int hd, int P, int ps, int MP, int vec,
                                  void* stream) {
    if (L <= 0 || n <= 0 || T <= 0) return 0;
    if (ps < 1 || MP < 1 || P < 1 || T > (long long)MP * ps)
        return static_cast<int>(cudaErrorInvalidValue);
    const int npg = (T + ps - 1) / ps;
    const long long rows = (long long)KVH * ps;
    dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), n * npg, L);
    kv_pool_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(sk), static_cast<const int8_t*>(sv), sks, svs, slots,
        page_table, static_cast<int8_t*>(ck), static_cast<int8_t*>(cv), cks, cvs, n, KVH, T, hd, P,
        ps, MP, npg, vec);
    return static_cast<int>(cudaGetLastError());
}
