// K7: write a compact prefilled INT8 K/V block into chosen slots of the
// dense cache, in place.
//
// Replaces tpu_llama/ops/attention.py:1212 kv_cache_scatter_slots.
//   ck[l, slots[i], h, t, :] = sk[l, i, h, t, :]   for t < T (and v)
//   cks[l, slots[i], h, t]   = sks[l, i, h, t]      (and vs)
// sk/sv int8 [L, n, KVH, T, hd], sks/svs f32 [L, n, KVH, T], slots int32
// [n] on the device, ck/cv int8 [L, B, KVH, S, hd], cks/cvs f32
// [L, B, KVH, S].  The wrapper checks 0 <= slots < B, distinct slots and
// T <= S before the launch: an out-of-range slot would be a silent
// out-of-bounds write.
//
// Bound on the H100: bytes (a pure copy).  Design: grid (row chunks, n, L);
// each block copies kRows (head, position) rows of K and V with 16-byte
// vectors when hd allows, plus their scales.  Each row is contiguous in
// both the block and the cache, so reads and writes are coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // (head, position) rows per block

__global__ void __launch_bounds__(kThreads)
kv_scatter_kernel(const int8_t* __restrict__ sk, const int8_t* __restrict__ sv,
                  const float* __restrict__ sks, const float* __restrict__ svs,
                  const int* __restrict__ slots, int8_t* __restrict__ ck,
                  int8_t* __restrict__ cv, float* __restrict__ cks, float* __restrict__ cvs,
                  int n, int KVH, int T, int hd, int B, int S, int vec) {
    const int l = blockIdx.z, i = blockIdx.y;
    const long long rows = (long long)KVH * T;
    const long long rbeg = (long long)blockIdx.x * kRows;
    const long long rcnt = min((long long)kRows, rows - rbeg);
    if (rcnt <= 0) return;
    const long long src0 = ((long long)l * n + i) * rows;          // first source row
    const long long dst_slot = ((long long)l * B + slots[i]) * KVH;  // (l, slot, head 0)

    const int per_row = vec ? hd / 16 : hd;  // copy units per row
    for (long long e = threadIdx.x; e < rcnt * per_row; e += kThreads) {
        const long long rr = rbeg + e / per_row;
        const int u = static_cast<int>(e % per_row);
        const int hh = static_cast<int>(rr / T), t = static_cast<int>(rr % T);
        const long long src = src0 + rr;
        const long long dst = (dst_slot + hh) * S + t;
        if (vec) {
            reinterpret_cast<uint4*>(ck + dst * hd)[u] =
                reinterpret_cast<const uint4*>(sk + src * hd)[u];
            reinterpret_cast<uint4*>(cv + dst * hd)[u] =
                reinterpret_cast<const uint4*>(sv + src * hd)[u];
        } else {
            ck[dst * hd + u] = sk[src * hd + u];
            cv[dst * hd + u] = sv[src * hd + u];
        }
    }
    for (long long e = threadIdx.x; e < rcnt; e += kThreads) {
        const long long rr = rbeg + e;
        const int hh = static_cast<int>(rr / T), t = static_cast<int>(rr % T);
        const long long dst = (dst_slot + hh) * S + t;
        cks[dst] = sks[src0 + rr];
        cvs[dst] = svs[src0 + rr];
    }
}

}  // namespace

// vec != 0 promises hd % 16 == 0 and 16-byte aligned K/V pointers.
extern "C" int tl_kv_scatter_slots(const int8_t* sk, const int8_t* sv, const float* sks,
                                   const float* svs, const int* slots, int8_t* ck, int8_t* cv,
                                   float* cks, float* cvs, int L, int n, int KVH, int T, int hd,
                                   int B, int S, int vec, void* stream) {
    if (L <= 0 || n <= 0 || T <= 0) return 0;
    const long long rows = (long long)KVH * T;
    dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), n, L);
    kv_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        sk, sv, sks, svs, slots, ck, cv, cks, cvs, n, KVH, T, hd, B, S, vec);
    return static_cast<int>(cudaGetLastError());
}
