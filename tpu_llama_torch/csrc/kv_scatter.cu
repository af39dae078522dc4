// K7: write a compact prefilled K/V block (INT8 with f32 scales, or f32 or
// bf16) into chosen slots of the dense cache, in place.
//
// Replaces tpu_llama/ops/attention.py:1212 kv_cache_scatter_slots (both its
// INT8 kernel and its fp kernel kern_fp, attention.py:1279-1298).
//   ck[l, slots[i], h, t, :] = sk[l, i, h, t, :]   for t < T (and v)
//   cks[l, slots[i], h, t]   = sks[l, i, h, t]      (and vs; INT8 only)
// sk/sv [L, n, KVH, T, hd] and ck/cv [L, B, KVH, S, hd] of one element type
// E (int8, f32 or bf16), sks/svs f32 [L, n, KVH, T] and cks/cvs f32
// [L, B, KVH, S] for an INT8 cache (null for an fp one), slots int32 [n] on
// the device.  The wrapper checks 0 <= slots < B, distinct slots and T <= S
// before the launch: an out-of-range slot would be a silent out-of-bounds
// write.
//
// Bound on the H100: bytes (a pure copy).  Design: grid (row chunks, n, L);
// each block copies kRows (head, position) rows of K and V with 16-byte
// vectors when a row's bytes allow, plus their scales.  Each row is
// contiguous in both the block and the cache, so reads and writes are
// coalesced.  One kernel templated on E serves the three cache types.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // (head, position) rows per block

template <typename E>
__global__ void __launch_bounds__(kThreads)
kv_scatter_kernel(const E* __restrict__ sk, const E* __restrict__ sv,
                  const float* __restrict__ sks, const float* __restrict__ svs,
                  const int* __restrict__ slots, E* __restrict__ ck,
                  E* __restrict__ cv, float* __restrict__ cks, float* __restrict__ cvs,
                  int n, int KVH, int T, int hd, int B, int S, int vec) {
    const int l = blockIdx.z, i = blockIdx.y;
    const long long rows = (long long)KVH * T;
    const long long rbeg = (long long)blockIdx.x * kRows;
    const long long rcnt = min((long long)kRows, rows - rbeg);
    if (rcnt <= 0) return;
    const long long src0 = ((long long)l * n + i) * rows;          // first source row
    const long long dst_slot = ((long long)l * B + slots[i]) * KVH;  // (l, slot, head 0)

    constexpr int V = 16 / static_cast<int>(sizeof(E));  // elements per 16-byte vector
    const int per_row = vec ? hd / V : hd;  // copy units per row
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
    if (sks == nullptr) return;  // an fp cache has no scales
    for (long long e = threadIdx.x; e < rcnt; e += kThreads) {
        const long long rr = rbeg + e;
        const int hh = static_cast<int>(rr / T), t = static_cast<int>(rr % T);
        const long long dst = (dst_slot + hh) * S + t;
        cks[dst] = sks[src0 + rr];
        cvs[dst] = svs[src0 + rr];
    }
}

template <typename E>
int launch(const void* sk, const void* sv, const float* sks, const float* svs, const int* slots,
           void* ck, void* cv, float* cks, float* cvs, int L, int n, int KVH, int T, int hd,
           int B, int S, int vec, cudaStream_t st) {
    const long long rows = (long long)KVH * T;
    dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), n, L);
    kv_scatter_kernel<E><<<grid, kThreads, 0, st>>>(
        static_cast<const E*>(sk), static_cast<const E*>(sv), sks, svs, slots, static_cast<E*>(ck),
        static_cast<E*>(cv), cks, cvs, n, KVH, T, hd, B, S, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: the element type of sk/sv/ck/cv (TL_I8, TL_F32 or TL_BF16); the
// scale pointers are non-null exactly for int8.  vec != 0 promises rows of
// a multiple of 16 bytes and 16-byte aligned K/V pointers.
extern "C" int tl_kv_scatter_slots(const void* sk, const void* sv, const float* sks,
                                   const float* svs, const int* slots, void* ck, void* cv,
                                   float* cks, float* cvs, int kv_dtype, int L, int n, int KVH,
                                   int T, int hd, int B, int S, int vec, void* stream) {
    if (L <= 0 || n <= 0 || T <= 0) return 0;
    if ((kv_dtype == TL_I8) != (sks != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K7_ARGS sk, sv, sks, svs, slots, ck, cv, cks, cvs, L, n, KVH, T, hd, B, S, vec, st
    if (kv_dtype == TL_I8) return launch<int8_t>(TL_K7_ARGS);
    if (kv_dtype == TL_F32) return launch<float>(TL_K7_ARGS);
    if (kv_dtype == TL_BF16) return launch<__nv_bfloat16>(TL_K7_ARGS);
#undef TL_K7_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
