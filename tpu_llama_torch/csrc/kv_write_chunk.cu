// K18: land one prefill chunk's INT8 K/V rows and their f32 scales at rows
// [start, start + Tc) of one layer of the dense cache, in place.
//
// Replaces tpu_llama/ops/attention.py:2102 kv_cache_write_chunk.
//   ck[layer, b, h, start + t, :] = rk[b, h, t, :]   for t < Tc (and v)
//   cks[layer, b, h, start + t]   = rks[b, h, t]      (and vs)
// rk/rv int8 [B, KVH, Tc, hd], rks/rvs f32 [B, KVH, Tc], ck/cv int8
// [L, B, KVH, S, hd], cks/cvs f32 [L, B, KVH, S]; start and layer are host
// ints.  The wrapper checks 0 <= start, start + Tc <= S and 0 <= layer < L
// before the launch: an out-of-range row would be a silent out-of-bounds
// write.  The TPU kernel's start % 128 and Tc % 128 rules and its row split
// were Mosaic layout rules; nothing here needs them.
//
// Bound on the H100: bytes (a pure copy).  At the 7B chunked admission
// (B 8, KVH 32, Tc 256, hd 128): 2 x 8.39 MB of int8 and 2 x 0.26 MB of
// scales, each read once and written once, 34.6 MB, 10.3 us at 3.35 TB/s.
// Design: the Tc rows of one (slot, head) are contiguous in the chunk and in
// the cache, so each is one run of Tc * hd bytes; grid (row tile, kv head,
// slot), each block copying kRows rows of K and V with 16-byte vectors when
// hd allows, and their scales in the same launch (as K10 does).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows of one (slot, head) per block

__global__ void __launch_bounds__(kThreads)
kv_write_chunk_kernel(const int8_t* __restrict__ rk, const int8_t* __restrict__ rv,
                      const float* __restrict__ rks, const float* __restrict__ rvs,
                      int8_t* __restrict__ ck, int8_t* __restrict__ cv, float* __restrict__ cks,
                      float* __restrict__ cvs, int B, int KVH, int Tc, int S, int hd, int start,
                      int layer, int vec) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int r0 = blockIdx.x * kRows;
    const int nr = min(kRows, Tc - r0);
    if (nr <= 0) return;
    const long long src = ((long long)b * KVH + h) * Tc + r0;                    // first row
    const long long dst = (((long long)layer * B + b) * KVH + h) * S + start + r0;
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

// vec != 0 promises hd % 16 == 0 and 16-byte aligned row and cache pointers.
extern "C" int tl_kv_write_chunk(const int8_t* rk, const int8_t* rv, const float* rks,
                                 const float* rvs, int8_t* ck, int8_t* cv, float* cks,
                                 float* cvs, int B, int KVH, int Tc, int S, int hd, int start,
                                 int layer, int vec, void* stream) {
    if (B <= 0 || KVH <= 0 || Tc <= 0) return 0;
    dim3 grid(static_cast<unsigned>((Tc + kRows - 1) / kRows), KVH, B);
    kv_write_chunk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rk, rv, rks, rvs, ck, cv, cks, cvs, B, KVH, Tc, S, hd, start, layer, vec);
    return static_cast<int>(cudaGetLastError());
}
