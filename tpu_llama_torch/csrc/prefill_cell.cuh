// The f32 SIMT cell of causal prefill attention for the fp forms of K6
// (flash_prefill.cu: a dense float32 or bfloat16 cache).  K6's INT8 form
// and K16 run the bf16 tensor-core cell of prefill_mma.cuh: the TPU
// kernels' INT8 branch rounds q and p * vs to bf16 for its MXU dots, while
// their fp branch (attention.py:1613-1640) is f32 dots and f32 p, which a
// bf16 dot is not.
//
// One block per (q tile of 64 folded rows, kv head, slot): the G = NH / KVH
// query heads of kv head h fold into rows r = t * G + g; q [B, T, NH, hd] is
// pre-scaled by 1/sqrt(hd) (a division); an online softmax runs over 64-key
// tiles and stops at the tile holding the block's last attended key (causal
// tile skip); K and V are converted to f32 once per tile into shared memory,
// the per-key scales (1 for a key that exists, 0 past the cache) multiply
// the score and probability columns; each thread holds a 4 x 8 score tile
// and a 4 x hd/8 output tile in registers; the output [B, T, NH * hd] is
// acc / max(l, 1e-30), cast once.  Key s attends query t iff s <= start + t
// and the key source allows s.
//
// The key source (`Keys`) says where key c of a tile lives and which keys
// exist.  It provides
//   int kend(int e)        the end of the keys to walk, given e = start +
//                          the block's last row + 1;
//   bool ok(int c)         key c exists (besides the causal rule);
//   void load_k(c0, KV, ksc, vsc)  the tile's K rows as f32 into KV
//                          [kBC][HDP + 1] and its K / V scales (0 for a key
//                          that does not exist);
//   void load_v(c0, KV)    the tile's V rows as f32.
//
// Rounding: f32 throughout, so the result agrees with the plain version to
// f32 summation-order noise.  The f32 SIMT rate is ~1/15 of the bf16
// tensor-core rate: at the bf16-cache shape this cell takes ~27x SDPA on
// the card (PERF.md; ROADMAP queue 2 names a split-bf16 product for it).
#pragma once

#include <math.h>

#include "common.cuh"

namespace prefill {

constexpr int kBR = 64;        // folded query rows per block
constexpr int kBC = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)

// The cell's shared memory in floats: Qs [kBR][HDP + 1], the K/V tile
// [kBC][HDP + 1], p * vs [kBR][kBC + 1], then the K and V scales [kBC] each.
// A key source's own shared memory follows (8-byte aligned).
template <int HDP>
constexpr int kCellFloats = kBR * (HDP + 1) + kBC * (HDP + 1) + kBR * (kBC + 1) + 2 * kBC;

template <int HDP, typename QT, typename OT, class Keys>
__device__ __forceinline__ void attend(const QT* __restrict__ q, OT* __restrict__ out,
                                       Keys& keys, int st, int T, int NH, int KVH, int hd,
                                       float sqrt_hd) {
    constexpr int LDQ = HDP + 1, LDP = kBC + 1, DJ = HDP / 8;
    extern __shared__ float smem[];
    float* Qs = smem;                // [BR][LDQ] pre-scaled queries
    float* KV = Qs + kBR * LDQ;      // [BC][LDQ] K, then V, as f32
    float* Ps = KV + kBC * LDQ;      // [BR][LDP] p * v_scale
    float* ksc = Ps + kBR * LDP;     // [BC]
    float* vsc = ksc + kBC;          // [BC]

    const int G = NH / KVH;
    const int rows = T * G;
    const int r0 = blockIdx.x * kBR, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

    for (int e = tid; e < kBR * HDP; e += kThreads) {
        const int r = e / HDP, d = e % HDP, row = r0 + r;
        float v = 0.f;
        if (row < rows && d < hd) {
            const int t = row / G, gg = row % G;
            v = to_f32(q[(((long long)b * T + t) * NH + h * G + gg) * hd + d]) / sqrt_hd;
        }
        Qs[r * LDQ + d] = v;
    }

    // causal tile skip: the block's last real row attends keys < kend
    const int last_t = (min(r0 + kBR, rows) - 1) / G;
    const int kend = keys.kend(st + last_t + 1);
    const int n_tiles = (kend + kBC - 1) / kBC;

    float m[4], l[4], acc[4][DJ];
    int qpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        qpos[i] = st + (r0 + ty + 16 * i) / G;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int c0 = tile * kBC;
        __syncthreads();  // previous tile's V and P reads are done
        keys.load_k(c0, KV, ksc, vsc);
        __syncthreads();

        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
        for (int d = 0; d < HDP; ++d) {
            float qv[4], kv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] = KV[(tx + 8 * j) * LDQ + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

        // online softmax; the 8 lanes of a row group (tx) share each row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = c0 + tx + 8 * j;
                const bool ok = c <= qpos[i] && keys.ok(c);
                sc[i][j] = ok ? sc[i][j] * ksc[tx + 8 * j] : -INFINITY;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            // a row that has attended no key yet keeps m = -inf: no correction
            const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
                sum += p;
                Ps[(ty + 16 * i) * LDP + tx + 8 * j] = p * vsc[tx + 8 * j];
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();  // K reads and P writes done

        keys.load_v(c0, KV);
        __syncthreads();

        for (int c = 0; c < kBC; ++c) {
            float pv[4], vv[DJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
            for (int j = 0; j < DJ; ++j) vv[j] = KV[c * LDQ + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= rows) continue;
        const int t = row / G, gg = row % G;
        OT* o = out + (((long long)b * T + t) * NH + h * G + gg) * hd;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const int d = tx + 8 * j;
            if (d < hd) store_as(o + d, acc[i][j] / den);
        }
    }
}

// A tile's rows [run, run + kBC) of a K (or V) array as f32 into KV, zero
// past n rows and past hd columns.
template <int HDP, typename KT>
__device__ __forceinline__ void load_run(const KT* __restrict__ src, long long run, int n, int hd,
                                         float* KV) {
    const KT* base = src + run * hd;
    for (int e = threadIdx.x; e < kBC * HDP; e += kThreads) {
        const int c = e / HDP, d = e % HDP;
        KV[c * (HDP + 1) + d] = (c < n && d < hd) ? to_f32(__ldg(base + (long long)c * hd + d))
                                                  : 0.f;
    }
}

}  // namespace prefill
