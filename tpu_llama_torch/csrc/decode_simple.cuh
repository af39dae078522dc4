// The single-pass decode attention cell: K19 flash_decode_fresh.cu (kFresh,
// the deferred-flush form) and K21 flash_decode.cu's default form (the
// write-then-attend form), over an INT8, f32 or bf16 cache (CT).
//
// One block per (kv head, slot); the G query rows of the slot's kv head
// attend over its first p cache rows of layer `layer` (K19: p = pos, rows
// s < pos, and the fresh row nk/nv as one extra column; K21: p = pos + 1,
// rows s <= pos, no fresh column).  The softmax is NORMALIZED before its
// bf16 rounding, as the TPU kernels do (attention.py:150-185 for K19,
// _flash_decode_simple_kernel :569-603 for K21): the cache score is
// dot(bf16(qs), k) in f32, times ks (an fp cache: dot(qs, f32(k)), no
// scales); m = the max over the scores (and K19's fresh score s_new, from
// the unrounded f32 qs, times nks); p = exp(s - m) / l, rounded as
// bf16(p * vs) for an INT8 cache's PV dot (f32 accumulation), f32 for an
// fp one.  K19 adds (exp(s_new - m) / l * nvs) * f32(nv).  p = 0 (a
// negative pos in K21) attends nothing: zeros, which is where the port
// leaves the TPU kernel (it averages every row).
//
// Bound on the H100: bytes, each (slot, kv head) reads p rows of K and V
// and their scales.  Design: a two-stage cp.async ring of 128-row tiles
// and a two-pass softmax: pass 1 streams the K tiles (rows < p only) and
// keeps every score in shared memory (G x S f32, 8 KB per query row at
// S = 2048); then the max and the denominator; pass 2 streams the V tiles
// and accumulates p x v.  The first V tile is in flight while the
// statistics are taken.  At B = 1 only KVH blocks run (32 of 132 SMs at
// 7B): a split-S variant is later work.
#pragma once

#include <math.h>

#include "common.cuh"

namespace dec_simple {

constexpr int kTile = 128;  // cache rows per shared-memory tile

// The cell of block (h, b) = (blockIdx.x, blockIdx.y); each source wraps it
// in a kernel of its own name (K19 flash_decode_fresh_kernel, K21
// flash_decode_simple_kernel), so a trace tells them apart.
template <typename QT, typename CT, int CH, bool kFresh>
__device__ void cell(unsigned char* smem, const QT* __restrict__ q, const CT* __restrict__ kc,
                     const CT* __restrict__ vc, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ pos,
                     const CT* __restrict__ nk, const CT* __restrict__ nv,
                     const float* __restrict__ nks, const float* __restrict__ nvs,
                     float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                     float sqrt_hd) {
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr bool kInt8 = sizeof(CT) == 1;
    const int P = dec_pitch<CT>(hd);
    CT* tile[2] = {reinterpret_cast<CT*>(smem), reinterpret_cast<CT*>(smem) + kTile * P};
    float* tsc[2];  // each stage's scales [kTile]
    tsc[0] = reinterpret_cast<float*>(tile[1] + kTile * P);
    tsc[1] = tsc[0] + kTile;
    float* qf = tsc[1] + kTile;  // [G, P] f32 qs
    float* qb = qf + G * P;      // [G, P] bf16(qs)
    float* sc = qb + G * P;      // [G, S] scores of rows < p
    float* pv = sc + G * S;      // [G, kTile] p (INT8: bf16(p * vs)) of the current V tile
    float* m_s = pv + G * kTile;     // [kDecMaxG] max over the rows (and the fresh column)
    float* l_s = m_s + kDecMaxG;     // denominator
    float* e_s = l_s + kDecMaxG;     // exp(s_new - m)
    float* n_s = e_s + kDecMaxG;     // fresh-column score s_new

    const int p = kFresh ? min(max(pos[b], 0), S) : min(max(pos[b] + 1, 0), S);
    const int nb = (p + kTile - 1) / kTile;
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;

    dec_load_q(q + bh * G * hd, qf, qb, G, hd, P, sqrt_hd);
    if (P != hd) dec_zero_pad(tile[0], 2 * kTile, hd, P);  // both stages
    __syncthreads();
    if (kFresh) dec_fresh_scores(qf, P, nk + bh * hd, kInt8 ? nks[bh] : 1.f, G, hd, n_s);

    // m, l (and K19's exp(s_new - m)) of every query row, from pass 1's scores
    auto stats = [&]() {
        for (int g = warp; g < G; g += kDecThreads / 32) {
            const float* s = sc + g * S;
            float mx = kNegInf;
            for (int r = lane; r < p; r += 32) mx = fmaxf(mx, s[r]);
            const float m = kFresh ? fmaxf(warp_max(mx), n_s[g]) : warp_max(mx);
            float sum = 0.f;
            for (int r = lane; r < p; r += 32) sum += expf(s[r] - m);
            sum = warp_sum(sum);
            if (lane == 0) {
                const float e_new = kFresh ? expf(n_s[g] - m) : 0.f;
                m_s[g] = m;
                e_s[g] = e_new;
                l_s[g] = sum + e_new;
            }
        }
    };

    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;

    // Tile stream: t < nb is K block t (with ks), t >= nb is V block t - nb
    // (with vs); tile t goes to stage t & 1.
    auto issue = [&](int t) {
        const bool is_k = t < nb;
        const int j = is_k ? t : t - nb;
        const int rows = min(kTile, p - j * kTile);
        const long long r = row0 + (long long)j * kTile;
        dec_issue_tile<CH>(tile[t & 1], (is_k ? kc : vc) + r * hd, rows, hd, P,
                           kInt8 ? tsc[t & 1] : nullptr, kInt8 ? (is_k ? ks : vs) + r : nullptr,
                           nullptr, nullptr);
    };
    const int nt = 2 * nb;
    if (nt > 0) issue(0);
    for (int t = 0; t < nt; ++t) {
        if (t + 1 < nt) {
            issue(t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // tile t has landed for every thread
        const CT* td = tile[t & 1];
        const float* ts = tsc[t & 1];
        if (t < nb) {  // pass 1: scores
            const int base = t * kTile;
            dec_qk_tile(kInt8 ? qb : qf, td, kTile, G, P, [&](int g, int r, float dot) {
                if (base + r < p) sc[g * S + base + r] = kInt8 ? dot * ts[r] : dot;
            });
            if (t == nb - 1) {
                __syncthreads();
                stats();
            }
        } else {  // pass 2: p x v (INT8: bf16(p * vs) x v)
            const int base = (t - nb) * kTile;
            for (int e = tid; e < G * kTile; e += kDecThreads) {
                const int g = e / kTile, r = e % kTile;
                float pn = 0.f;  // rows >= p: their stage slots hold stale scales
                if (base + r < p) {
                    pn = expf(sc[g * S + base + r] - m_s[g]) / l_s[g];
                    if (kInt8) pn = round_bf16(pn * ts[r]);
                }
                pv[e] = pn;
            }
            __syncthreads();
            float part[kDecMaxE];
            dec_pv_tile(pv, kTile, td, min(kTile, p - base), G, hd, P, part);
#pragma unroll
            for (int j = 0; j < kDecMaxE; ++j) acc[j] += part[j];
        }
        __syncthreads();  // the stage is free for tile t + 2
    }
    if (nb == 0) {
        __syncthreads();
        stats();
    }
    __syncthreads();

    const float nvs_bh = kFresh && kInt8 ? nvs[bh] : 1.f;
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            if (kFresh) {
                const int g = e / hd, d = e % hd;
                const float p_new = kInt8 ? (e_s[g] / l_s[g]) * nvs_bh : e_s[g] / l_s[g];
                out[bh * G * hd + e] = acc[j] + p_new * to_f32(nv[bh * hd + d]);
            } else {
                out[bh * G * hd + e] = acc[j];
            }
        }
    }
}

// The dynamic shared memory of one cell: two tiles of kTile rows, their
// scales, the G query rows twice, the G x S scores, one V tile's p, and
// the row statistics; more than a block can have (G x S scores too many)
// is refused by the caller.
template <typename CT>
long long smem_bytes(int G, int S, int hd) {
    const int P = dec_pitch<CT>(hd);
    return 2LL * kTile * P * sizeof(CT) +
           4LL * (2 * kTile + 2 * G * P + (long long)G * S + G * kTile + 4 * kDecMaxG);
}

// Launches kern (a wrapper of cell) on a (KVH, B) grid with smem_bytes of
// shared memory, or refuses (cudaErrorInvalidValue) when they exceed a
// block's 227 KB.
template <class Kern, class... Args>
int launch(Kern kern, long long bytes, int KVH, int B, cudaStream_t st, Args... args) {
    if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, static_cast<int>(bytes), st>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dec_simple
