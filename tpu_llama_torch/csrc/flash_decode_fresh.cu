// K19: deferred-flush decode attention over an INT8, f32 or bf16 cache,
// single pass over the rows below each slot's position with the softmax
// normalized before its bf16 rounding.
//
// Replaces tpu_llama/ops/attention.py:807 flash_decode_attention_fresh (its
// Pallas kernel _flash_decode_fresh_kernel :127).  The contract is K9's
// (csrc/flash_decode_dma.cu): q [B, KVH, G, hd] raw, qs = f32(q) /
// sqrt(f32(hd)); cache rows s < pos[b] of layer `layer` (STRICT: row pos is
// stale until the step's K10 flush) plus the fresh row nk/nv as one extra
// column; out f32 [B, KVH, G, hd].  The TPU kernel's head_block folding of
// KV heads into one grid cell is a TPU grid detail and is not carried.
//
// Rounding, kept from the TPU kernel (attention.py:150-185): the cache score
// is dot(bf16(qs), k) in f32, times ks; the fresh score uses the unrounded
// f32 qs, times nks; m = max(scores, fresh score); p = exp(s - m) / l is
// NORMALIZED before it is rounded, as bf16(p * vs), for the PV dot (f32
// accumulation); the fresh column adds (exp(s_new - m) / l * nvs) * f32(nv).
// That is where this kernel differs from K9, which rounds unnormalized
// blockwise p: the two agree only to about 2e-2 (tests/test_attention.py).
// For an fp cache (the kernel's int8=False branch, attention.py:152-181)
// nothing is rounded and there are no scales: s = dot(qs, f32(k)), p =
// exp(s - m) / l in f32; K9 and K19 then agree to f32 summation noise.  The
// kernel is templated on the cache type (CT), one kernel for all three.
//
// Bound on the H100: bytes, as K9: each (slot, kv head) reads pos[b] rows of
// K and V and their scales -- at B = 1 and position 2047, 32 kv heads x
// 2047 x (2 * 128 + 8) B = 17.3 MB per layer, 5.2 us at 3.35 TB/s.
// Design: the same block per (kv head, slot) and two-stage cp.async ring as
// K9, but a two-pass softmax: pass 1 streams the K tiles (rows < pos only)
// and keeps every score in shared memory (G x S f32, 8 KB per query row at
// S = 2048); then the max and the denominator; pass 2 streams the V tiles
// and accumulates bf16(p * vs) x v.  The first V tile is in flight while
// the statistics are taken.  At B = 1 only KVH blocks run (32 of 132 SMs
// at 7B): a split-S variant is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 128;  // cache rows per shared-memory tile

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_fresh_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                          const CT* __restrict__ vc, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ pos,
                          const CT* __restrict__ nk, const CT* __restrict__ nv,
                          const float* __restrict__ nks, const float* __restrict__ nvs,
                          float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                          float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
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
    float* sc = qb + G * P;      // [G, S] scores of rows < pos
    float* pv = sc + G * S;      // [G, kTile] p (INT8: bf16(p * vs)) of the current V tile
    float* m_s = pv + G * kTile;     // [kDecMaxG] max over the row and the fresh column
    float* l_s = m_s + kDecMaxG;     // denominator
    float* e_s = l_s + kDecMaxG;     // exp(s_new - m)
    float* n_s = e_s + kDecMaxG;     // fresh-column score s_new

    const int p = min(max(pos[b], 0), S);
    const int nb = (p + kTile - 1) / kTile;
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;

    dec_load_q(q + bh * G * hd, qf, qb, G, hd, P, sqrt_hd);
    if (P != hd) dec_zero_pad(tile[0], 2 * kTile, hd, P);  // both stages
    __syncthreads();
    dec_fresh_scores(qf, P, nk + bh * hd, kInt8 ? nks[bh] : 1.f, G, hd, n_s);

    // m, l and exp(s_new - m) of every query row, from the scores of pass 1
    auto stats = [&]() {
        for (int g = warp; g < G; g += kDecThreads / 32) {
            const float* s = sc + g * S;
            float mx = kNegInf;
            for (int r = lane; r < p; r += 32) mx = fmaxf(mx, s[r]);
            const float m = fmaxf(warp_max(mx), n_s[g]);
            float sum = 0.f;
            for (int r = lane; r < p; r += 32) sum += expf(s[r] - m);
            sum = warp_sum(sum);
            if (lane == 0) {
                const float e_new = expf(n_s[g] - m);
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

    const float nvs_bh = kInt8 ? nvs[bh] : 1.f;
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            const int g = e / hd, d = e % hd;
            const float p_new = kInt8 ? (e_s[g] / l_s[g]) * nvs_bh : e_s[g] / l_s[g];
            out[bh * G * hd + e] = acc[j] + p_new * to_f32(nv[bh * hd + d]);
        }
    }
}

template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, const void* nk, const void* nv, const float* nks,
           const float* nvs, float* out, int layer, int B, int KVH, int G, int S, int hd,
           float sqrt_hd, cudaStream_t st) {
    auto kern = flash_decode_fresh_kernel<QT, CT, CH>;
    const int P = dec_pitch<CT>(hd);
    const long long bytes = 2LL * kTile * P * sizeof(CT) +
                            4LL * (2 * kTile + 2 * G * P + (long long)G * S + G * kTile + 4 * kDecMaxG);
    if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);  // G x S scores too many
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, static_cast<int>(bytes), st>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks, vs, pos,
        static_cast<const CT*>(nk), static_cast<const CT*>(nv), nks, nvs, out, layer, B, KVH, G, S,
        hd, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const void* nk, const void* nv,
                   const float* nks, const float* nvs, float* out, int layer, int B, int KVH,
                   int G, int S, int hd, float sqrt_hd, cudaStream_t st) {
#define TL_K19_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K19_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, const void* nk,
                   const void* nv, const float* nks, const float* nvs, float* out, int layer,
                   int B, int KVH, int G, int S, int hd, float sqrt_hd, cudaStream_t st) {
#define TL_K19_ARGS ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (kv_dtype == TL_I8) return dispatch_chunk<QT, int8_t>(TL_K19_ARGS);
    if (kv_dtype == TL_F32) return dispatch_chunk<QT, float>(TL_K19_ARGS);
    if (kv_dtype == TL_BF16) return dispatch_chunk<QT, __nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Arguments as tl_flash_decode_dma (csrc/flash_decode_dma.cu) without TS;
// every score of a (slot, kv head) stays in shared memory, so G * S is
// bounded (about 50k f32 at hd 128).
extern "C" int tl_flash_decode_fresh(const void* q, int q_dtype, int kv_dtype, const void* k,
                                     const void* v, const float* ks, const float* vs,
                                     const int* pos, const void* nk, const void* nv,
                                     const float* nks, const float* nvs, float* out, int layer,
                                     int B, int KVH, int G, int S, int hd, float sqrt_hd, int ch,
                                     void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || (kv_dtype == TL_I8) != (ks != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K19_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K19_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
