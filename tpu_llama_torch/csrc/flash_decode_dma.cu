// K9: deferred-flush decode attention over an INT8 cache that reads only the
// rows below each slot's position, online softmax over key blocks.
//
// Replaces tpu_llama/ops/attention.py:335 flash_decode_attention_dma (its
// Pallas kernel _dma_decode_kernel :188 and the XLA epilogue
// _fresh_tail_merge :307).  Contract: one query token per slot; q
// [B, KVH, G, hd] raw, qs = f32(q) / sqrt(f32(hd)); layer `layer` of the
// cache k/v int8 [L, B, KVH, S, hd] with f32 scales [L, B, KVH, S]; cache
// row s attends iff s < pos[b] (STRICT: row pos is stale until the step's
// K10 flush); the step's fresh row nk/nv int8 [B, KVH, hd] with scales
// nks/nvs [B, KVH] joins the softmax as one extra column; out f32
// [B, KVH, G, hd].
//
// Rounding, kept from the TPU kernel so that this kernel, its plain version
// and the JAX package agree to f32 noise: the cache score is
// dot(bf16(qs), k) accumulated in f32, times ks; the online softmax runs
// over blocks of TS rows, p = exp(s - m_block) is UNNORMALIZED when it is
// rounded, as bf16(p * vs), before the PV dot (f32 accumulation); the
// fresh column's score uses the unrounded f32 qs (times nks) and its value
// f32(nv) * nvs, merged after the last block as _fresh_tail_merge does.
// TS is the JAX function's block_s (128 rows for int8): the rounding points
// depend on it.
//
// Bound on the H100: bytes.  Each (slot, kv head) must read pos[b] rows of
// K and V (hd bytes each) and their two f32 scales: at Llama-2 7B, batch 8
// at position 512, 8 * 32 * 512 * (2 * 128 + 8) B = 34.6 MB per layer,
// 10.3 us at 3.35 TB/s.  Design: the TPU kernel's one-cell-per-slot grid
// with a cross-cell DMA prefetch existed because TPU grid cells run in
// order; here one block per (kv head, slot) (256 blocks at 7B batch 8)
// streams its ceil(pos / TS) blocks of K, then V, through a two-stage
// cp.async ring in shared memory (16-byte chunks), the next tile in flight
// while the current one is used.  Rows >= pos are never read.  The G query
// heads of a GQA group share every K/V byte, and the fresh-column merge
// runs in the same launch.  pos is read on the device: no host sync.
#include <math.h>

#include "common.cuh"

namespace {

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_dma_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                        const int8_t* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ pos,
                        const int8_t* __restrict__ nk, const int8_t* __restrict__ nv,
                        const float* __restrict__ nks, const float* __restrict__ nvs,
                        float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                        int TS, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int P = dec_pitch(hd);
    int8_t* kt = reinterpret_cast<int8_t*>(smem);  // stage 0: K tile [TS, P]
    int8_t* vt = kt + TS * P;                      // stage 1: V tile [TS, P]
    float* kst = reinterpret_cast<float*>(vt + TS * P);  // stage 0's scales: ks [TS]
    float* vst = kst + TS;                               //   and vs [TS]
    float* qf = vst + TS;        // [G, P] f32 qs
    float* qb = qf + G * P;      // [G, P] bf16(qs)
    float* sc = qb + G * P;      // [G, TS] scores, then bf16(p * vs)
    float* m_s = sc + G * TS;    // [kDecMaxG] running max
    float* l_s = m_s + kDecMaxG;     // running denominator
    float* c_s = l_s + kDecMaxG;     // this block's correction exp(m_old - m_new)
    float* n_s = c_s + kDecMaxG;     // fresh-column score

    const int p = min(max(pos[b], 0), S);
    const int nb = (p + TS - 1) / TS;
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;

    dec_load_q(q + bh * G * hd, qf, qb, G, hd, P, sqrt_hd);
    if (P != hd) dec_zero_pad(kt, 2 * TS, hd, P);  // both stages
    if (tid < G) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;

    // Tile stream: t = 2j is K block j (with ks and vs) into stage 0,
    // t = 2j + 1 is V block j into stage 1.
    auto issue = [&](int t) {
        const int j = t >> 1;
        const int rows = min(TS, p - j * TS);
        const long long r = row0 + (long long)j * TS;
        if (t & 1)
            dec_issue_tile<CH>(vt, vc + r * hd, rows, hd, P, nullptr, nullptr, nullptr, nullptr);
        else
            dec_issue_tile<CH>(kt, kc + r * hd, rows, hd, P, kst, ks + r, vst, vs + r);
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
        const int base = (t >> 1) * TS;
        if ((t & 1) == 0) {
            dec_qk_tile(qb, kt, TS, G, P, [&](int g, int r, float dot) {
                const bool valid = base + r < p;
                sc[g * TS + r] = valid ? dot * kst[r] : kNegInf;
            });
            __syncthreads();
            // online softmax over the block, one warp per query row
            for (int g = warp; g < G; g += kDecThreads / 32) {
                float* s = sc + g * TS;
                const float m_old = m_s[g];
                float mx = kNegInf;
                for (int r = lane; r < TS; r += 32) mx = fmaxf(mx, s[r]);
                const float m_new = fmaxf(m_old, warp_max(mx));
                float sum = 0.f;
                for (int r = lane; r < TS; r += 32) {
                    const bool valid = base + r < p;
                    const float e = valid ? expf(s[r] - m_new) : 0.f;
                    sum += e;
                    s[r] = valid ? round_bf16(e * vst[r]) : 0.f;
                }
                sum = warp_sum(sum);
                if (lane == 0) {
                    const float corr = expf(m_old - m_new);
                    c_s[g] = corr;
                    l_s[g] = l_s[g] * corr + sum;
                    m_s[g] = m_new;
                }
            }
        } else {
            float part[kDecMaxE];
            dec_pv_tile(sc, TS, vt, TS, G, hd, P, part);
#pragma unroll
            for (int j = 0; j < kDecMaxE; ++j) {
                const int e = tid + kDecThreads * j;
                if (e < G * hd) acc[j] = acc[j] * c_s[e / hd] + part[j];
            }
        }
        __syncthreads();  // the stage is free for tile t + 2
    }

    // the fresh column (_fresh_tail_merge, attention.py:307-332)
    if (nt == 0) __syncthreads();  // the q rows (no tile made the loop sync)
    dec_fresh_scores(qf, P, nk + bh * hd, nks[bh], G, hd, n_s);
    __syncthreads();
    const float nvs_bh = nvs[bh];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            const int g = e / hd, d = e % hd;
            const float m = m_s[g], s_new = n_s[g];
            const float m_fin = fmaxf(m, s_new);
            const float corr = expf(m - m_fin);
            const float e_new = expf(s_new - m_fin);
            const float l_fin = l_s[g] * corr + e_new;
            const float nvf = static_cast<float>(nv[bh * hd + d]) * nvs_bh;
            out[bh * G * hd + e] = (acc[j] * corr + e_new * nvf) / fmaxf(l_fin, 1e-30f);
        }
    }
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pos, const int8_t* nk, const int8_t* nv, const float* nks,
           const float* nvs, float* out, int layer, int B, int KVH, int G, int S, int hd, int TS,
           float sqrt_hd, cudaStream_t st) {
    auto kern = flash_decode_dma_kernel<QT, CH>;
    const int P = (hd + 15) & ~15;
    const int bytes = 2 * TS * P + 4 * (2 * TS + 2 * G * P + G * TS + 4 * kDecMaxG);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, bytes, st>>>(static_cast<const QT*>(q), k, v, ks, vs, pos, nk,
                                                   nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS,
                                                   sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16), k/v int8 [L, B, KVH, S, hd], ks/vs f32
// [L, B, KVH, S], pos int32 [B] (device), nk/nv int8 [B, KVH, hd], nks/nvs
// f32 [B, KVH], out f32 [B, KVH, G, hd]; all contiguous.  The wrapper
// checks G <= 8, hd <= 128, TS | S, TS <= 256, and ch: 16 promises
// hd % 16 == 0 and 16-byte aligned k/v, 4 promises hd % 4 == 0.
extern "C" int tl_flash_decode_dma(const void* q, int q_dtype, const int8_t* k, const int8_t* v,
                                   const float* ks, const float* vs, const int* pos,
                                   const int8_t* nk, const int8_t* nv, const float* nks,
                                   const float* nvs, float* out, int layer, int B, int KVH, int G,
                                   int S, int hd, int TS, float sqrt_hd, int ch, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K9_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, sqrt_hd, st
    if (q_dtype == TL_F32 && ch == 16) return launch<float, 16>(TL_K9_ARGS);
    if (q_dtype == TL_F32 && ch == 4) return launch<float, 4>(TL_K9_ARGS);
    if (q_dtype == TL_BF16 && ch == 16) return launch<__nv_bfloat16, 16>(TL_K9_ARGS);
    if (q_dtype == TL_BF16 && ch == 4) return launch<__nv_bfloat16, 4>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
