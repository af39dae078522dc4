// K20: deferred-flush INT8 decode attention over a page pool, one page at a
// time: a two-pass softmax within each page, merged across pages online.
//
// Replaces tpu_llama/ops/attention.py:1012 paged_flash_decode_attention_fresh
// (its Pallas kernel _flash_decode_kernel :38 on the grid (B, KVH, MP) with
// the page block clamped at pos // ps).  Contract: K13's
// (csrc/paged_flash_decode_dma.cu): q [B, KVH, G, hd] raw, qs = f32(q) /
// sqrt(f32(hd)); layer `layer` of the pools k/v int8 [L, P, KVH, ps, hd]
// with f32 scales [L, P, KVH, ps]; position s of slot b in page
// page_table[b, s / ps], row s % ps; cache rows s < pos[b] attend (STRICT);
// the fresh row nk/nv int8 [B, KVH, hd] with scales nks/nvs [B, KVH] joins
// the softmax as one extra column after the last page; out f32
// [B, KVH, G, hd].  pos is clamped to [0, MP * ps]; a page id outside
// [0, P) reads page 0 (the trash page).
//
// Rounding, kept from the TPU kernel, whose key block is a WHOLE page
// (TS = ps): the cache score is dot(bf16(qs), k) in f32, times ks; per page
// m_new = max(m, max of the page's scores), corr = exp(m - m_new),
// l = l * corr + sum exp(s - m_new), and p = exp(s - m_new) UNNORMALIZED
// is rounded as bf16(p * vs) for the PV dot (f32 sums); acc = acc * corr +
// p.v.  The fresh column, in the kernel's own order (attention.py:104-120):
// s_new = sum(qs * nk) * nks, m_fin = max(m, s_new), l_fin = l * corr +
// e_new, out = (acc * corr + (e_new * nvs) * nv) / max(l_fin, 1e-30).
// Blocks of ps rows round at other points than K13's blocks of
// min(256, ps): the two agree to f32 noise plus one bf16 step of p.
//
// Bound on the H100: bytes, as K13 (each (slot, kv head) reads pos[b] rows
// of K and V and their scales).  Design: one block per (kv head, slot), as
// K19; for each page below pos, pass 1 streams its K tiles (kTile rows at a
// time through K19's two-stage cp.async ring) into a [G, ps] score buffer
// in shared memory, then the page's max, correction and denominator are
// taken and the accumulator rescaled, then pass 2 streams the page's V
// tiles and accumulates bf16(p * vs) x v.  Pages at and past pos are never
// read (the TPU grid's index map clamped them to the pos page and skipped
// their update).  Row offsets in 64-bit arithmetic: one pool array at 7B
// is past 2^31 bytes.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 128;  // cache rows per shared-memory tile (a page's rows when ps < 128)

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_flash_decode_fresh_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                                const int8_t* __restrict__ vp, const float* __restrict__ ks,
                                const float* __restrict__ vs, const int* __restrict__ page_table,
                                const int* __restrict__ pos, const int8_t* __restrict__ nk,
                                const int8_t* __restrict__ nv, const float* __restrict__ nks,
                                const float* __restrict__ nvs, float* __restrict__ out,
                                int layer, int KVH, int G, int P, int ps, int MP, int hd,
                                float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int P8 = dec_pitch<int8_t>(hd);
    const int kt = min(kTile, ps);  // rows per tile; divides ps
    const int ntp = ps / kt;        // tiles per full page
    int8_t* tile[2] = {reinterpret_cast<int8_t*>(smem), reinterpret_cast<int8_t*>(smem) + kt * P8};
    float* tsc[2];  // each stage's scales [kt]: ks for a K tile, vs for a V tile
    tsc[0] = reinterpret_cast<float*>(tile[1] + kt * P8);
    tsc[1] = tsc[0] + kt;
    float* qf = tsc[1] + kt;        // [G, P8] f32 qs
    float* qb = qf + G * P8;        // [G, P8] bf16(qs)
    float* sc = qb + G * P8;        // [G, ps] the current page's scores
    float* pv = sc + G * ps;        // [G, kt] bf16(p * vs) of the current V tile
    float* m_s = pv + G * kt;       // [kDecMaxG] running max
    float* l_s = m_s + kDecMaxG;    // running denominator
    float* c_s = l_s + kDecMaxG;    // the current page's correction exp(m_old - m_new)
    float* n_s = c_s + kDecMaxG;    // fresh-column score

    const int p = min(max(pos[b], 0), MP * ps);
    const int npg = (p + ps - 1) / ps;                 // pages holding rows < p
    const int last_rows = p - (npg - 1) * ps;          // rows < p in the last page
    const int nk_last = (last_rows + kt - 1) / kt;     // its K (and V) tiles
    const int nt = npg > 0 ? 2 * ((npg - 1) * ntp + nk_last) : 0;
    const long long bh = (long long)b * KVH + h;
    const int* pt = page_table + (long long)b * MP;

    dec_load_q(q + bh * G * hd, qf, qb, G, hd, P8, sqrt_hd);
    if (P8 != hd) dec_zero_pad(tile[0], 2 * kt, hd, P8);  // both stages
    if (tid < G) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;

    // tile t -> (page j, K or V, tile i of the page, tiles of the page)
    auto where = [&](int t, int& j, bool& is_k, int& i, int& n) {
        const int full = 2 * (npg - 1) * ntp;
        if (t < full) {
            j = t / (2 * ntp);
            n = ntp;
            t -= j * 2 * ntp;
        } else {
            j = npg - 1;
            n = nk_last;
            t -= full;
        }
        is_k = t < n;
        i = is_k ? t : t - n;
    };
    auto page_row0 = [&](int j) {  // pool row of (layer, page, head h, row 0)
        int pg = __ldg(pt + j);
        if (pg < 0 || pg >= P) pg = 0;  // the trash page
        return (((long long)layer * P + pg) * KVH + h) * ps;
    };
    auto issue = [&](int t) {
        int j, i, n;
        bool is_k;
        where(t, j, is_k, i, n);
        const int rows = min(kt, p - j * ps - i * kt);
        const long long r = page_row0(j) + (long long)i * kt;
        dec_issue_tile<CH>(tile[t & 1], (is_k ? kp : vp) + r * hd, rows, hd, P8, tsc[t & 1],
                           (is_k ? ks : vs) + r, nullptr, nullptr);
    };

    if (nt > 0) issue(0);
    for (int t = 0; t < nt; ++t) {
        if (t + 1 < nt) {
            issue(t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // tile t has landed for every thread
        int j, i, n;
        bool is_k;
        where(t, j, is_k, i, n);
        const int page_rows = min(ps, p - j * ps);  // rows < p in page j
        const int base = i * kt;                    // the tile's first row in the page
        const int8_t* td = tile[t & 1];
        const float* ts = tsc[t & 1];
        if (is_k) {  // pass 1: the page's scores
            dec_qk_tile(qb, td, kt, G, P8, [&](int g, int r, float dot) {
                if (base + r < page_rows) sc[g * ps + base + r] = dot * ts[r];
            });
            if (i == n - 1) {  // the page's statistics, then rescale the accumulator
                __syncthreads();
                for (int g = warp; g < G; g += kDecThreads / 32) {
                    const float* s = sc + g * ps;
                    const float m_old = m_s[g];
                    float mx = kNegInf;
                    for (int r = lane; r < page_rows; r += 32) mx = fmaxf(mx, s[r]);
                    const float m_new = fmaxf(m_old, warp_max(mx));
                    float sum = 0.f;
                    for (int r = lane; r < page_rows; r += 32) sum += expf(s[r] - m_new);
                    sum = warp_sum(sum);
                    if (lane == 0) {
                        const float corr = expf(m_old - m_new);
                        c_s[g] = corr;
                        l_s[g] = l_s[g] * corr + sum;
                        m_s[g] = m_new;
                    }
                }
                __syncthreads();
#pragma unroll
                for (int jj = 0; jj < kDecMaxE; ++jj) {
                    const int e = tid + kDecThreads * jj;
                    if (e < G * hd) acc[jj] *= c_s[e / hd];
                }
            }
        } else {  // pass 2: bf16(p * vs) x v
            for (int e = tid; e < G * kt; e += kDecThreads) {
                const int g = e / kt, r = e % kt;
                float pn = 0.f;  // rows >= p: their stage slots hold stale scales
                if (base + r < page_rows)
                    pn = round_bf16(expf(sc[g * ps + base + r] - m_s[g]) * ts[r]);
                pv[e] = pn;
            }
            __syncthreads();
            float part[kDecMaxE];
            dec_pv_tile(pv, kt, td, min(kt, page_rows - base), G, hd, P8, part);
#pragma unroll
            for (int jj = 0; jj < kDecMaxE; ++jj) acc[jj] += part[jj];
        }
        __syncthreads();  // the stage is free for tile t + 2
    }

    // the fresh column, merged as the TPU kernel merges it at its last block
    if (nt == 0) __syncthreads();  // the q rows and the state (no tile made the loop sync)
    dec_fresh_scores(qf, P8, nk + bh * hd, nks[bh], G, hd, n_s);
    __syncthreads();
    const float nvs_bh = nvs[bh];
#pragma unroll
    for (int jj = 0; jj < kDecMaxE; ++jj) {
        const int e = tid + kDecThreads * jj;
        if (e < G * hd) {
            const int g = e / hd, d = e % hd;
            const float m = m_s[g], s_new = n_s[g];
            const float m_fin = fmaxf(m, s_new);
            const float corr = expf(m - m_fin);
            const float e_new = expf(s_new - m_fin);
            const float l_fin = l_s[g] * corr + e_new;
            out[bh * G * hd + e] = (acc[jj] * corr + (e_new * nvs_bh) * to_f32(nv[bh * hd + d])) /
                                   fmaxf(l_fin, 1e-30f);
        }
    }
}

long long smem_bytes(int G, int ps, int hd) {
    const int kt = ps < kTile ? ps : kTile;
    const int P8 = dec_pitch<int8_t>(hd);
    return 2LL * kt * P8 + 4LL * (2 * kt + 2 * G * P8 + (long long)G * ps + G * kt + 4 * kDecMaxG);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pt, const int* pos, const int8_t* nk, const int8_t* nv, const float* nks,
           const float* nvs, float* out, int layer, int B, int KVH, int G, int P, int ps, int MP,
           int hd, float sqrt_hd, cudaStream_t st) {
    auto kern = paged_flash_decode_fresh_kernel<QT, CH>;
    const long long bytes = smem_bytes(G, ps, hd);
    if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);  // G x ps scores too many
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, static_cast<int>(bytes), st>>>(
        static_cast<const QT*>(q), k, v, ks, vs, pt, pos, nk, nv, nks, nvs, out, layer, KVH, G, P,
        ps, MP, hd, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_chunk(int ch, const void* q, const int8_t* k, const int8_t* v, const float* ks,
                   const float* vs, const int* pt, const int* pos, const int8_t* nk,
                   const int8_t* nv, const float* nks, const float* nvs, float* out, int layer,
                   int B, int KVH, int G, int P, int ps, int MP, int hd, float sqrt_hd,
                   cudaStream_t st) {
#define TL_K20_ARGS q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, P, ps, MP, hd, sqrt_hd, st
    if (ch == 16) return launch<QT, 16>(TL_K20_ARGS);
    if (ch == 4) return launch<QT, 4>(TL_K20_ARGS);
#undef TL_K20_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Arguments as tl_paged_flash_decode_dma (csrc/paged_flash_decode_dma.cu)
// without TS.  A page's G x ps scores stay in shared memory, so G * ps is
// bounded (about 40k f32 at hd 128); ps must be at most kTile or a multiple
// of it.
extern "C" int tl_paged_flash_decode_fresh(const void* q, int q_dtype, const void* k,
                                           const void* v, const float* ks, const float* vs,
                                           const int* page_table, const int* pos, const void* nk,
                                           const void* nv, const float* nks, const float* nvs,
                                           float* out, int layer, int B, int KVH, int G, int P,
                                           int ps, int MP, int hd, float sqrt_hd, int ch,
                                           void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || ps < 1 || MP < 1 || P < 1 ||
        (ps > kTile && ps % kTile != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *k8 = static_cast<const int8_t*>(k), *v8 = static_cast<const int8_t*>(v);
    const int8_t *nk8 = static_cast<const int8_t*>(nk), *nv8 = static_cast<const int8_t*>(nv);
#define TL_K20_ARGS ch, q, k8, v8, ks, vs, page_table, pos, nk8, nv8, nks, nvs, out, layer, B, KVH, G, P, ps, MP, hd, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_chunk<float>(TL_K20_ARGS);
    if (q_dtype == TL_BF16) return dispatch_chunk<__nv_bfloat16>(TL_K20_ARGS);
#undef TL_K20_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
