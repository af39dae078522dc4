// The page-block form of the split decode cell: K20
// (paged_flash_decode_fresh.cu) and K22 (paged_flash_decode.cu).
// Flash-decoding over whole pages of a page pool, with a page as the
// rounding block, the way the TPU kernel rounds.
//
// What the TPU kernel does (tpu_llama/ops/attention.py:38-125
// _flash_decode_kernel with TS = ps, on the grid (B, KVH, MP)): a key block
// is one whole page.  Per page, m_new = max(m, the page's max score), corr =
// exp(m - m_new), l = l * corr + sum exp(s - m_new), and p = exp(s - m_new)
// UNNORMALIZED is rounded as bf16(p * vs) for the PV dot; acc = acc * corr
// + p.v.  K22 masks t <= pos and writes acc / max(l, 1e-30); K20 masks
// t < pos and merges the step's fresh row after the last page in the
// order (e_new * nvs) * nv.
//
// What it replaces: K22 ran common.cuh's dec_attend_rows over blocks of
// min(256, ps) rows (so at ps 512 it rounded p per half page), and K20 a
// two-pass page loop; both one 128-thread block per (kv head, slot), the
// key blocks a chain of latency-bound steps on four warps while most of
// the card's 132 SMs idled at a GQA group (B 8, KVH 8: 64 blocks) or at
// batch 1 (32 blocks).
//
// Design (decode_split.cuh's pieces, a page as the block):
// - Grid (splits, KVH, B).  Split i takes the whole pages [i * MP / splits,
//   (i + 1) * MP / splits) (integer division), clipped to the pages that
//   hold rows < p; its partial (acc unnormalized, m, l) is merged with the
//   others in the same launch by the last block of the (slot, kv head)
//   (split_finish: the workspace and the self-resetting ticket).  A split
//   with no live page writes the empty partial.  The host's rule
//   (ops/attention.py page_splits) is K13's count capped at MP.
// - A page is read as ring tiles of T rows (T divides ps): its K tiles,
//   each with the ks and vs rows of its rows, then its V tiles, through a
//   cp.async ring of nt tiles (split_copy_rows, xor-swizzled rows), so the
//   page's V tiles and the next page's K tiles load while its scores and
//   its PV dot run.  A tile past the slot's last row is not read.
// - Per page: each K tile's scores go to the page's score row [G, ps] in
//   shared memory (split_scores, the warp maxima kept across the page's
//   tiles); after the last one, m_new over the whole page, corr, and the
//   exps over all 128 threads, kept unrounded for the denominator and
//   rounded as bf16(e * vs) in place of the scores; each V tile adds its
//   rows' p.v into a page sum from zero (split_pv_any), and after the
//   page's last V tile acc = acc * corr + the page sum; the denominator's
//   sum (warp per query row, as dec_attend_rows) runs once per page beside
//   the first V tile: l = l * corr + sum e.
// - Shared memory: the ring, the queries as f32 and bf16, the page's scores
//   and unrounded exps (G * ps * 4 bytes each: 16 KB at G 8, ps 512), the
//   page scale rows (ks and vs of ps rows in as many slots as the ring can
//   reach ahead: split_page_scale_slots), the warp maxima and the state.
//   The ring takes the most tiles (at most six, at least two) that leave
//   an SM two blocks, else the most that fit one block: at G 4 and ps 512
//   two 256-row tiles and two blocks an SM ran faster on the H100 than six
//   tiles and one block.
//
// Rounding: per element the TPU kernel's at each of its points -- score
// dot(bf16(qs), f32(k)) in f32 times ks, p = exp(s - m_page) unnormalized,
// bf16(p * vs), f32 sums -- over the same blocks (whole pages).  The sums
// run in another order than XLA's (the PV dot tile by tile), so the kernel
// parts from its plain version by f32 noise and, rarely, one bf16 step of
// a p.  At more than one split each p rounds against its split's own
// running max: one bf16(p * vs) moves by at most one bf16 step, and an
// output is a convex combination of V rows, so the result stays within
// 2^-8 of max |out| of the sequential page walk (decode_split.cuh).
#pragma once

#include "decode_split.cuh"

// Page-scale slots: page jj's ks and vs rows land in slot jj % n with its K
// tiles and are read until its scores have been rounded (the iteration of
// its last K tile); the ring issues tile u + nt - 1 in iteration u, so the
// next page to use that slot, 2 * npt * n tiles later, lands after that
// when 2 * npt * n >= npt + nt - 1 (npt ring tiles a page).
__host__ __device__ __forceinline__ int split_page_scale_slots(int npt, int nt) {
    return (npt + nt - 1 + 2 * npt - 1) / (2 * npt);
}

// Shared memory of one block: the ring of nt tiles of T rows of pitch P,
// the G query rows as f32 and bf16, the page's scores (then p) and
// unrounded exps [G, ps], the page-scale slots [n][2][ps], each warp's
// score max, the online-softmax state, G ones (split_pv's rescale of the
// page sum) and the ticket.
struct PageSmem {
    unsigned char* ring;
    float *qf, *qb, *sc, *eb, *scales, *wmax, *m_s, *l_s, *c_s, *mn_s, *n_s, *one;
    int* last;
    int tile, ps;
    __device__ PageSmem(unsigned char* base, int nt, int T, int ps_, int P, int G)
        : ring(base), tile(T * P), ps(ps_) {
        qf = reinterpret_cast<float*>(base + static_cast<size_t>(nt) * tile);
        qb = qf + G * P;
        sc = qb + G * P;   // [G, ps] scores, then bf16(p * vs)
        eb = sc + G * ps;  // [G, ps] exp(s - m_new), unrounded
        scales = eb + G * ps;
        wmax = scales + split_page_scale_slots(ps / T, nt) * 2 * ps;
        m_s = wmax + (kDecThreads / 32) * kDecMaxG;
        l_s = m_s + kDecMaxG;
        c_s = l_s + kDecMaxG;   // the page's correction exp(m_old - m_new)
        mn_s = c_s + kDecMaxG;  // m_new
        n_s = mn_s + kDecMaxG;  // the fresh column's score
        one = n_s + kDecMaxG;
        last = reinterpret_cast<int*>(one + kDecMaxG);
    }
    __device__ int8_t* at(int s) const { return reinterpret_cast<int8_t*>(ring) + s * tile; }
    __device__ float* kst(int s) const { return scales + 2 * s * ps; }
    __device__ float* vst(int s) const { return scales + (2 * s + 1) * ps; }
    static __host__ __device__ long long bytes(int nt, int T, int ps, int P, int G) {
        return static_cast<long long>(nt) * T * P +
               4LL * (2 * G * P + 2LL * G * ps + 2LL * split_page_scale_slots(ps / T, nt) * ps +
                      (kDecThreads / 32 + 6) * kDecMaxG + 4);
    }
    // The ring's tiles: the most (at most kSplitTiles, at least 2) that let
    // an SM keep two blocks; else the most that fit one block; 0 if not even
    // two fit.
    static __host__ int tiles(int T, int ps, int P, int G) {
        for (int n = kSplitTiles; n >= 2; --n)
            if (bytes(n, T, ps, P, G) <= kSmemTwo) return n;
        for (int n = kSplitTiles; n >= 2; --n)
            if (bytes(n, T, ps, P, G) <= kSmemMax) return n;
        return 0;
    }
};

// One block of the page-block cell: split blockIdx.x of the (slot, kv head)
// whose G query rows are q [G, hd] (raw; qs = f32(q) / sqrt_hd), over its
// rows s < p of an INT8 pool (page j's K and V rows at kc / vc +
// rows_of(j) rows of hd elements, its scales ks / vs at the same row
// offset; rows_of is PagedRows with TS = ps), in ring tiles of T rows.
// kFresh (K20): the fresh row (nk, *nks, nv, *nvs; the scales read only
// there, so they hold no register through the walk) joins as one more
// column after the merge, in the TPU kernel's order; else (K22, the fresh
// pointers null) out = acc / max(l, 1e-30).  out [G, hd]; with splits > 1,
// ws is the (slot, kv head)'s [splits][G * hd + 2 * G] partials and ticket
// its counter.
template <typename QT, int CH, bool kFresh, class Rows>
__device__ void split_page_cell(unsigned char* smem, int nt, const QT* __restrict__ q,
                                const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                                const float* __restrict__ ks, const float* __restrict__ vs, int p,
                                int MP, int ps, int T, int G, int hd, int splits,
                                const int8_t* nk, const float* nks, const int8_t* nv,
                                const float* nvs, float* out, float* ws, int* ticket,
                                float sqrt_hd,
                                Rows rows_of) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int P = dec_pitch<int8_t>(hd);
    const int swz = P % 128 == 0 ? 7 : 0;
    const int npt = ps / T;  // ring tiles a whole page
    const int nps = split_page_scale_slots(npt, nt);
    const PageSmem sm(smem, nt, T, ps, P, G);
    const int j0 = static_cast<int>(static_cast<long long>(blockIdx.x) * MP / splits);
    const int j1 = min(static_cast<int>(static_cast<long long>(blockIdx.x + 1) * MP / splits),
                       (p + ps - 1) / ps);
    const int npg = max(j1 - j0, 0);  // the split's live pages
    const int nk_last = npg > 0 ? (min(ps, p - (j1 - 1) * ps) + T - 1) / T : 0;
    const int full = 2 * max(npg - 1, 0) * npt;  // tiles of the pages before the last
    const int ntl = npg > 0 ? full + 2 * nk_last : 0;

    // tile u of the walk: local page jj, a V tile or a K tile, its index i
    // in the page, the page's K tiles n
    auto where = [&](int u, int& jj, bool& is_v, int& i, int& n) {
        if (u < full) {
            jj = u / (2 * npt);
            n = npt;
            u -= jj * 2 * npt;
        } else {
            jj = npg - 1;
            n = nk_last;
            u -= full;
        }
        is_v = u >= n;
        i = is_v ? u - n : u;
    };
    // tile u into ring slot u % nt (a K tile with its rows' ks and vs into
    // the page's scale slot), one cp.async group each, empty past the walk
    auto issue = [&](int u) {
        if (u < ntl) {
            int jj, i, n;
            bool is_v;
            where(u, jj, is_v, i, n);
            const int j = j0 + jj;
            const int rows = min(T, p - j * ps - i * T);
            const long long r = rows_of(j) + static_cast<long long>(i) * T;
            split_copy_rows<CH>(sm.at(u % nt), (is_v ? vc : kc) + r * hd, rows, hd, P, swz);
            if (!is_v) {
                float* kd = sm.kst(jj % nps) + i * T;
                float* vd = sm.vst(jj % nps) + i * T;
                for (int x = tid; x < rows; x += kDecThreads) {
                    cp_async4(kd + x, ks + r + x);
                    cp_async4(vd + x, vs + r + x);
                }
            }
        }
        cp_async_commit();
    };

    // the pad columns (beside the bytes the copies write; the loop's first
    // barrier publishes them)
    if (P != hd) split_zero_pad(sm.at(0), nt * T, hd, P, swz);
    for (int u = 0; u < nt - 1; ++u) issue(u);
    dec_load_q(q, sm.qf, sm.qb, G, hd, P, sqrt_hd);
    if (tid < G) {
        sm.m_s[tid] = kNegInf;
        sm.l_s[tid] = 0.f;
    }
    if (tid < kDecMaxG) sm.one[tid] = 1.f;
    const int ne = (G * hd + kDecThreads - 1) / kDecThreads;
    float acc[kDecMaxE], pacc[kDecMaxE];  // the state's acc; the page's p.v from zero
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = pacc[j] = 0.f;

    for (int u = 0; u < ntl; ++u) {
        split_wait(nt - 2);  // tile u landed (its slot's copies, this thread's)
        __syncthreads();     // ... for every thread; tile u - 1's slot is free
        issue(u + nt - 1);
        int jj, i, n;
        bool is_v;
        where(u, jj, is_v, i, n);
        const int base = (j0 + jj) * ps;       // the page's first slot row
        const int rows_pg = min(ps, p - base);  // its rows < p
        const int sl = jj % nps;
        if (!is_v) {
            split_scores<int8_t, true>(sm.qb, sm.at(u % nt), sm.kst(sl) + i * T, sm.sc + i * T,
                                       ps, i > 0, sm.wmax, T, G, P, swz, base + i * T, p);
            if (i == n - 1) {
                __syncthreads();  // the page's scores and warp maxima
                // the page's max, correction and exps over all threads; p
                // rounded as bf16(e * vs) in place of the scores
                const float* vsr = sm.vst(sl);
                for (int g = 0; g < G; ++g) {
                    const float m_old = sm.m_s[g];
                    float blk = sm.wmax[g];
#pragma unroll
                    for (int w = 1; w < kDecThreads / 32; ++w)
                        blk = fmaxf(blk, sm.wmax[w * kDecMaxG + g]);
                    const float m_new = fmaxf(m_old, blk);
                    if (tid == 0) {
                        sm.c_s[g] = expf(m_old - m_new);
                        sm.mn_s[g] = m_new;
                    }
                    float* sr = sm.sc + g * ps;
                    float* er = sm.eb + g * ps;
                    for (int r = tid; r < rows_pg; r += kDecThreads) {
                        const float e = expf(sr[r] - m_new);
                        er[r] = e;
                        sr[r] = round_bf16(e * vsr[r]);
                    }
                }
            }
        } else {
            if (i == 0) {  // the page's denominator, warp g on query row g
                for (int g = warp; g < G; g += kDecThreads / 32) {
                    const float* er = sm.eb + g * ps;
                    float sum = 0.f;
                    for (int r = lane; r < rows_pg; r += 32) sum += er[r];
                    sum = warp_sum(sum);
                    if (lane == 0) {
                        sm.l_s[g] = sm.l_s[g] * sm.c_s[g] + sum;
                        sm.m_s[g] = sm.mn_s[g];
                    }
                }
            }
            split_pv_any(ne, sm.sc + i * T, ps, sm.at(u % nt), min(T, rows_pg - i * T), G, hd, P,
                         swz, sm.one, pacc);
            if (i == n - 1) {  // acc = acc * corr + the page's p.v
#pragma unroll
                for (int j = 0; j < kDecMaxE; ++j) {
                    const int e = tid + kDecThreads * j;
                    if (e < G * hd) acc[j] = acc[j] * sm.c_s[e / hd] + pacc[j];
                    pacc[j] = 0.f;
                }
            }
        }
    }
    cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)
    __syncthreads();     // m, l (and q when no page ran)

    float m_fin[kDecMaxE], l_fin[kDecMaxE];
    if (!split_finish(sm.m_s, sm.l_s, sm.last, G, hd, static_cast<int>(blockIdx.x), splits, ws,
                      ticket, acc, m_fin, l_fin))
        return;
    if constexpr (!kFresh) {  // K22: write-then-attend, no fresh column
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            if (e < G * hd) out[e] = acc[j] / fmaxf(l_fin[j], 1e-30f);
        }
        return;
    }
    // K20: the fresh column as the TPU kernel merges it at its last block
    // (attention.py:97-121): e_new scaled by nvs before the product with nv
    dec_fresh_scores(sm.qf, P, nk, *nks, G, hd, sm.n_s);
    __syncthreads();
    const float nvs_ = *nvs;
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            const float m = m_fin[j], s_new = sm.n_s[e / hd];
            const float mf = fmaxf(m, s_new);
            const float corr = expf(m - mf);
            const float e_new = expf(s_new - mf);
            const float lf = l_fin[j] * corr + e_new;
            out[e] = (acc[j] * corr + (e_new * nvs_) * to_f32(nv[e % hd])) / fmaxf(lf, 1e-30f);
        }
    }
}

// Launch a page-block kernel `kern` (its arguments `args`, which end with
// the ring's tile count nt) on the grid (splits, KVH, B): the ring sized by
// PageSmem::tiles, the shared memory attribute raised as needed.
template <class Kernel, class... Args>
__host__ int split_page_launch(Kernel kern, int splits, int KVH, int B, int T, int ps, int hd,
                               int G, cudaStream_t st, Args... args) {
    const int P = dec_pitch<int8_t>(hd);
    const int nt = PageSmem::tiles(T, ps, P, G);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(PageSmem::bytes(nt, T, ps, P, G));
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(splits, KVH, B), kDecThreads, bytes, st>>>(args..., nt);
    return static_cast<int>(cudaGetLastError());
}

// res[0] = the blocks one SM keeps resident for a launch of `kern` at these
// shapes (CUDA's occupancy query), res[1] its ring's tiles, res[2] its
// shared memory bytes.
template <class Kernel>
__host__ int split_page_residency(Kernel kern, int G, int hd, int T, int ps, int* res) {
    const int P = dec_pitch<int8_t>(hd);
    const int nt = PageSmem::tiles(T, ps, P, G);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(PageSmem::bytes(nt, T, ps, P, G));
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[0], kern, kDecThreads, bytes);
    res[1] = nt;
    res[2] = bytes;
    return static_cast<int>(err);
}
