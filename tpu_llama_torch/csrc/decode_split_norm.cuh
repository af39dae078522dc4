// The normalized split decode cell of K19 (flash_decode_fresh.cu, kFresh:
// the deferred-flush form with the step's fresh row as one more column)
// and K21's single-pass form (flash_decode.cu, the write-then-attend form),
// over an INT8, f32 or bf16 cache (CT).
//
// Why split: one block per (kv head, slot) leaves most of the card's 132
// SMs idle at a GQA group (B 8, KVH 8: 64 blocks) or one slot (B 1: 32
// blocks), and each block's walk over its rows is a chain of short
// latency-bound tile steps.
//
// What it computes, kept from the TPU kernels (tpu_llama/ops/attention.py
// _flash_decode_fresh_kernel :127, _flash_decode_simple_kernel :569): the
// G query rows of a (slot, kv head) attend its cache rows s < p of layer
// `layer` (K19: p = pos, and the fresh row as one extra column; K21: p =
// pos + 1).  The cache score is dot(bf16(qs), k) in f32 times ks for an
// INT8 cache, dot(qs, f32(k)) for an fp one (no scales); K19's fresh score
// takes the unrounded f32 qs, times nks.  m is the max over every score
// (and the fresh one), e = exp(s - m), l = sum(e) (+ e_new), and p = e / l
// is NORMALIZED before it is rounded, as bf16(p * vs), for the PV dot (an
// fp cache keeps p in f32); K19 adds (e_new / l * nvs) * f32(nv).  That
// rounding point is what sets these kernels apart from K9, which rounds an
// unnormalized p against its key block's running max: so every split here
// must know the global m and l before any of them rounds a p.
//
// Bound on the H100: bytes, each (slot, kv head) reads p rows of K and V
// (and their two f32 scales for INT8).  Design:
// - Split over the key rows in one thread-block cluster.  The grid is
//   (splits, KVH, B) and the cluster (splits, 1, 1), so the splits of a
//   (slot, kv head) are scheduled together and read each other's shared
//   memory.  The slot's S rows fall into blocks = ceil(S / TS) ring tiles
//   and split i takes the tiles [i * blocks / splits, (i + 1) * blocks /
//   splits), clipped to the slot's p (ops/attention.py split_spans; the
//   count from norm_splits, at most kNormClusterMax, the portable cluster
//   size).  A split whose span starts at or past p loads nothing but joins
//   every cluster barrier.
// - One load stream a split: its span's K tiles, then its V tiles, through
//   decode_split.cuh's ring (as many tiles as leave an SM three blocks for
//   clusters of 4 or 8, two otherwise, where the span's scores allow), each
//   tile one cp.async group issued as soon as its slot is free.  The V tiles do not wait for the statistics: they
//   land while the scores are taken and while the cluster agrees on m and l.
// - The scores (split_scores: dec_qk_tile's arithmetic, two lanes a row)
//   of the whole span stay in shared memory, [G, span] f32.  Each rank's
//   max goes to its shared memory; after a cluster barrier every rank reads
//   all of them (distributed shared memory) and takes m.  One exp a score,
//   over all 128 threads, in place; each rank's sum l_i is exchanged the
//   same way and every rank adds them in rank order (K19: + e_new last).
//   Then p = e / l (IEEE division, as the TPU kernel's `/`), bf16(p * vs)
//   for INT8, and split_pv runs the span's V tiles into acc [G, hd] f32.
// - The merge: each rank writes acc to its shared memory; after a cluster
//   barrier rank r sums slice r of [G, hd] over the ranks in rank order,
//   adds K19's fresh column and writes out; a last barrier keeps every block
//   alive while another may still read its shared memory.  At one split no
//   cluster is launched and the block writes out from its registers.
//
// Numerically the splits change only the f32 order of l and of the PV
// partials, never a rounding point.  p = 0 (K21 at a negative pos) attends
// nothing: zeros, where the TPU kernel averages every row.
#pragma once

#include "decode_split.cuh"
#include "hopper.cuh"

constexpr int kNormClusterMax = 8;  // the most splits: the portable cluster size
constexpr int kSmemThree = 76800;   // dynamic shared memory so that an SM keeps three blocks

// The generic address of the variable at p (in this block's shared memory)
// in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ const float* norm_peer(const float* p, unsigned rank) {
    unsigned long long d;
    asm volatile("mapa.u64 %0, %1, %2;\n"
                 : "=l"(d)
                 : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
    return reinterpret_cast<const float*>(d);
}

// Shared memory of one block: the ring of `nt` tiles of TS rows of pitch P
// (split_swz's chunks), the G query rows as f32 and as bf16, the span's
// scores [G, ld] (then e, then p), for INT8 the span's two scale rows
// [ld] each, each warp's max (then sum) per query row, the statistics
// (this rank's m and l as the cluster reads them, the global m and l, a
// row of ones for split_pv's correction, the fresh score, e_new) and, at
// more than one split, this rank's acc [G, hd] for the merge.
template <typename CT>
struct NormSmem {
    static constexpr bool kInt8 = sizeof(CT) == 1;
    unsigned char* ring;
    float *qf, *qb, *sc, *kscale, *vscale, *wpart, *m_x, *l_x, *m_s, *l_s, *ones, *n_s, *e_s,
        *accb;
    int tile;  // elements of one tile
    __device__ NormSmem(unsigned char* base, int nt, int TS, int P, int G, int ld) : ring(base) {
        tile = TS * P;
        qf = reinterpret_cast<float*>(base + static_cast<size_t>(nt) * tile * sizeof(CT));
        qb = qf + G * P;
        sc = qb + G * P;
        kscale = sc + G * ld;
        vscale = kscale + (kInt8 ? ld : 0);
        wpart = vscale + (kInt8 ? ld : 0);
        m_x = wpart + (kDecThreads / 32) * kDecMaxG;
        l_x = m_x + kDecMaxG;
        m_s = l_x + kDecMaxG;
        l_s = m_s + kDecMaxG;
        ones = l_s + kDecMaxG;
        n_s = ones + kDecMaxG;
        e_s = n_s + kDecMaxG;
        accb = e_s + kDecMaxG;
    }
    __device__ CT* at(int s) const { return reinterpret_cast<CT*>(ring) + s * tile; }
    static __host__ __device__ int bytes(int nt, int TS, int P, int G, int hd, int ld,
                                         bool merge) {
        return nt * TS * P * static_cast<int>(sizeof(CT)) +
               4 * (2 * G * P + G * ld + (kInt8 ? 2 * ld : 0) +
                    (kDecThreads / 32 + 7) * kDecMaxG + (merge ? G * hd : 0));
    }
    // The ring's tiles: the most (at most kSplitTiles, and no more than the
    // span's 2 * ld / TS tiles, at least 2) that let an SM keep three blocks
    // for clusters of more than two, else two blocks; else the most that fit
    // one block; 0 if not even two fit (the span's G x ld scores too many:
    // the launch is refused).  Three: the split rule fills the card's 264
    // two-an-SM slots, but clusters of 4 or 8 blocks fit only 248 or 240 of
    // them (cudaOccupancyMaxActiveClusters on the H100), so the rest ran as
    // a second wave; a shallower ring cost less than that wave.
    static __host__ int tiles(int TS, int P, int G, int hd, int ld, int splits) {
        const bool merge = splits > 1;
        const int span = 2 * (ld / TS) < 2 ? 2 : 2 * (ld / TS);
        const int top = span < kSplitTiles ? span : kSplitTiles;
        const int caps[3] = {splits > 2 ? kSmemThree : kSmemTwo, kSmemTwo, kSmemMax};
        for (int cap : caps)
            for (int n = top; n >= 2; --n)
                if (bytes(n, TS, P, G, hd, ld, merge) <= cap) return n;
        return 0;
    }
};

// A ring tile of TS rows over caches of S: one tile of all S rows, or
// several of a multiple of 8 rows (split_pv then reads each tile's p as
// aligned float4s).
__host__ __device__ __forceinline__ bool norm_tile_ok(int S, int TS) {
    return S >= 1 && TS >= 1 && (TS == S || (TS < S && TS % 8 == 0));
}

// The row stride of a split's scores: the longest span's rows,
// ceil(ceil(S / TS) / splits) tiles of TS.
__host__ __device__ __forceinline__ int norm_ld(int S, int TS, int splits) {
    const int blocks = (S + TS - 1) / TS;
    return (blocks + splits - 1) / splits * TS;
}

// One block of the cell: split blockIdx.x (its cluster rank) of the (slot,
// kv head) whose G query rows are q [G, hd] (raw; qs = f32(q) / sqrt_hd),
// over the cache rows s < p at kc / vc (rows of hd elements from the slot's
// s = 0, an INT8 cache's scales at ks / vs from the same row), and for
// kFresh the fresh row (nk, nks, nv, nvs; the scales 1 for an fp cache) as
// one more column; out [G, hd].  Every thread of every block of the cluster
// runs it to its end: it holds cluster barriers.
template <typename QT, typename CT, int CH, bool kFresh>
__device__ void norm_decode_cell(unsigned char* smem, int nt, const QT* __restrict__ q,
                                 const CT* __restrict__ kc, const CT* __restrict__ vc,
                                 const float* __restrict__ ks, const float* __restrict__ vs,
                                 int p, int S, int TS, int G, int hd, int splits, const CT* nk,
                                 float nks, const CT* nv, float nvs, float* out, float sqrt_hd) {
    constexpr bool kInt8 = sizeof(CT) == 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int P = dec_pitch<CT>(hd);
    const int swz = (P * static_cast<int>(sizeof(CT))) % 128 == 0 ? 7 : 0;
    const int ld = norm_ld(S, TS, splits);
    const NormSmem<CT> sm(smem, nt, TS, P, G, ld);
    const int rank = blockIdx.x;
    const int blocks = (S + TS - 1) / TS;
    const int j0 = rank * blocks / splits;
    const int j1 = min((rank + 1) * blocks / splits, (p + TS - 1) / TS);
    const int nb = max(j1 - j0, 0);                          // the span's tiles
    const int r0 = j0 * TS;                                  // its first row
    const int rows = nb > 0 ? min(j1 * TS, p) - r0 : 0;      // its rows below p

    // tile t of the stream is the span's K tile t for t < nb (the span's
    // scale rows ride with tile 0), its V tile t - nb below 2 * nb, in ring
    // slot t % nt; one cp.async group each, empty past the stream
    auto issue = [&](int t) {
        if (t < 2 * nb) {
            const int j = t < nb ? t : t - nb;
            const long long r = r0 + static_cast<long long>(j) * TS;
            split_copy_rows<CH>(sm.at(t % nt), (t < nb ? kc : vc) + r * hd,
                                min(TS, rows - j * TS), hd, P, swz);
            if constexpr (kInt8) {
                if (t == 0) {
                    for (int i = tid; i < rows; i += kDecThreads) {
                        cp_async4(sm.kscale + i, ks + r0 + i);
                        cp_async4(sm.vscale + i, vs + r0 + i);
                    }
                }
            }
        }
        cp_async_commit();
    };

    if (P != hd) split_zero_pad(reinterpret_cast<CT*>(sm.ring), nt * TS, hd, P, swz);
    for (int t = 0; t < nt - 1; ++t) issue(t);
    dec_load_q(q, sm.qf, sm.qb, G, hd, P, sqrt_hd);
    if (tid < kDecMaxG) sm.ones[tid] = 1.f;
    __syncthreads();  // q
    if (kFresh) dec_fresh_scores(sm.qf, P, nk, nks, G, hd, sm.n_s);

    // the span's scores, each warp's max of them per query row
    for (int t = 0; t < nb; ++t) {
        split_wait(nt - 2);
        __syncthreads();  // tile t landed; the slot of tile t - 1 is free
        issue(t + nt - 1);
        split_scores<CT, kInt8>(kInt8 ? sm.qb : sm.qf, sm.at(t % nt), sm.kscale + t * TS,
                                sm.sc + t * TS, ld, t > 0, sm.wpart, TS, G, P, swz, t * TS,
                                rows);
    }
    __syncthreads();  // the scores, the warps' maxima, the fresh score

    // m: every rank's max (K19's fresh score folded into each), then the max
    // over the cluster
    if (tid < G) {
        float m = kFresh ? sm.n_s[tid] : kNegInf;
        if (nb > 0) {
#pragma unroll
            for (int w = 0; w < kDecThreads / 32; ++w) m = fmaxf(m, sm.wpart[w * kDecMaxG + tid]);
        }
        sm.m_x[tid] = m;
    }
    if (splits > 1) {
        cluster_sync();  // every rank's max is written
        if (tid < G) {
            float m = kNegInf;
            for (int i = 0; i < splits; ++i) m = fmaxf(m, norm_peer(sm.m_x, i)[tid]);
            sm.m_s[tid] = m;
        }
    } else if (tid < G) {
        sm.m_s[tid] = sm.m_x[tid];
    }
    __syncthreads();  // m

    // e = exp(s - m) in place, one exp a score over every thread; this
    // rank's sum l_i per query row
    float part[kDecMaxG];
#pragma unroll
    for (int g = 0; g < kDecMaxG; ++g) {
        part[g] = 0.f;
        if (g >= G) continue;
        const float m = sm.m_s[g];
        float* sr = sm.sc + g * ld;
        for (int r = tid; r < rows; r += kDecThreads) {
            const float e = expf(sr[r] - m);
            sr[r] = e;
            part[g] += e;
        }
    }
#pragma unroll
    for (int g = 0; g < kDecMaxG; ++g) {
        if (g >= G) break;
        const float s = warp_sum(part[g]);
        if (lane == 0) sm.wpart[warp * kDecMaxG + g] = s;
    }
    __syncthreads();  // the warps' sums (their maxima were read before the barrier on m)
    if (tid < G) {
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < kDecThreads / 32; ++w) l += sm.wpart[w * kDecMaxG + tid];
        sm.l_x[tid] = l;
    }
    if (splits > 1) cluster_sync();  // every rank's sum is written
    else __syncthreads();
    if (tid < G) {  // l in rank order, K19's e_new last
        float l = 0.f;
        for (int i = 0; i < splits; ++i) l += splits > 1 ? norm_peer(sm.l_x, i)[tid] : sm.l_x[tid];
        if (kFresh) {
            const float e_new = expf(sm.n_s[tid] - sm.m_s[tid]);
            sm.e_s[tid] = e_new;
            l += e_new;
        }
        sm.l_s[tid] = l;
    }
    __syncthreads();  // l

    // p = e / l, bf16(p * vs) for INT8, in place (l > 0 wherever a row is)
#pragma unroll
    for (int g = 0; g < kDecMaxG; ++g) {
        if (g >= G) break;
        const float l = sm.l_s[g];
        float* sr = sm.sc + g * ld;
        for (int r = tid; r < rows; r += kDecThreads) {
            const float pn = sr[r] / l;
            sr[r] = kInt8 ? round_bf16(pn * sm.vscale[r]) : pn;
        }
    }

    // the PV dot over the span's V tiles (rows in order from zero within a
    // tile, then added to acc: split_pv's order with a correction of 1)
    const int ne = (G * hd + kDecThreads - 1) / kDecThreads;
    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;
    for (int t = nb; t < 2 * nb; ++t) {
        split_wait(nt - 2);
        __syncthreads();  // V tile t - nb landed (and p stored)
        issue(t + nt - 1);
        const int v = t - nb;
        split_pv_any(ne, sm.sc + v * TS, ld, sm.at(t % nt), min(TS, rows - v * TS), G, hd, P,
                     swz, sm.ones, acc);
    }
    cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)

    // the fresh column's weight of query row g: (e_new / l) * nvs
    auto p_new = [&](int g) {
        const float w = sm.e_s[g] / sm.l_s[g];
        return kInt8 ? w * nvs : w;
    };
    if (splits == 1) {
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            if (e < G * hd)
                out[e] = kFresh ? acc[j] + p_new(e / hd) * to_f32(nv[e % hd]) : acc[j];
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) sm.accb[e] = acc[j];
    }
    cluster_sync();  // every rank's acc is written
    const int E = G * hd, lo = rank * E / splits, hi = (rank + 1) * E / splits;
    for (int e = lo + tid; e < hi; e += kDecThreads) {
        float a = norm_peer(sm.accb, 0)[e];
        for (int i = 1; i < splits; ++i) a += norm_peer(sm.accb, i)[e];
        out[e] = kFresh ? a + p_new(e / hd) * to_f32(nv[e % hd]) : a;
    }
    cluster_sync();  // no block leaves while another may still read its shared memory
}

// The shared memory and ring of a launch (0 tiles: refused).
template <typename CT>
__host__ void norm_plan(int G, int hd, int S, int TS, int splits, int* nt, int* bytes) {
    const int P = dec_pitch<CT>(hd), ld = norm_ld(S, TS, splits);
    *nt = NormSmem<CT>::tiles(TS, P, G, hd, ld, splits);
    *bytes = *nt == 0 ? 0 : NormSmem<CT>::bytes(*nt, TS, P, G, hd, ld, splits > 1);
}

// The launch configuration of a cell kernel: grid (splits, KVH, B), a
// cluster of the splits (none at one split, or always with `cluster`).
struct NormLaunch {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    NormLaunch(int splits, int KVH, int B, int bytes, cudaStream_t st, bool cluster) {
        cfg.gridDim = dim3(splits, KVH, B);
        cfg.blockDim = dim3(kDecThreads);
        cfg.dynamicSmemBytes = bytes;
        cfg.stream = st;
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = splits;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = cluster || splits > 1 ? 1 : 0;
    }
};

// Launch `kern` (a wrapper of norm_decode_cell) with `bytes` of dynamic
// shared memory (the attribute set once per kernel and card,
// split_smem_attr), or refuse.
template <class Kern, class... Args>
int norm_launch(Kern kern, int nt, int bytes, int splits, int KVH, int B, cudaStream_t st,
                Args... args) {
    if (nt == 0 || splits < 1 || splits > kNormClusterMax)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    NormLaunch l(splits, KVH, B, bytes, st, false);
    err = cudaLaunchKernelEx(&l.cfg, kern, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// res[0] = the blocks of `kern` one SM keeps resident, res[1] the ring's
// tiles, res[2] the shared memory bytes, res[3] the clusters of `splits`
// blocks the card keeps resident at once (CUDA's occupancy queries at the
// launch's shape).
template <class Kern>
int norm_residency(Kern kern, int nt, int bytes, int splits, int KVH, int B, int* res) {
    if (nt == 0 || splits < 1 || splits > kNormClusterMax)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[0], kern, kDecThreads, bytes);
    res[1] = nt;
    res[2] = bytes;
    NormLaunch l(splits, KVH, B, bytes, nullptr, true);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&res[3], kern, &l.cfg);
    return static_cast<int>(err);
}
