// The split tensor-core cells of causal prefill attention over an fp
// (float32 or bfloat16) K/V cache: K6's fp forms (flash_prefill.cu).  K6's
// INT8 form and K16 run prefill_mma.cuh's bf16 cell, whose key tiles,
// causal tile skip, mask, fragment loads and output staging these follow.
//
// Contract: the JAX package's fp branch (tpu_llama/ops/attention.py
// :1613-1640) is f32 dots and f32 p, nothing rounded to bf16; the plain
// version is ops/attention.py `attention_prefill` (one pass, f32):
//   s = (q . k) / sqrt_f32(hd), key s attending query t iff s <= start + t
//   and s < S; p = exp(s - m) in f32
//   over an online softmax (m, l, corr as prefill_mma.cuh's), p unrounded;
//   out = (sum p v) / max(l, 1e-30), cast once to the output type.
// A plain bf16 tensor-core dot would round q and p; an f32 SIMT dot runs at
// ~1/15 of the tensor-core rate.  Both cells take each f32 dot as a sum of
// tensor-core products of split operands:
//   * bf16 cache (attend_bf16, mma.sync m16n8k16 bf16): K and V are bf16
//     values, exact as they are.  An f32 value x splits into three bf16
//     terms hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
//     whose sum is x exactly (outside the subnormal range); each bf16 x
//     bf16 product is exact in f32.  So q . k is three passes (one for bf16
//     q) and p . v three, every partial product exact.
//   * f32 cache (attend_tf32, mma.sync m16n8k8 TF32): x splits into big =
//     x truncated to TF32 (its low 13 bits cleared) and small = x - big
//     (exact in f32), which the mma reads truncated to TF32: |x - big -
//     small| <= 2^-20 |x|; x . y = big.big + small.big + big.small,
//     dropping small.small (<= 2^-20 |x y|): three passes (two for bf16 q),
//     each product exact in f32.  (Rounding big and small to nearest would
//     cut the 2^-20 to 2^-22 at a conversion each; the cell is bound by its
//     instructions, and 2^-20 is ~50x below FP_TOL.)
// The tensor cores add a pass's products into the accumulator without
// rounding to nearest, which over a 128-long dot or a run of 64-key tiles
// moved outputs by ~1e-5 of the peak; so each chain of passes (four k16
// steps for bf16; four k8 steps of QK^T and two of PV for TF32) starts
// from zero and is added to the running sum in f32.  The result agrees
// with the plain version to f32 noise (FP_TOL in chip_smoke.py: 1e-5 of the
// peak output).  exp runs as ex2 in log2 units (the dot times log2(e) /
// sqrt(hd) in one rounding; ex2.approx: within a few f32 ulps).
// tests/test_torch_split_dot.py holds the split identities.
//
// Design, shared by both cells:
//   * One block of NW warps per (kv head, slot, tile of 16 NW folded query
//     rows r = t * G + g), the heaviest causal tile first; each warp owns 16
//     rows.  The launcher takes NW = 8 where that still gives every SM a
//     block, else 4 (the B2 x 128 continuation shape).
//   * K and V tiles of kBC = 64 keys come by 16-byte cp.async straight into
//     shared memory in the cache's own type through a ring of two stages (no
//     conversion pass).
//   * Scores, mask and online softmax as prefill_mma.cuh's, in registers;
//     the output is normalised once, staged in shared memory and written 16
//     bytes a lane.
// The block's q rows come first, in one round of 16-byte cp.async copies
// into the (still free) stages, and are converted from there (element by
// element loads had kept each warp waiting on them one by one).
// attend_bf16: the block's q rows are split once into their bf16 terms in
// shared memory; K's B fragments come by ldmatrix, V's by ldmatrix.trans
// (as prefill_mma.cuh's), and p's terms are packed from S's accumulators
// into PV's A fragments.
// attend_tf32: q stays f32 in shared memory, and each warp loads its
// fragments with 32- or 64-bit shared loads and splits them in registers.
// The k order inside each 8-wide step is permuted, the same for A and B:
// logical k = tg holds element 2 tg, k = tg + 4 element 2 tg + 1 (a dot does
// not depend on the order of its terms), so that q's and K's fragment pairs
// are one 64-bit load, and S's accumulator fragment (c0, c2, c1, c3) is PV's
// A fragment as it stands, with V's rows 2 tg and 2 tg + 1 as B.  Pitches
// (words mod 32): q and K HDP + 8 (8), V HDP + 4 (4): conflict-free.
// Bound on the H100: tensor-core operations (the pass count times the causal
// dots' operations, bf16 at 989 or TF32 at 495 TFLOP/s) at the served
// shapes; PERF.md states it beside the f32 SIMT bound.
#pragma once

#include <math.h>

#include "prefill_mma.cuh"

namespace prefill_split {

using prefill_mma::div_rn;
using prefill_mma::ex2;
using prefill_mma::kBC;  // keys per tile, as the bf16 cell's
using prefill_mma::ldsm_x4;
using prefill_mma::ldsm_x4_trans;
using prefill_mma::mma_bf16;
using prefill_mma::pack_bf16;
using prefill_mma::smem_addr;

constexpr int kStages = 2;

// d = a (16 x 16, row) * b (16 x 8, col), bf16 in: a chain's first pass
// (the zero C folds into the instruction)
__device__ __forceinline__ void mma_bf16_z(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                           unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Shared-memory pitches in elements.
template <int HDP>
constexpr int kPitB = HDP + 8;  // bf16 rows (q terms, K, V): 16 bytes apart in the banks
template <int HDP>
constexpr int kPitQ = HDP + 8;  // f32 q and K rows of the TF32 cell
template <int HDP>
constexpr int kPitV = HDP + 4;  // f32 V rows of the TF32 cell

// Shared memory in bytes: the q rows, then the stages.
template <int HDP, int NW, typename QT, typename KT>
constexpr int kQBytes = sizeof(KT) == 2
                            ? (sizeof(QT) == 4 ? 3 : 1) * 16 * NW * kPitB<HDP> * 2
                            : 16 * NW * kPitQ<HDP> * 4;
template <int HDP, typename KT>
constexpr int kStageBytes = sizeof(KT) == 2 ? 2 * kBC * kPitB<HDP> * 2
                                            : kBC * (kPitQ<HDP> + kPitV<HDP>) * 4;
template <int HDP, int NW, typename QT, typename KT>
constexpr int kSmemBytes = kQBytes<HDP, NW, QT, KT> + kStages * kStageBytes<HDP, KT>;

template <int HDP, typename KT>
constexpr int kPitK_ = sizeof(KT) == 2 ? kPitB<HDP> : kPitQ<HDP>;
template <int HDP, typename KT>
constexpr int kPitV_ = sizeof(KT) == 2 ? kPitB<HDP> : kPitV<HDP>;

// The key source (`Keys`): where key c's K and V rows are and which keys
// exist --
//   int kend(int e)            the end of the keys to walk, given e = start +
//                              the block's last row's t + 1;
//   bool ok(int c)             key c exists (besides the causal rule);
//   bool all_ok(int c0)        every key of the tile [c0, c0 + kBC) exists;
//   const KT* k_row(int c), v_row(int c)   key c's rows (c must exist).

// The tile [c0, c0 + kBC)'s K and V rows into one stage: zero past hd and
// for keys that do not exist.  16-byte cp.async copies where `vec`, else
// element by element.
template <int HDP, int NT, typename KT, class Keys>
__device__ __forceinline__ void copy_tile(const Keys& keys, int c0, KT* Ks, KT* Vs, int hd,
                                          bool vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(KT));  // elements a copy
    constexpr int kChunks = HDP / E, PK = kPitK_<HDP, KT>, PV = kPitV_<HDP, KT>;
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll 4
        for (int e = tid; e < 2 * kBC * kChunks; e += NT) {
            const int row = e / kChunks, o = (e % kChunks) * E;  // row: K keys, then V
            const int c = c0 + row % kBC;
            const bool in = keys.ok(c) && o < hd;
            const KT* src = row < kBC ? keys.k_row(in ? c : 0) : keys.v_row(in ? c : 0);
            KT* dst = row < kBC ? Ks + row * PK + o : Vs + (row - kBC) * PV + o;
            cp_async16(dst, in ? src + o : src, in ? 16 : 0);
        }
    } else {
        for (int e = tid; e < 2 * kBC * HDP; e += NT) {
            const int row = e / HDP, d = e % HDP;
            const int c = c0 + row % kBC;
            const bool in = keys.ok(c) && d < hd;
            KT* dst = row < kBC ? Ks + row * PK + d : Vs + (row - kBC) * PV + d;
            *dst = in ? (row < kBC ? keys.k_row(c) : keys.v_row(c))[d] : KT(0.f);
        }
    }
}

// One key tile's scores -> probabilities in place (s * log2(e) / sqrt(hd):
// log2 units, the mask where the tile needs one, the online softmax): rescales
// l and o by the running max's correction.  s[n][j] sits at row gr + 8 (j /
// 2), key n * 8 + 2 tg + j % 2 -- the C layout of both mma shapes.
template <int NS, int NO, class Keys>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&o)[NO][4], const Keys& keys, int c0,
                                             bool full, const int (&qpos)[2], float sqrt_hd,
                                             float rq, int tg) {
    constexpr float kLog2e = 1.4426950408889634f;
    const float scale = rq * kLog2e;  // log2(e) / sqrt(hd)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n * 8 + 2 * tg + (j & 1), i = j >> 1;
            float v = s[n][j] * scale;
            if (!full && !(c0 + c <= qpos[i] && keys.ok(c0 + c))) v = -INFINITY;
            s[n][j] = v;
            mx[i] = fmaxf(mx[i], v);
        }
    float corr[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        base[i] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: corr = p = 0
        corr[i] = ex2(m[i] - base[i]);
        m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float p = ex2(s[n][j] - base[j >> 1]);
            sum[j >> 1] += p;
            s[n][j] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];  // this lane's columns
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
    }
}

// out = acc / max(l, 1e-30) over the quad's columns, staged as OT rows in
// shared memory (`stage`, free by now) and written 16 bytes a lane.
template <int HDP, int NW, typename OT>
__device__ __forceinline__ void store_out(float (&o)[HDP / 8][4], float (&l)[2], OT* out,
                                          unsigned char* stage, int r0, int rows, int T, int NH,
                                          int G, int h, int b, int hd) {
    constexpr int NO = HDP / 8, NT = 32 * NW, kBR = 16 * NW;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    constexpr int OP = HDP + 16 / static_cast<int>(sizeof(OT));  // Os pitch in elements
    OT* Os = reinterpret_cast<OT*>(stage);
    __syncthreads();  // every warp is done with the shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float den = fmaxf(l[i], 1e-30f), rd = __frcp_rn(den);
        OT* dst = Os + (warp * 16 + gr + 8 * i) * OP;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            store_pair(dst + n * 8 + 2 * tg, div_rn(o[n][2 * i], den, rd),
                       div_rn(o[n][2 * i + 1], den, rd));
    }
    __syncthreads();
    constexpr int kPer = 16 / static_cast<int>(sizeof(OT));  // elements a 16-byte store
    const bool ovec = hd % kPer == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int e = tid; e < kBR * (HDP / kPer); e += NT) {
        const int r = e / (HDP / kPer), d0 = (e % (HDP / kPer)) * kPer, row = r0 + r;
        if (row >= rows || d0 >= hd) continue;
        OT* dst = out + (((long long)b * T + row / G) * NH + h * G + row % G) * hd + d0;
        const OT* src = Os + r * OP + d0;
        if (ovec) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            for (int j = 0; j < kPer && d0 + j < hd; ++j) dst[j] = src[j];
        }
    }
}

// The block's q rows raw, [kBR][HDP] of QT (zero past hd and the last
// row), into `raw` (the stages, free before the first key tile's copy): one
// round of 16-byte cp.async copies where `qvec`, else element by element;
// every thread's copies have landed and are visible on return.
template <int HDP, int NW, typename QT>
__device__ __forceinline__ void stage_q(const QT* __restrict__ q, QT* raw, int r0, int rows,
                                        int T, int NH, int G, int h, int b, int hd, bool qvec) {
    constexpr int E = 16 / static_cast<int>(sizeof(QT)), NT = 32 * NW, kBR = 16 * NW;
    const int tid = threadIdx.x;
    auto src_row = [&](int row) {
        return q + (((long long)b * T + row / G) * NH + h * G + row % G) * hd;
    };
    if (qvec) {
#pragma unroll 4
        for (int e = tid; e < kBR * HDP / E; e += NT) {
            const int r = e / (HDP / E), d = (e % (HDP / E)) * E, row = r0 + r;
            const bool in = row < rows && d < hd;
            const QT* src = src_row(in ? row : r0);
            cp_async16(raw + r * HDP + d, in ? src + d : src, in ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
    } else {
        for (int e = tid; e < kBR * HDP; e += NT) {
            const int r = e / HDP, d = e % HDP, row = r0 + r;
            raw[r * HDP + d] = row < rows && d < hd ? src_row(row)[d] : QT(0.f);
        }
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// The bf16 cache: three bf16 terms of each f32 operand, bf16 m16n8k16
// ---------------------------------------------------------------------------

// (x, y) as bf16 pairs of their three terms: hi, mid, lo (x = x_hi + x_mid +
// x_lo exactly, each term's value taken before the next is rounded).
__device__ __forceinline__ void split3(float x, float y, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
    hi = pack_bf16(x, y);
    x -= __uint_as_float(hi << 16);
    y -= __uint_as_float(hi & 0xffff0000u);
    mid = pack_bf16(x, y);
    x -= __uint_as_float(mid << 16);
    y -= __uint_as_float(mid & 0xffff0000u);
    lo = pack_bf16(x, y);
}

template <int HDP, int NW, typename QT, typename OT, class Keys>
__device__ __forceinline__ void attend_bf16(const QT* __restrict__ q, OT* __restrict__ out,
                                            const Keys& keys, int st, int T, int NH, int KVH,
                                            int hd, float sqrt_hd, bool vec, bool qvec) {
    using KT = __nv_bfloat16;
    static_assert(16 * NW * (HDP + 16 / sizeof(OT)) * sizeof(OT) <= kSmemBytes<HDP, NW, QT, KT>,
                  "the output tile fits the shared memory");
    static_assert(16 * NW * HDP * sizeof(QT) <= kStages * kStageBytes<HDP, KT>,
                  "the raw q rows fit the stages");
    constexpr int NQ = sizeof(QT) == 4 ? 3 : 1;  // q's bf16 terms
    constexpr int kChain = 4;                    // k16 steps a chain of passes spans
    constexpr int LDB = kPitB<HDP>;
    constexpr int KS = HDP / 16;  // k-steps of QK^T
    constexpr int NS = kBC / 8;   // n-tiles of S
    constexpr int NO = HDP / 8;   // n-tiles of O
    constexpr int NT = 32 * NW, kBR = 16 * NW;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    KT* Qs = reinterpret_cast<KT*>(smem_raw);  // [NQ][kBR][LDB]
    unsigned char* stages = smem_raw + kQBytes<HDP, NW, QT, KT>;
    auto ks_of = [&](int s) { return reinterpret_cast<KT*>(stages + s * kStageBytes<HDP, KT>); };
    auto vs_of = [&](int s) { return ks_of(s) + kBC * LDB; };

    const int G = NH / KVH;
    const int rows = T * G;
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = (gridDim.z - 1 - blockIdx.z) * kBR;  // the heaviest q tile first
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tg = lane & 3;
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row in it

    const int last_t = (min(r0 + kBR, rows) - 1) / G;
    const int n_tiles = (keys.kend(st + last_t + 1) + kBC - 1) / kBC;
    const int first_q = st + r0 / G;

    // the block's q rows, raw through the stages, then as their bf16 terms
    const QT* raw = reinterpret_cast<const QT*>(stages);
    stage_q<HDP, NW>(q, const_cast<QT*>(raw), r0, rows, T, NH, G, h, b, hd, qvec);
    for (int e = tid; e < kBR * HDP / 2; e += NT) {
        const int r = e / (HDP / 2), d = (e % (HDP / 2)) * 2;
        unsigned t[3];
        split3(to_f32(raw[r * HDP + d]), to_f32(raw[r * HDP + d + 1]), t[0], t[1], t[2]);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
            *reinterpret_cast<unsigned*>(Qs + (i * kBR + r) * LDB + d) = t[i];
    }
    __syncthreads();  // the stages are free again
    copy_tile<HDP, NT>(keys, 0, ks_of(0), vs_of(0), hd, vec);
    cp_async_commit();
    if (n_tiles > 1) copy_tile<HDP, NT>(keys, kBC, ks_of(1), vs_of(1), hd, vec);
    cp_async_commit();

    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = st + (r0 + warp * 16 + gr + 8 * i) / G;
    const float rq = __frcp_rn(sqrt_hd);
    const unsigned qa = smem_addr(Qs + (warp * 16 + (mi & 1) * 8 + mr) * LDB + (mi >> 1) * 8);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int c0 = tile * kBC;
        const int stage = tile % kStages;
        cp_async_wait<1>();
        __syncthreads();  // the tile (and, the first time, q) is in shared memory
        const KT* Kb = ks_of(stage);
        const KT* Vb = vs_of(stage);

        // S = Q K^T, this warp's 16 rows x 64 keys; each k-step's NQ passes
        // into zeroed registers, then added in f32
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < KS; k2 += kChain) {  // a chain: kChain k-steps' NQ passes
            unsigned a[kChain][NQ][4];
#pragma unroll
            for (int u = 0; u < kChain; ++u)
#pragma unroll
                for (int i = 0; i < NQ; ++i)
                    ldsm_x4(qa + (i * kBR * LDB + (k2 + u) * 16) * 2, a[u][i][0], a[u][i][1],
                            a[u][i][2], a[u][i][3]);
#pragma unroll
            for (int n = 0; n < NS; n += 2) {
                float t0[4], t1[4];
#pragma unroll
                for (int u = 0; u < kChain; ++u) {
                    unsigned b0, b1, b2, b3;
                    const int key = (n + (mi >> 1)) * 8 + mr, d = (k2 + u) * 16 + (mi & 1) * 8;
                    ldsm_x4(smem_addr(Kb + key * LDB + d), b0, b1, b2, b3);
#pragma unroll
                    for (int i = NQ - 1; i >= 0; --i) {  // lo, mid, then hi
                        if (u == 0 && i == NQ - 1) {
                            mma_bf16_z(t0, a[u][i], b0, b1);
                            mma_bf16_z(t1, a[u][i], b2, b3);
                        } else {
                            mma_bf16(t0, a[u][i], b0, b1);
                            mma_bf16(t1, a[u][i], b2, b3);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[n][j] += t0[j];
                    s[n + 1][j] += t1[j];
                }
            }
        }

        softmax_tile(s, m, l, o, keys, c0, c0 + kBC - 1 <= first_q && keys.all_ok(c0), qpos,
                     sqrt_hd, rq, tg);

        // O += P V: p's three terms, packed from S's fragments into PV's A;
        // a chain: two k-steps' three passes
#pragma unroll
        for (int k2 = 0; k2 < kBC / 16; k2 += kChain) {
            unsigned a[kChain][3][4];
#pragma unroll
            for (int u = 0; u < kChain; ++u) {
                const int k = k2 + u;
                split3(s[2 * k][0], s[2 * k][1], a[u][0][0], a[u][1][0], a[u][2][0]);
                split3(s[2 * k][2], s[2 * k][3], a[u][0][1], a[u][1][1], a[u][2][1]);
                split3(s[2 * k + 1][0], s[2 * k + 1][1], a[u][0][2], a[u][1][2], a[u][2][2]);
                split3(s[2 * k + 1][2], s[2 * k + 1][3], a[u][0][3], a[u][1][3], a[u][2][3]);
            }
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
                float t0[4], t1[4];
#pragma unroll
                for (int u = 0; u < kChain; ++u) {
                    unsigned b0, b1, b2, b3;
                    const int key = (k2 + u) * 16 + (mi & 1) * 8 + mr, d = (n + (mi >> 1)) * 8;
                    ldsm_x4_trans(smem_addr(Vb + key * LDB + d), b0, b1, b2, b3);
#pragma unroll
                    for (int i = 2; i >= 0; --i) {
                        if (u == 0 && i == 2) {
                            mma_bf16_z(t0, a[u][i], b0, b1);
                            mma_bf16_z(t1, a[u][i], b2, b3);
                        } else {
                            mma_bf16(t0, a[u][i], b0, b1);
                            mma_bf16(t1, a[u][i], b2, b3);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    o[n][j] += t0[j];
                    o[n + 1][j] += t1[j];
                }
            }
        }
        __syncthreads();  // every warp is done with the stage
        if (tile + kStages < n_tiles)
            copy_tile<HDP, NT>(keys, c0 + kStages * kBC, ks_of(stage), vs_of(stage), hd, vec);
        cp_async_commit();
    }
    cp_async_wait<0>();
    store_out<HDP, NW>(o, l, out, smem_raw, r0, rows, T, NH, G, h, b, hd);
}

// ---------------------------------------------------------------------------
// The f32 cache: two TF32 terms of each f32 operand, TF32 m16n8k8
// ---------------------------------------------------------------------------

// x = big + small (+ below 2^-20 |x|): big = x truncated to TF32 (its low
// 13 bits cleared: one instruction), small = x - big (exact in f32), which
// the mma reads truncated to TF32; big alone for a value exact in TF32
template <bool kSmall>
__device__ __forceinline__ void split2(float x, unsigned& big, unsigned& small) {
    big = __float_as_uint(x) & 0xFFFFE000u;
    if (kSmall) small = __float_as_uint(x - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                           unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

template <int HDP, int NW, typename QT, typename OT, class Keys>
__device__ __forceinline__ void attend_tf32(const QT* __restrict__ q, OT* __restrict__ out,
                                            const Keys& keys, int st, int T, int NH, int KVH,
                                            int hd, float sqrt_hd, bool vec, bool qvec) {
    using KT = float;
    static_assert(16 * NW * (HDP + 16 / sizeof(OT)) * sizeof(OT) <= kSmemBytes<HDP, NW, QT, KT>,
                  "the output tile fits the shared memory");
    static_assert(16 * NW * HDP * sizeof(QT) <= kStages * kStageBytes<HDP, KT>,
                  "the raw q rows fit the stages");
    constexpr bool kQSmall = sizeof(QT) == 4;  // a bf16 query is exact in TF32
    constexpr int PQ = kPitQ<HDP>, PK = kPitQ<HDP>, PV = kPitV<HDP>;
    constexpr int KS = HDP / 8;  // k-steps of QK^T
    constexpr int NS = kBC / 8;  // n-tiles of S, k-steps of PV
    constexpr int NO = HDP / 8;  // n-tiles of O
    constexpr int NT = 32 * NW, kBR = 16 * NW;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBR][PQ]
    unsigned char* stages = smem_raw + kQBytes<HDP, NW, QT, KT>;
    auto ks_of = [&](int s) { return reinterpret_cast<KT*>(stages + s * kStageBytes<HDP, KT>); };
    auto vs_of = [&](int s) { return ks_of(s) + kBC * PK; };

    const int G = NH / KVH;
    const int rows = T * G;
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = (gridDim.z - 1 - blockIdx.z) * kBR;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tg = lane & 3;

    const int last_t = (min(r0 + kBR, rows) - 1) / G;
    const int n_tiles = (keys.kend(st + last_t + 1) + kBC - 1) / kBC;
    const int first_q = st + r0 / G;

    // the block's q rows, raw through the stages, then as f32
    const QT* raw = reinterpret_cast<const QT*>(stages);
    stage_q<HDP, NW>(q, const_cast<QT*>(raw), r0, rows, T, NH, G, h, b, hd, qvec);
    for (int e = tid; e < kBR * HDP; e += NT) {
        const int r = e / HDP, d = e % HDP;
        Qs[r * PQ + d] = to_f32(raw[r * HDP + d]);
    }
    __syncthreads();  // the stages are free again
    copy_tile<HDP, NT>(keys, 0, ks_of(0), vs_of(0), hd, vec);
    cp_async_commit();
    if (n_tiles > 1) copy_tile<HDP, NT>(keys, kBC, ks_of(1), vs_of(1), hd, vec);
    cp_async_commit();

    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = st + (r0 + warp * 16 + gr + 8 * i) / G;
    const float* qa = Qs + (warp * 16 + gr) * PQ + 2 * tg;  // this lane's A rows, k pair 2 tg
    const float rq = __frcp_rn(sqrt_hd);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int c0 = tile * kBC;
        const int stage = tile % kStages;
        cp_async_wait<1>();
        __syncthreads();
        const KT* Ks = ks_of(stage);
        const KT* Vs = vs_of(stage);

        // S = Q K^T; a chain: four k-steps' passes (small terms first), then
        // added in f32
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll 1
        for (int k4 = 0; k4 < KS; k4 += 4) {
            unsigned ab[4][4], as[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float2 lo = *reinterpret_cast<const float2*>(qa + (k4 + u) * 8);
                const float2 hi = *reinterpret_cast<const float2*>(qa + 8 * PQ + (k4 + u) * 8);
                split2<kQSmall>(lo.x, ab[u][0], as[u][0]);  // (gr, 2 tg)      -> a0
                split2<kQSmall>(hi.x, ab[u][1], as[u][1]);  // (gr + 8, 2 tg)  -> a1
                split2<kQSmall>(lo.y, ab[u][2], as[u][2]);  // (gr, 2 tg + 1)  -> a2
                split2<kQSmall>(hi.y, ab[u][3], as[u][3]);  // (gr + 8, 2 tg + 1)
            }
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                float t[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float2 kv = *reinterpret_cast<const float2*>(
                        Ks + (n * 8 + gr) * PK + (k4 + u) * 8 + 2 * tg);
                    unsigned bb[2], bs[2];
                    split2<true>(kv.x, bb[0], bs[0]);
                    split2<true>(kv.y, bb[1], bs[1]);
                    if (u == 0)
                        mma_tf32_z(t, ab[u], bs[0], bs[1]);
                    else
                        mma_tf32(t, ab[u], bs[0], bs[1]);
                    if (kQSmall) mma_tf32(t, as[u], bb[0], bb[1]);
                    mma_tf32(t, ab[u], bb[0], bb[1]);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) s[n][j] += t[j];
            }
        }

        softmax_tile(s, m, l, o, keys, c0, c0 + kBC - 1 <= first_q && keys.all_ok(c0), qpos,
                     sqrt_hd, rq, tg);

        // O += P V: S's fragment (c0, c2, c1, c3) of key step j is PV's A
        // (keys 8 j + 2 tg and 8 j + 2 tg + 1 at logical k = tg, tg + 4);
        // each pair of key steps' passes into zeroed registers
#pragma unroll
        for (int j2 = 0; j2 < NS; j2 += 2) {
            unsigned pb[2][4], ps[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                split2<true>(s[j2 + u][0], pb[u][0], ps[u][0]);
                split2<true>(s[j2 + u][2], pb[u][1], ps[u][1]);
                split2<true>(s[j2 + u][1], pb[u][2], ps[u][2]);
                split2<true>(s[j2 + u][3], pb[u][3], ps[u][3]);
            }
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                float t[4];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const float* v0 = Vs + ((j2 + u) * 8 + 2 * tg) * PV + n * 8 + gr;
                    unsigned bb[2], bs[2];
                    split2<true>(v0[0], bb[0], bs[0]);
                    split2<true>(v0[PV], bb[1], bs[1]);
                    if (u == 0)
                        mma_tf32_z(t, ps[u], bb[0], bb[1]);
                    else
                        mma_tf32(t, ps[u], bb[0], bb[1]);
                    mma_tf32(t, pb[u], bs[0], bs[1]);
                    mma_tf32(t, pb[u], bb[0], bb[1]);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) o[n][j] += t[j];
            }
        }
        __syncthreads();  // every warp is done with the stage
        if (tile + kStages < n_tiles)
            copy_tile<HDP, NT>(keys, c0 + kStages * kBC, ks_of(stage), vs_of(stage), hd, vec);
        cp_async_commit();
    }
    cp_async_wait<0>();
    store_out<HDP, NW>(o, l, out, smem_raw, r0, rows, T, NH, G, h, b, hd);
}

}  // namespace prefill_split
