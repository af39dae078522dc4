// The split decode cell of K9 (flash_decode_dma.cu) and K13
// (paged_flash_decode_dma.cu): flash-decoding over the key rows, with a
// deeper load ring and the per-block work spread over the whole block.
//
// What it replaces: common.cuh's dec_attend_rows, one 128-thread block per
// (kv head, slot) walking every key block of the slot through a two-stage
// ring that alternated a K tile and a V tile.  At a GQA group (B 8, KVH 8:
// 64 blocks) or a small batch (B 1: 32 blocks) most of the card's 132 SMs
// idle, and each block's walk is a chain of short, latency-bound steps
// (K9 at one slot of position 2047 took 0.108 ms for its 16 key blocks on
// the H100, PERF.md's table; deeper rings did not shorten a key block), so
// the time followed the longest slot's walk, 8-68x the bytes bound.
//
// Design:
// - Split over the key rows.  The grid is (splits, KVH, B).  The slot's
//   rows_max rows (the cache's S, or MP * ps for a pool) fall into
//   blocks = ceil(rows_max / TS) key blocks, and split i takes the
//   contiguous span [i * blocks / splits, (i + 1) * blocks / splits) of
//   them (integer division: spans differ by at most one block), clipped to
//   the slot's ceil(p / TS).  The host picks `splits` by one rule
//   (ops/attention.py decode_splits) from (B, KVH, TS, rows_max) alone, so
//   K9 and K13 split alike and nothing reads the card.  Each split runs the
//   online softmax over its span and writes its f32 partial (acc [G, hd]
//   unnormalized, m [G], l [G]) to a workspace the wrapper keeps; a split
//   whose span starts at or past p writes the empty partial (m = -1e30,
//   l = 0, acc = 0).  The last block of a (slot, kv head) to finish -- a
//   __threadfence, then an atomic ticket in a counter array that the last
//   block sets back to zero, so later launches on the stream reuse it --
//   merges the partials in split order (m = max(m, m_i), both sides
//   rescaled by exp(m_old - m) and exp(m_i - m); the state starts at m =
//   -1e30, l = 0, so empty partials add exp(0) * 0) and then the fresh
//   column, and writes out.  With every split empty (pos 0) the fresh
//   column alone comes out; -1e30 - -1e30 is 0, never a NaN.
// - Less latency per key block.  The scores take two lanes a row (four
//   fmaf chains a lane) where dec_qk_tile took eight (one chain), each
//   warp keeps its rows' max, and the softmax's exps spread over all 128
//   threads where dec_attend_rows ran one warp per query row; the
//   denominator's sum runs beside the PV dot, which reads p four rows at a
//   time.  A key block takes three block-wide barriers (K landed, scores
//   stored, V landed and p stored) where the alternating ring took five.
// - More bytes in flight.  A ring of up to six tiles (a key block's K tile
//   with both scale rows, then its V tile, one cp.async group each): the
//   most that still let an SM keep two blocks, so two key blocks of 128
//   int8 rows are in flight while one is used, one of 256 rows.
// - The same arithmetic per element as dec_attend_rows.  Each score is
//   dot(bf16(qs), f32(k)) (fp cache: f32 qs) in dec_qk_tile's order (eight
//   lanes a row, each on every eighth 16-byte chunk, then an xor butterfly),
//   times ks; p = exp(s - m_running) is unnormalized and rounded as
//   bf16(p * vs) (an fp cache keeps p in f32); each PV element adds its rows
//   in order from zero (dec_pv_tile), acc = acc * corr + part; int8 values
//   become f32 exactly (a byte permute into 2^23 + u, minus 2^23 + 128).
//   So at one split the cell equals dec_attend_rows bit for bit; K21's
//   blocked form and K27 keep that cell, and K12 and K26 (fused_step2.cuh)
//   run this one through split_cell.  K20 and K22 run this file's
//   pieces with a whole page as the rounding block (decode_split_page.cuh).  At more than one split each p is rounded
//   against its split's own running max: one bf16(p * vs) moves by at most
//   one bf16 step, and since an output is a convex combination of V rows
//   the port parts from the JAX package's sequential blocks
//   (tpu_llama/ops/attention.py:335, :466) by at most 2^-8 of max |out|.
#pragma once

#include "common.cuh"

constexpr int kSplitTiles = 6;       // the most tiles in the ring: three key blocks
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may take (227 KB)
constexpr int kSmemTwo = 115712;     // ... so that an SM keeps two blocks (228 KB, 1 KB each reserved)

// int8 v (as its byte u in [0, 256), v = u - 256 * (u > 127)) as f32,
// exactly: the float 2^23 + (u ^ 0x80) minus 2^23 + 128.
__device__ __forceinline__ float split_i8(unsigned u) {
    return __int_as_float(u ^ 0x4B000080u) - 8388736.0f;
}

template <typename CT>
struct SplitChunk : Chunk<CT> {};
template <>
struct SplitChunk<int8_t> {
    static constexpr int n = 16;
    __device__ static void load(const int8_t* p, float (&f)[16]) {
        const int4 w = *reinterpret_cast<const int4*>(p);
        const unsigned words[4] = {static_cast<unsigned>(w.x) ^ 0x80808080u,
                                   static_cast<unsigned>(w.y) ^ 0x80808080u,
                                   static_cast<unsigned>(w.z) ^ 0x80808080u,
                                   static_cast<unsigned>(w.w) ^ 0x80808080u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
            f[i] = __int_as_float(__byte_perm(words[i >> 2], 0x4B000000u, 0x7650u | (i & 3))) -
                   8388736.0f;
    }
};

__device__ __forceinline__ float split_val(int8_t x) {
    return split_i8(static_cast<unsigned>(static_cast<unsigned char>(x)));
}
__device__ __forceinline__ float split_val(float x) { return x; }
__device__ __forceinline__ float split_val(__nv_bfloat16 x) { return __bfloat162float(x); }

// Where byte b of row r of a ring tile lies in its row: the 16-byte chunk
// b / 16 xor (r & 7) where a row is a multiple of 128 bytes (`swz` 7), else
// in place (`swz` 0).  The lanes that read one chunk column of eight
// successive rows (split_scores) then hit eight different bank groups.
__device__ __forceinline__ int split_swz(int r, int b, int swz) {
    return (((b >> 4) ^ (r & swz)) << 4) | (b & 15);
}

// Scale-row slots of a ring of nt tiles: key block j's ks and vs land in
// slot j % ns with its K tile and are read until its V tile has landed; the
// K tile ns key blocks later is issued no earlier than that when
// 2 * ns >= nt + 1.
__host__ __device__ __forceinline__ int split_scale_slots(int nt) { return nt / 2 + 1; }

// Shared memory of one block: the ring of `nt` tiles of TS rows of pitch P
// (a key block's K tile, then its V tile, in turn, chunks swizzled by
// split_swz), the G query rows as f32 and as bf16, the scores (then p), the
// unrounded exps, the scale-row slots, each warp's score max, the
// online-softmax state and the ticket.
template <typename CT>
struct SplitSmem {
    unsigned char* ring;
    float *qf, *qb, *sc, *eb, *scales, *wmax, *m_s, *l_s, *c_s, *mn_s, *n_s;
    int* last;
    int tile;  // elements of one tile
    int TS;
    __device__ SplitSmem(unsigned char* base, int nt, int TS_, int P, int G)
        : ring(base), tile(TS_ * P), TS(TS_) {
        qf = reinterpret_cast<float*>(base + static_cast<size_t>(nt) * tile * sizeof(CT));
        qb = qf + G * P;
        sc = qb + G * P;             // [G, TS] scores, then p (bf16(p * vs) for INT8)
        eb = sc + G * TS;            // [G, TS] exp(s - m_new), unrounded
        scales = eb + G * TS;        // [ns][2][TS]: ks, vs of key block j in slot j % ns
        wmax = scales + split_scale_slots(nt) * 2 * TS;  // [warps][kDecMaxG] block maxima
        m_s = wmax + (kDecThreads / 32) * kDecMaxG;
        l_s = m_s + kDecMaxG;
        c_s = l_s + kDecMaxG;   // the block's correction exp(m_old - m_new)
        mn_s = c_s + kDecMaxG;  // m_new
        n_s = mn_s + kDecMaxG;  // the fresh column's score
        last = reinterpret_cast<int*>(n_s + kDecMaxG);
    }
    __device__ CT* at(int s) const { return reinterpret_cast<CT*>(ring) + s * tile; }
    __device__ float* kst(int s) const { return scales + 2 * s * TS; }
    __device__ float* vst(int s) const { return scales + (2 * s + 1) * TS; }
    static __host__ __device__ int bytes(int nt, int TS, int P, int G) {
        return nt * TS * P * static_cast<int>(sizeof(CT)) +
               4 * (2 * G * P + 2 * G * TS + split_scale_slots(nt) * 2 * TS +
                    (kDecThreads / 32 + 5) * kDecMaxG + 4);
    }
    // The ring's tiles: the most (at most kSplitTiles, at least 3) that let
    // an SM keep two blocks; else the most that fit one block; 0 if not even
    // two fit.
    static __host__ int tiles(int TS, int P, int G) {
        for (int n = kSplitTiles; n >= 3; --n)
            if (bytes(n, TS, P, G) <= kSmemTwo) return n;
        for (int n = kSplitTiles; n >= 2; --n)
            if (bytes(n, TS, P, G) <= kSmemMax) return n;
        return 0;
    }
};

// Copy `rows` rows of hd elements into a tile of pitch P, chunks swizzled
// (CH-byte copies), no commit.
template <int CH, typename CT>
__device__ __forceinline__ void split_copy_rows(CT* dst, const CT* __restrict__ src, int rows,
                                                int hd, int P, int swz) {
    const int row_b = hd * static_cast<int>(sizeof(CT)), pitch_b = P * static_cast<int>(sizeof(CT));
    const int per_row = row_b / CH;
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    const unsigned char* sp = reinterpret_cast<const unsigned char*>(src);
    if (kDecThreads % per_row == 0) {  // a thread keeps one chunk column: no division a copy
        const int o = (threadIdx.x % per_row) * CH, step = kDecThreads / per_row;
        int r = threadIdx.x / per_row;
        const unsigned char* sr = sp + static_cast<long long>(r) * row_b + o;
        for (; r < rows; r += step, sr += step * row_b) {
            unsigned char* dr = d + r * pitch_b + split_swz(r, o, swz);
            if (CH == 16)
                cp_async16(dr, sr, 16);
            else
                cp_async4(dr, sr);
        }
        return;
    }
    for (int c = threadIdx.x; c < rows * per_row; c += kDecThreads) {
        const int r = c / per_row, o = (c % per_row) * CH;
        if (CH == 16)
            cp_async16(d + r * pitch_b + split_swz(r, o, swz), sp + (long long)r * row_b + o, 16);
        else
            cp_async4(d + r * pitch_b + split_swz(r, o, swz), sp + (long long)r * row_b + o);
    }
}

// Zero the pad columns [hd, P) of `n` rows of pitch P, where split_swz puts
// them (every element type is zero as all-zero bytes).
template <typename CT>
__device__ __forceinline__ void split_zero_pad(CT* t, int n, int hd, int P, int swz) {
    constexpr int sz = static_cast<int>(sizeof(CT));
    const int w = (P - hd) * sz;
    unsigned char* b = reinterpret_cast<unsigned char*>(t);
    for (int e = threadIdx.x; e < n * w; e += kDecThreads) {
        const int r = e / w;
        b[r * P * sz + split_swz(r, hd * sz + e % w, swz)] = 0;
    }
}

// Let `kern` take at least `bytes` of dynamic shared memory on the current
// device: cudaFuncSetAttribute only when that raises what was set for the
// kernel and device before, not on every launch (above 48 KB the call costs
// the host more than the launch).  Every setting of the attribute for these
// kernels goes through here, so the table holds what is set.
template <class Kernel>
__host__ cudaError_t split_smem_attr(Kernel kern, int bytes) {
    constexpr int kFns = 64, kDevs = 16;
    static const void* fns[kFns] = {};
    static int sizes[kFns][kDevs] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const void* f = reinterpret_cast<const void*>(kern);
    int i = 0;
    while (i < kFns && fns[i] != nullptr && fns[i] != f) ++i;
    const bool known = i < kFns && dev >= 0 && dev < kDevs;
    if (known && fns[i] == f && sizes[i][dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && known) {
        fns[i] = f;
        sizes[i][dev] = bytes;
    }
    return err;
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
__device__ __forceinline__ void split_wait(int pending) {
    switch (pending) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        default: cp_async_wait<4>(); break;
    }
}

// The scores of one key block, stored to sc ([G, TS] of row stride ld: the
// score times ks, or -1e30 for a row at or past p), and each warp's max of
// them per query row to wmax (with keep_max, the max of that and what wmax
// held: a page of several tiles, decode_split_page.cuh).  dec_qk_tile's arithmetic: its lane sub sums the chunks c =
// sub, sub + 8, ... of a row in order with fmaf from zero, then the eight
// partials add as the xor butterfly over lanes 1, 2, 4 adds them.  Here
// kQkLanes lanes share a row, each holding kQkParts consecutive partials:
// the butterfly's lower levels add inside the lane, its upper ones across
// lanes -- the same sums in the same pairs, with kQkParts independent fmaf
// chains a lane.
constexpr int kQkLanes = 2;
constexpr int kQkParts = 8 / kQkLanes;

template <typename CT, bool kInt8>
__device__ __forceinline__ void split_scores(const float* qs, const CT* kt, const float* kst,
                                             float* sc, int ld, bool keep_max, float* wmax,
                                             int TS, int G, int P, int swz, int base, int p) {
    constexpr int V = SplitChunk<CT>::n;
    const int l = threadIdx.x & (kQkLanes - 1), nch = P / V;
    float mx[kDecMaxG];
#pragma unroll
    for (int g = 0; g < kDecMaxG; ++g) mx[g] = kNegInf;
    for (int r0 = 0; r0 < TS; r0 += kDecThreads / kQkLanes) {
        const int r = r0 + threadIdx.x / kQkLanes;
        float part[kDecMaxG][kQkParts];
#pragma unroll
        for (int g = 0; g < kDecMaxG; ++g)
#pragma unroll
            for (int k = 0; k < kQkParts; ++k) part[g][k] = 0.f;
        if (r < TS) {
#pragma unroll
            for (int k = 0; k < kQkParts; ++k) {
                for (int c = l * kQkParts + k; c < nch; c += 8) {
                    float kf[V];
                    SplitChunk<CT>::load(kt + r * P + (c ^ (r & swz)) * V, kf);
#pragma unroll
                    for (int g = 0; g < kDecMaxG; ++g) {
                        if (g >= G) break;
                        const float4* qg = reinterpret_cast<const float4*>(qs + g * P + c * V);
#pragma unroll
                        for (int i4 = 0; i4 < V / 4; ++i4) {
                            const float4 qv = qg[i4];
                            part[g][k] = fmaf(qv.x, kf[4 * i4], part[g][k]);
                            part[g][k] = fmaf(qv.y, kf[4 * i4 + 1], part[g][k]);
                            part[g][k] = fmaf(qv.z, kf[4 * i4 + 2], part[g][k]);
                            part[g][k] = fmaf(qv.w, kf[4 * i4 + 3], part[g][k]);
                        }
                    }
                }
            }
        }
        const bool valid = r < TS && base + r < p;
#pragma unroll
        for (int g = 0; g < kDecMaxG; ++g) {
            if (g >= G) break;
            float d = part[g][0];
#pragma unroll
            for (int w = 1; w < kQkParts; w <<= 1) {  // the butterfly's levels inside the lane
#pragma unroll
                for (int k = 0; k < kQkParts; k += 2 * w) part[g][k] = part[g][k] + part[g][k + w];
                d = part[g][0];
            }
#pragma unroll
            for (int o = 1; o < kQkLanes; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            const float s = valid ? (kInt8 ? d * kst[r] : d) : kNegInf;
            if (l == 0 && r < TS) sc[g * ld + r] = s;
            mx[g] = fmaxf(mx[g], s);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int g = 0; g < kDecMaxG; ++g) {
        if (g >= G) break;
        float m = mx[g];
#pragma unroll
        for (int o = kQkLanes; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) {
            float* w = wmax + warp * kDecMaxG + g;
            *w = keep_max ? fmaxf(*w, m) : m;
        }
    }
}

// acc[j] = acc[j] * c_s[g] + sum_{r < rows} pv[g, r] * f32(v[r, d]) for the
// thread's elements e = threadIdx.x + kDecThreads * j = g * hd + d, j < NE:
// dec_pv_tile's order (rows in turn with fmaf from zero), the rows outer so
// the NE chains interleave; where hd divides kDecThreads the NE elements
// share d and each v is read and converted once.
template <int NE, typename CT>
__device__ __forceinline__ void split_pv(const float* pv, int TS, const CT* vt, int rows, int G,
                                         int hd, int P, int swz, const float* c_s,
                                         float (&acc)[kDecMaxE]) {
    constexpr int sz = static_cast<int>(sizeof(CT));
    const int tid = threadIdx.x;
    float part[NE];
    bool on[NE];
    int row[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) {
        const int e = tid + kDecThreads * j;
        part[j] = 0.f;
        on[j] = e < G * hd;
        row[j] = (on[j] ? e / hd : 0) * TS;
    }
    // element d of row r lies at vt + r * P + split_swz(r, d * sz, swz) / sz
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(vt);
    auto val = [&](int r, int d) {
        return split_val(*reinterpret_cast<const CT*>(vb + r * P * sz + split_swz(r, d * sz, swz)));
    };
    if (kDecThreads % hd == 0) {
        const int d = tid % hd;
        int r = 0;
        // R rows at a time, their v and p read ahead of the chains: eight
        // for one or two chains a thread, four for more (measured on the
        // H100: eight rows slowed the four- and eight-chain forms)
        constexpr int R = NE <= 2 ? 8 : 4;
        if (TS % 8 == 0) {
            int off[8];  // where d lies in row r + i for r a multiple of 8
#pragma unroll
            for (int i = 0; i < 8; ++i) off[i] = split_swz(i, d * sz, swz);
#pragma unroll 2
            for (; r + R <= rows; r += R) {
                float v[R];
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    const int o = (R == 4 && (r & 4)) ? off[4 + i % 4] : off[i];
                    v[i] = split_val(*reinterpret_cast<const CT*>(vb + (r + i) * P * sz + o));
                }
#pragma unroll
                for (int j = 0; j < NE; ++j) {
                    if (!on[j]) continue;
#pragma unroll
                    for (int i4 = 0; i4 < R; i4 += 4) {
                        const float4 a = *reinterpret_cast<const float4*>(pv + row[j] + r + i4);
                        part[j] = fmaf(a.x, v[i4], part[j]);
                        part[j] = fmaf(a.y, v[i4 + 1], part[j]);
                        part[j] = fmaf(a.z, v[i4 + 2], part[j]);
                        part[j] = fmaf(a.w, v[i4 + 3], part[j]);
                    }
                }
            }
        }
        for (; r < rows; ++r) {
            const float v = val(r, d);
#pragma unroll
            for (int j = 0; j < NE; ++j)
                if (on[j]) part[j] = fmaf(pv[row[j] + r], v, part[j]);
        }
    } else {
#pragma unroll
        for (int j = 0; j < NE; ++j) {
            if (!on[j]) continue;
            const int d = (tid + kDecThreads * j) % hd;
            for (int r = 0; r < rows; ++r) part[j] = fmaf(pv[row[j] + r], val(r, d), part[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NE; ++j)
        if (on[j]) acc[j] = acc[j] * c_s[row[j] / TS] + part[j];
}

template <typename CT>
__device__ __forceinline__ void split_pv_any(int ne, const float* pv, int TS, const CT* vt,
                                             int rows, int G, int hd, int P, int swz,
                                             const float* c_s,
                                             float (&acc)[kDecMaxE]) {
    // ne rounded up to a power of two (the chains past G * hd are off): four
    // instantiations where eight would double the source's build time
    if (ne <= 1)
        split_pv<1>(pv, TS, vt, rows, G, hd, P, swz, c_s, acc);
    else if (ne <= 2)
        split_pv<2>(pv, TS, vt, rows, G, hd, P, swz, c_s, acc);
    else if (ne <= 4)
        split_pv<4>(pv, TS, vt, rows, G, hd, P, swz, c_s, acc);
    else
        split_pv<8>(pv, TS, vt, rows, G, hd, P, swz, c_s, acc);
}

// The end of split `split`'s walk (its state in m_s, l_s and the thread's
// acc, published), of `splits` that take part (the first `splits` of the
// launch's: a caller may leave out trailing splits whose spans start past
// the slot's rows, whose partials are empty and would merge as exact
// no-ops): at one split m_fin and l_fin are that state; at more than one,
// the split's partial goes to ws, the block takes the ticket, and the last
// block of the (slot, kv head) to finish merges the partials in split order
// into acc, m_fin and l_fin and sets the counter back to zero.  False in
// every other block, which then returns.
__device__ __forceinline__ bool split_finish(const float* m_s, const float* l_s, int* last, int G,
                                             int hd, int split, int splits, float* ws,
                                             int* ticket, float (&acc)[kDecMaxE],
                                             float (&m_fin)[kDecMaxE],
                                             float (&l_fin)[kDecMaxE]) {
    const int tid = threadIdx.x;
    if (splits > 1) {
        float* mine = ws + static_cast<long long>(split) * (G * hd + 2 * G);
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            if (e < G * hd) mine[e] = acc[j];
        }
        if (tid < G) {
            mine[G * hd + tid] = m_s[tid];
            mine[G * hd + G + tid] = l_s[tid];
        }
        __threadfence();  // the partial is visible before the ticket is taken
        __syncthreads();
        if (tid == 0) last[0] = atomicAdd(ticket, 1) == splits - 1;
        __syncthreads();
        if (!last[0]) return false;
        __threadfence();
        // merge the partials in split order
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            if (e >= G * hd) continue;
            const int g = e / hd;
            float m = kNegInf, l = 0.f, a = 0.f;
            for (int i = 0; i < splits; ++i) {
                const float* pt = ws + static_cast<long long>(i) * (G * hd + 2 * G);
                const float mi = __ldcg(pt + G * hd + g), li = __ldcg(pt + G * hd + G + g);
                const float ai = __ldcg(pt + e);
                const float mn = fmaxf(m, mi);
                const float ca = expf(m - mn), cb = expf(mi - mn);
                l = l * ca + li * cb;
                a = a * ca + ai * cb;
                m = mn;
            }
            acc[j] = a;
            m_fin[j] = m;
            l_fin[j] = l;
        }
        if (tid == 0) *ticket = 0;  // the counter is zero again for the next launch
    } else {
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            m_fin[j] = e < G * hd ? m_s[e / hd] : 0.f;
            l_fin[j] = e < G * hd ? l_s[e / hd] : 0.f;
        }
    }
    return true;
}

// One block of the split cell: split `split` of the (slot, kv head) whose G
// query rows fill_q(qf, qb) writes into shared memory ([G, P] each, pad
// columns zero: qf the f32 rows the fresh column's score takes, qb the rows
// an INT8 cache's scores take), over its cache rows s < p (k and v at kc /
// vc + rows_of(j) rows of hd elements for key block j, an INT8 cache's
// scales ks / vs at the same row offset), then the fresh row (nk, nks, nv,
// nvs; the scales 1 for an fp cache) as one more column, out [G, hd].  With
// splits > 1, ws is the (slot, kv head)'s [splits][G * hd + 2 * G] partials
// and ticket its counter; `live` of the splits (a prefix) take part in the
// merge (split_finish).  True in the block that wrote out (at one split,
// every block).  The block's last shared-memory reads may still run when
// it returns: a caller that reuses the memory syncs first.
template <typename CT, int CH, class FillQ, class Rows>
__device__ bool split_cell(unsigned char* smem, int nt, int split, FillQ fill_q,
                           const CT* __restrict__ kc, const CT* __restrict__ vc,
                           const float* __restrict__ ks, const float* __restrict__ vs, int p,
                           int rows_max, int TS, int G, int hd, int splits, int live,
                           const CT* nk, float nks, const CT* nv, float nvs, float* out,
                           float* ws, int* ticket, Rows rows_of) {
    constexpr bool kInt8 = sizeof(CT) == 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int P = dec_pitch<CT>(hd);
    const int swz = (P * static_cast<int>(sizeof(CT))) % 128 == 0 ? 7 : 0;
    const int ns = split_scale_slots(nt);
    const SplitSmem<CT> sm(smem, nt, TS, P, G);
    const int blocks = (rows_max + TS - 1) / TS;
    const int j0 = static_cast<int>(static_cast<long long>(split) * blocks / splits);
    const int j1 = min(static_cast<int>(static_cast<long long>(split + 1) * blocks / splits),
                       (p + TS - 1) / TS);

    // tile t of the walk is key block j0 + t / 2's K tile (with both scale
    // rows) for even t, its V tile for odd t, in ring slot t % nt; one
    // cp.async group each, empty past the span
    auto issue = [&](int t) {
        const int j = j0 + t / 2;
        if (j < j1) {
            const int s = t % nt;
            const int rows = min(TS, p - j * TS);
            const long long r = rows_of(j);
            split_copy_rows<CH>(sm.at(s), ((t & 1) ? vc : kc) + r * hd, rows, hd, P, swz);
            if constexpr (kInt8) {
                if ((t & 1) == 0) {
                    const int sl = (t / 2) % ns;
                    for (int i = tid; i < rows; i += kDecThreads) {
                        cp_async4(sm.kst(sl) + i, ks + r + i);
                        cp_async4(sm.vst(sl) + i, vs + r + i);
                    }
                }
            }
        }
        cp_async_commit();
    };

    // the pad columns (beside the bytes the copies write; the loop's first
    // barrier publishes them)
    if (P != hd) split_zero_pad(reinterpret_cast<CT*>(sm.ring), nt * TS, hd, P, swz);
    for (int t = 0; t < nt - 1; ++t) issue(t);
    fill_q(sm.qf, sm.qb);
    if (tid < G) {
        sm.m_s[tid] = kNegInf;
        sm.l_s[tid] = 0.f;
    }
    const int ne = (G * hd + kDecThreads - 1) / kDecThreads;
    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;

    // a key block takes three barriers: its K tile landed (the slot of the
    // tile before is free), its scores stored, its V tile landed and p
    // stored (the K tile's slot is free); each opens one more tile's copy
    for (int j = j0; j < j1; ++j) {
        const int t = 2 * (j - j0), ks_ = t % nt, vs_ = (t + 1) % nt, base = j * TS;
        const int sl = (j - j0) % ns;
        split_wait(nt - 2);
        __syncthreads();
        issue(t + nt - 1);
        split_scores<CT, kInt8>(kInt8 ? sm.qb : sm.qf, sm.at(ks_), sm.kst(sl), sm.sc, TS, false,
                                sm.wmax, TS, G, P, swz, base, p);
        __syncthreads();
        // the online softmax over the block (dec_attend_rows' arithmetic):
        // m_new = max(m_old, the block's max), every thread on its rows'
        // exps; then the PV dot, and the denominator's sum in
        // dec_attend_rows' order (lane i adds rows i, i + 32, ... of its
        // query row, then a warp sum) beside it
        for (int g = 0; g < G; ++g) {
            const float m_old = sm.m_s[g];
            float blk = sm.wmax[g];
#pragma unroll
            for (int w = 1; w < kDecThreads / 32; ++w) blk = fmaxf(blk, sm.wmax[w * kDecMaxG + g]);
            const float m_new = fmaxf(m_old, blk);
            if (tid == 0) {
                sm.c_s[g] = expf(m_old - m_new);
                sm.mn_s[g] = m_new;
            }
            const float* vsr = sm.vst(sl);
            float* sr = sm.sc + g * TS;
            for (int r = tid; r < TS; r += kDecThreads) {
                const bool valid = base + r < p;
                const float e = valid ? expf(sr[r] - m_new) : 0.f;
                sm.eb[g * TS + r] = e;
                sr[r] = kInt8 ? (valid ? round_bf16(e * vsr[r]) : 0.f) : e;
            }
        }
        split_wait(nt - 2);
        __syncthreads();
        issue(t + nt);
        split_pv_any(ne, sm.sc, TS, sm.at(vs_), min(TS, p - base), G, hd, P, swz, sm.c_s, acc);
        for (int g = warp; g < G; g += kDecThreads / 32) {
            const float* er = sm.eb + g * TS;
            float sum = 0.f;
            for (int r = lane; r < TS; r += 32) sum += er[r];
            sum = warp_sum(sum);
            if (lane == 0) {
                sm.l_s[g] = sm.l_s[g] * sm.c_s[g] + sum;
                sm.m_s[g] = sm.mn_s[g];
            }
        }
    }
    cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)
    __syncthreads();     // m, l (and q when no block ran)

    float m_fin[kDecMaxE], l_fin[kDecMaxE];
    if (!split_finish(sm.m_s, sm.l_s, sm.last, G, hd, split, live, ws, ticket, acc, m_fin,
                      l_fin))
        return false;

    // the fresh column (_fresh_tail_merge, attention.py:307-332)
    dec_fresh_scores(sm.qf, P, nk, nks, G, hd, sm.n_s);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            const int d = e % hd;
            const float m = m_fin[j], s_new = sm.n_s[e / hd];
            const float mf = fmaxf(m, s_new);
            const float corr = expf(m - mf);
            const float e_new = expf(s_new - mf);
            const float lf = l_fin[j] * corr + e_new;
            const float nvf = kInt8 ? to_f32(nv[d]) * nvs : to_f32(nv[d]);
            out[e] = (acc[j] * corr + e_new * nvf) / fmaxf(lf, 1e-30f);
        }
    }
    return true;
}

// split_cell for split blockIdx.x with the raw query rows q [G, hd]: qf =
// f32(q) / sqrt_hd, qb = bf16(qf) (K9, K13).
template <typename QT, typename CT, int CH, class Rows>
__device__ void split_decode_cell(unsigned char* smem, int nt, const QT* __restrict__ q,
                                  const CT* __restrict__ kc, const CT* __restrict__ vc,
                                  const float* __restrict__ ks, const float* __restrict__ vs,
                                  int p, int rows_max, int TS, int G, int hd, int splits,
                                  const CT* nk, float nks, const CT* nv, float nvs, float* out,
                                  float* ws, int* ticket, float sqrt_hd, Rows rows_of) {
    const int P = dec_pitch<CT>(hd);
    split_cell<CT, CH>(
        smem, nt, static_cast<int>(blockIdx.x),
        [&](float* qf, float* qb) { dec_load_q(q, qf, qb, G, hd, P, sqrt_hd); }, kc, vc, ks, vs,
        p, rows_max, TS, G, hd, splits, splits, nk, nks, nv, nvs, out, ws, ticket, rows_of);
}
