// The bf16 tensor-core cell of causal prefill attention over an INT8 K/V
// cache, shared by K6's INT8 form (flash_prefill.cu: a dense cache) and K16
// (paged_flash_prefill.cu: past pool pages through a page table, then a
// chunk's fresh rows).  The fp forms of K6 run the split-TF32 cell
// (prefill_split.cuh, which takes this header's helpers): JAX's fp branch is
// f32 dots, which a bf16 dot is not.
//
// Rounding contract: the TPU kernels' own (tpu_llama/ops/attention.py
// _flash_prefill_fresh_kernel :1499-1560, _flash_prefill_kernel
// :1583-1640, _paged_prefill_kernel :1922-1987 with q rounded at its
// boundary, :2030-2034):
//   * q is pre-scaled in f32, q / sqrt_f32(hd) (a division, correctly
//     rounded: the cell takes it as 1 / sqrt_f32(hd) correctly rounded and
//     one fma correction, which gives `/`'s value), then rounded to bf16
//     (to nearest, ties to even);
//   * K and V int8 go to bf16, which is exact; QK^T accumulates in f32,
//     then the K scale multiplies the score column;
//   * the mask: key s attends query t iff s <= start + t and the key source
//     allows s (K6: s < S; K16: a past key s < max(start, 0) in the walked
//     pages, or a fresh key);
//   * the online softmax runs in f32: m_new = max(m, the tile's max),
//     corr = exp(m - m_new), p = exp(s - m_new), l = l * corr + sum(p),
//     p unrounded (the cell takes exp(x) as the hardware's 2^(x log2(e)),
//     ex2.approx, with log2(e) folded into the K scales: within a few f32
//     ulps of expf, and p below 2^-126 flushed to 0);
//   * then bf16(p * vs[c]) @ bf16(V), accumulated in f32;
//   * out = acc / max(l, 1e-30) (a correctly rounded division, as q's),
//     cast once to the output type (K16 first rounds it to bf16: its JAX
//     kernel emits bf16, attention.py:2089).
// The plain versions (ops/attention.py) compute the same contract over the
// same 64-key tiles, so they agree with the cell to f32 noise (a p * vs on
// a bf16 rounding boundary may round the other way: within one bf16 step
// of the largest output).  Where the keys fit one tile the contract is one
// pass with the full row max, _flash_prefill_fresh_kernel's arithmetic;
// over more tiles it rounds p * vs at the running max, as the TPU's
// general kernel does at its 512-key blocks.
//
// Design (FA2-style, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32):
//   * One block per (kv head, slot, tile of 16 kNW = 128 folded query rows
//     r = t * G + g); the q tiles run on grid z, last (the heaviest causal
//     work) first.  Eight warps own 16 rows each (one block of ~250
//     registers a thread per SM).  The block's q rows come into shared
//     memory by 16-byte cp.async copies ahead of the first key tiles (bf16
//     q; f32 q by unconditional 16-byte loads), are pre-scaled and rounded
//     there, and each warp holds its rows as A fragments in registers for
//     the whole key loop (HDP / 16 k-steps of 4 registers).  Nothing
//     branches between the loads: IEEE `/` would, and its checks held
//     each load behind the last one (a first version spent 40% of its
//     time there).
//   * Keys come in tiles of kBC = 64.  The int8 K and V rows and their
//     scales of a tile are copied into shared memory by cp.async (16 bytes
//     a copy where hd % 16 == 0 and the rows are 16-byte aligned, else one
//     byte at a time) through a ring of kStages = 2 stages: tile j + 2
//     loads while tile j computes, eight lanes to a 128-byte row, so that a
//     warp's copy reads whole rows.  The rows come from a table of the
//     tile's 64 keys that 64 threads fill from the key source's `locate`
//     while the block converts the tile before it, so a tile whose keys sit
//     in several pages, or straddle the past and the fresh rows, loads like
//     any other.
//   * Once a tile has landed, the block converts it to bf16 [key][hd + 8]
//     tiles (the 16-byte pad keeps ldmatrix conflict-free; the int8 stage
//     rows are padded alike for the copies), by byte permutes and one
//     float subtraction per value rather than the quarter-rate I2F.  K's B
//     fragments come from ldmatrix, V's from ldmatrix.trans.
//   * S = Q K^T accumulates in registers (16 x 64 a warp); the K scales
//     multiply it, then the mask applies -- on tiles that cross the
//     diagonal or hold a key the source does not have, only.  Row max and
//     sum are quad shuffles, and the softmax has no branch.  p * vs is
//     rounded to bf16 and repacked from the C layout straight into PV's A
//     fragments.  O accumulates as 16 x HDP f32 a warp and is normalised
//     once.
//   * The causal tile skip: a block walks keys up to the one its last row
//     attends.
//   * The output tile is staged in shared memory and written 16 bytes a
//     lane, whole rows at a time.
// Bound on the H100: operations (bf16 tensor-core dots) at the served
// shapes -- see flash_prefill.cu and paged_flash_prefill.cu.
//
// The key source (`Keys`) is all that differs between the kernels:
//   int kend(int e)        the end of the keys to walk, given e = start +
//                          the block's last row's t + 1;
//   bool ok(int c)         key c exists (besides the causal rule);
//   bool all_ok(int c0)    every key of the tile [c0, c0 + kBC) exists;
//   KeyRow locate(int c)   key c's K and V rows and scales (`have` false,
//                          and valid pointers, for a key that does not
//                          exist: it loads as zeros).
// K16 equals K6 bit for bit on a dense copy of its keys: the keys are
// indexed past then fresh, its mask is K6's, its tiles fall on the same
// boundaries and a key loads the same bytes from either source.
#pragma once

#include <math.h>

#include "common.cuh"

namespace prefill_mma {

// A block of NW warps owns 16 * NW folded query rows (kNW in the served
// kernels).
constexpr int kNW = 8;
constexpr int kBC = 64;  // keys per tile
constexpr int kStages = 2;

struct KeyRow {
    const int8_t* k;
    const int8_t* v;
    const float* ks;
    const float* vs;
    bool have;
};

template <int HDP>
constexpr int kLdb = HDP + 8;  // bf16 tile pitch in elements: rows 16 bytes apart in the banks
template <int HDP>
constexpr int kPit = HDP + 16;  // int8 stage pitch in bytes: the same, for the copies

// A key's rows as the copies read them: the K and V rows and scales, null
// for a key that the source does not have (it loads as zeros).
struct RowPtrs {
    const int8_t* k;
    const int8_t* v;
    const float* ks;
    const float* vs;
};

// Shared memory in bytes: the int8 stages [kStages][2][kBC][kPit], their
// scales [kStages][2][kBC] f32, the bf16 K and V tiles [kBC][kLdb] each,
// the tile's scales [kBC] f32 each (the K scales times log2(e), then the V
// scales), then the rows of the two tiles to copy next, RowPtrs
// [2][kBC].  The block's q rows, bf16 [16 NW][kLdb], pass through the K and
// V tiles before the key loop.
template <int HDP>
constexpr int kStageBytes = 2 * kBC * kPit<HDP>;
template <int HDP>
constexpr int kSmemBytes = kStages * kStageBytes<HDP> + kStages * 2 * kBC * 4 +
                           2 * kBC * kLdb<HDP> * 2 + 2 * kBC * 4 +
                           2 * kBC * static_cast<int>(sizeof(RowPtrs));

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned a, unsigned& r0, unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned a, unsigned& r0, unsigned& r1,
                                              unsigned& r2, unsigned& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x / y, correctly rounded (the value of IEEE `/`), given r = 1 / y
// correctly rounded: q0 = x r rounded, its remainder x - y q0 exact by an
// fma, and one fma correction (Markstein's theorem).  Branch-free, where
// `/` guards every quotient with a check and a slow path.
__device__ __forceinline__ float div_rn(float x, float y, float r) {
    const float q0 = x * r;
    return fmaf(r, fmaf(-y, q0, x), q0);
}

// 2^x (MUFU.EX2; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
}

// four int8 (one word) as four exact bf16 (two words, in order), without
// the quarter-rate I2F: each byte, offset by 128, becomes the low byte of
// the float 2^23 + 128 + x, from which one subtraction leaves x exactly;
// an integer of 8 bits is exact in bf16, so its float's high half is it
__device__ __forceinline__ uint2 i8x4_to_bf16x4(unsigned w) {
    const unsigned b = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        f[i] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + i)) - 8388736.f;
    return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// cp.async of 4 bytes (a scale)
__device__ __forceinline__ void cp_async4_ca(float* smem, const float* gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// Threads t0 .. t0 + kBC - 1 resolve the keys c0 .. c0 + kBC - 1 of a tile
// to their rows.
template <class Keys>
__device__ __forceinline__ void locate_tile(const Keys& keys, int c0, RowPtrs* rows, int t0) {
    const int tid = threadIdx.x - t0;
    if (tid >= 0 && tid < kBC) {
        const KeyRow r = keys.locate(c0 + tid);
        rows[tid] = r.have ? RowPtrs{r.k, r.v, r.ks, r.vs} : RowPtrs{nullptr, nullptr, nullptr,
                                                                     nullptr};
    }
}

// The located tile's K and V rows (int8, zero past hd and for keys the
// source does not have) and scales (0 for those keys) into one stage.
// With `vec`, 16-byte cp.async copies, HDP / 16 lanes to a row, so that a
// warp's copy reads whole rows; else one byte at a time.  `any` is a valid
// address for the copies that read nothing.
template <int HDP, int NW>
__device__ __forceinline__ void copy_tile(const RowPtrs* rows, int8_t* st8, float* stsc, int hd,
                                          bool vec, const int8_t* any) {
    constexpr int kChunks = HDP / 16, kThreads = 32 * NW, kUnits = 2 * kBC * kChunks / kThreads;
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
            const int e = tid + u * kThreads;
            const int row = e / kChunks, o = (e % kChunks) * 16;  // row: K keys, then V
            const int8_t* src = row < kBC ? rows[row % kBC].k : rows[row % kBC].v;
            const bool in = src != nullptr && o < hd;
            cp_async16(st8 + row * kPit<HDP> + o, in ? src + o : any, in ? 16 : 0);
        }
    } else {
        for (int u = 0; u < kUnits; ++u) {
            const int e = tid + u * kThreads;
            const int row = e / kChunks, o = (e % kChunks) * 16;
            const int8_t* src = row < kBC ? rows[row % kBC].k : rows[row % kBC].v;
            int8_t* dst = st8 + row * kPit<HDP> + o;
            for (int d = 0; d < 16; ++d)
                dst[d] = src != nullptr && o + d < hd ? __ldg(src + o + d) : 0;
        }
    }
    if (tid < 2 * kBC) {  // the K scales, then the V scales
        const float* src = tid < kBC ? rows[tid].ks : rows[tid - kBC].vs;
        if (src != nullptr)
            cp_async4_ca(stsc + tid, src);
        else
            stsc[tid] = 0.f;
    }
}

template <int HDP, int NW, bool kRoundOut, typename QT, typename OT, class Keys>
__device__ __forceinline__ void attend(const QT* __restrict__ q, OT* __restrict__ out,
                                       const Keys& keys, int st, int T, int NH, int KVH, int hd,
                                       float sqrt_hd, bool vec) {
    constexpr int LDB = kLdb<HDP>;
    constexpr int KS = HDP / 16;  // k-steps of QK^T
    constexpr int NS = kBC / 8;   // n-tiles of S
    constexpr int NO = HDP / 8;   // n-tiles of O
    constexpr int kThreads = 32 * NW, kBR = 16 * NW;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int8_t* st8 = reinterpret_cast<int8_t*>(smem_raw);  // [kStages][2][kBC][kPit]
    float* stsc = reinterpret_cast<float*>(st8 + kStages * kStageBytes<HDP>);  // [kStages][2][kBC]
    __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(stsc + kStages * 2 * kBC);
    __nv_bfloat16* Vb = Kb + kBC * LDB;
    float* ksc = reinterpret_cast<float*>(Vb + kBC * LDB);  // K scales * log2(e)
    float* vsc = ksc + kBC;
    RowPtrs* rows_next = reinterpret_cast<RowPtrs*>(vsc + kBC);  // [2][kBC], by stage
    constexpr float kLog2e = 1.4426950408889634f;

    const int G = NH / KVH;
    const int rows = T * G;
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = (gridDim.z - 1 - blockIdx.z) * kBR;  // the heaviest q tile first
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tg = lane & 3;  // the mma fragments' row group and lane in it

    // causal tile skip: the block's last real row attends keys < kend
    const int last_t = (min(r0 + kBR, rows) - 1) / G;
    const int n_tiles = (keys.kend(st + last_t + 1) + kBC - 1) / kBC;
    const int first_q = st + r0 / G;  // the block's first row's position

    // The block's q rows, pre-scaled (q / sqrt(hd), correctly rounded) and
    // rounded to bf16, are staged in the K tile's place, 8 values a unit;
    // each warp then takes its 16 rows as A fragments (ldmatrix).  bf16 q
    // rows come by cp.async ahead of the first two tiles' copies (its own
    // commit group), and each thread scales the units it copied in place;
    // f32 q rows are loaded into registers.
    __nv_bfloat16* Qs = Kb;  // [kBR][LDB]; kBR <= 2 * kBC rows fit the K and V tiles
    constexpr int kQUnits = kBR * HDP / 8, kQPer = kQUnits / kThreads;
    constexpr bool kQAsync = sizeof(QT) == 2;
    const bool qvec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    auto q_unit = [&](int u, int& r, int& d0, const QT*& src) {
        const int e = tid + u * kThreads;
        r = e / (HDP / 8);
        d0 = (e % (HDP / 8)) * 8;
        const int rc = min(r0 + r, rows - 1);  // a valid row for the address
        src = q + (((long long)b * T + rc / G) * NH + h * G + rc % G) * hd;
    };
    auto q_in = [&](int r, int d0) { return r0 + r < rows && d0 < hd; };
    if (kQAsync && qvec) {
#pragma unroll
        for (int u = 0; u < kQPer; ++u) {
            int r, d0;
            const QT* src;
            q_unit(u, r, d0, src);
            const bool in = q_in(r, d0);
            cp_async16(Qs + r * LDB + d0, in ? src + d0 : src, in ? 16 : 0);
        }
    }
    cp_async_commit();

    // the first two tiles' rows, then their copies
    const int8_t* any = keys.locate(0).k;  // an address the empty copies may name
    locate_tile(keys, 0, rows_next, 0);
    if (n_tiles > 1) locate_tile(keys, kBC, rows_next + kBC, kBC);
    __syncthreads();
    copy_tile<HDP, NW>(rows_next, st8, stsc, hd, vec, any);
    cp_async_commit();
    if (n_tiles > 1)
        copy_tile<HDP, NW>(rows_next + kBC, st8 + kStageBytes<HDP>, stsc + 2 * kBC, hd, vec, any);
    cp_async_commit();

    {
        const float rq = __frcp_rn(sqrt_hd);
        float x[kQPer][8];
        if (kQAsync && qvec) {
            cp_async_wait<2>();  // this thread's q units (the first of three groups)
#pragma unroll
            for (int u = 0; u < kQPer; ++u) {
                int r, d0;
                const QT* src;
                q_unit(u, r, d0, src);
                load_vec(reinterpret_cast<const __nv_bfloat16*>(Qs + r * LDB + d0), x[u]);
            }
        } else {
            // every unit's loads are issued before any is used: each load is
            // unconditional (from a valid address) and a select zeroes what
            // lies outside q
#pragma unroll
            for (int u = 0; u < kQPer; ++u) {
                int r, d0;
                const QT* src;
                q_unit(u, r, d0, src);
                const bool in = q_in(r, d0);
                if (qvec) {
                    constexpr int V = Vec<QT>::n;
#pragma unroll
                    for (int c = 0; c < 8; c += V) {
                        float f[V];
                        load_vec(src + (in ? d0 + c : 0), f);
#pragma unroll
                        for (int j = 0; j < V; ++j) x[u][c + j] = in ? f[j] : 0.f;
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        x[u][j] = r0 + r < rows && d0 + j < hd ? to_f32(src[d0 + j]) : 0.f;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kQPer; ++u) {
            int r, d0;
            const QT* src;
            q_unit(u, r, d0, src);
#pragma unroll
            for (int j = 0; j < 8; ++j) x[u][j] = div_rn(x[u][j], sqrt_hd, rq);
            *reinterpret_cast<uint4*>(Qs + r * LDB + d0) =
                make_uint4(pack_bf16(x[u][0], x[u][1]), pack_bf16(x[u][2], x[u][3]),
                           pack_bf16(x[u][4], x[u][5]), pack_bf16(x[u][6], x[u][7]));
        }
    }
    __syncthreads();
    // this thread's two rows (fragment rows gr and gr + 8 of the warp's 16)
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = st + (r0 + warp * 16 + gr + 8 * i) / G;
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row in it
    unsigned qf[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k)
        ldsm_x4(smem_addr(Qs + (warp * 16 + (mi & 1) * 8 + mr) * LDB + k * 16 + (mi >> 1) * 8),
                qf[k][0], qf[k][1], qf[k][2], qf[k][3]);

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
        __syncthreads();  // the tile has landed; every warp is done with the last bf16 tiles
        {
            const int8_t* src = st8 + stage * kStageBytes<HDP>;
            constexpr int kUnits = 2 * kBC * HDP / 8;  // 8 int8 -> 8 bf16 a unit
            static_assert(kUnits % kThreads == 0, "whole units a thread");
#pragma unroll
            for (int u = 0; u < kUnits / kThreads; ++u) {
                const int e = tid + u * kThreads;
                const int row = e / (HDP / 8), d = (e % (HDP / 8)) * 8;  // row: K keys, then V
                const uint2 raw = *reinterpret_cast<const uint2*>(src + row * kPit<HDP> + d);
                const uint2 lo = i8x4_to_bf16x4(raw.x), hi = i8x4_to_bf16x4(raw.y);
                __nv_bfloat16* dst = row < kBC ? Kb + row * LDB : Vb + (row - kBC) * LDB;
                *reinterpret_cast<uint4*>(dst + d) = make_uint4(lo.x, lo.y, hi.x, hi.y);
            }
            if (tid < 2 * kBC) {  // ksc (times log2(e)) then vsc
                const float sc = stsc[stage * 2 * kBC + tid];
                ksc[tid] = tid < kBC ? sc * kLog2e : sc;
            }
        }
        // the rows of the tile to copy next, into the table that tile j's
        // copies read (before the last barrier)
        RowPtrs* rows_j = rows_next + stage * kBC;
        if (tile + kStages < n_tiles) locate_tile(keys, c0 + kStages * kBC, rows_j, 0);
        __syncthreads();  // the bf16 tiles and the row table are ready, the stage is free
        if (tile + kStages < n_tiles)
            copy_tile<HDP, NW>(rows_j, st8 + stage * kStageBytes<HDP>, stsc + stage * 2 * kBC, hd,
                               vec, any);
        cp_async_commit();

        // S = Q K^T, this warp's 16 rows x 64 keys
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
#pragma unroll
            for (int n = 0; n < NS; n += 2) {
                unsigned b0, b1, b2, b3;
                const int key = (n + (mi >> 1)) * 8 + mr, d = k * 16 + (mi & 1) * 8;
                ldsm_x4(smem_addr(Kb + key * LDB + d), b0, b1, b2, b3);
                mma_bf16(s[n], qf[k], b0, b1);
                mma_bf16(s[n + 1], qf[k], b2, b3);
            }
        }

        // K scales, then the mask on tiles that need one (block-uniform).
        // The scores are kept in log2 units, s * ks * log2(e), so that
        // p = exp(s - m) is one exp2 of their difference.
        const bool full = c0 + kBC - 1 <= first_q && keys.all_ok(c0);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = n * 8 + 2 * tg + (j & 1), i = j >> 1;
                float v = s[n][j] * ksc[c];
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
            // a row that has attended no key yet keeps m = -inf; it then
            // subtracts 0, so that its corr and p are exp2(-inf) = 0
            base[i] = m_new == -INFINITY ? 0.f : m_new;
            corr[i] = ex2(m[i] - base[i]);
            m[i] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = j >> 1;
                const float p = ex2(s[n][j] - base[i]);
                sum[i] += p;
                s[n][j] = p * vsc[n * 8 + 2 * tg + (j & 1)];
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

        // O += bf16(p * vs) V: S's C fragments become PV's A fragments
#pragma unroll
        for (int k = 0; k < kBC / 16; ++k) {
            unsigned a[4];
            a[0] = pack_bf16(s[2 * k][0], s[2 * k][1]);
            a[1] = pack_bf16(s[2 * k][2], s[2 * k][3]);
            a[2] = pack_bf16(s[2 * k + 1][0], s[2 * k + 1][1]);
            a[3] = pack_bf16(s[2 * k + 1][2], s[2 * k + 1][3]);
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
                unsigned b0, b1, b2, b3;
                const int key = k * 16 + (mi & 1) * 8 + mr, d = (n + (mi >> 1)) * 8;
                ldsm_x4_trans(smem_addr(Vb + key * LDB + d), b0, b1, b2, b3);
                mma_bf16(o[n], a, b0, b1);
                mma_bf16(o[n + 1], a, b2, b3);
            }
        }
    }
    cp_async_wait<0>();

    // l over the quad's columns, then out = acc / max(l, 1e-30), staged as
    // OT rows in shared memory (free now) and written out 16 bytes a lane
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    constexpr int OP = HDP + 16 / static_cast<int>(sizeof(OT));  // Os pitch in elements
    static_assert(kBR * OP * sizeof(OT) <= kStages * kStageBytes<HDP> + kStages * 2 * kBC * 4 +
                                               2 * kBC * kLdb<HDP> * 2,
                  "the output tile fits the stages and the bf16 tiles");
    OT* Os = reinterpret_cast<OT*>(smem_raw);
    __syncthreads();  // every warp is done with the tiles
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float den = fmaxf(l[i], 1e-30f), rd = __frcp_rn(den);
        OT* dst = Os + (warp * 16 + gr + 8 * i) * OP;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            float v0 = div_rn(o[n][2 * i], den, rd), v1 = div_rn(o[n][2 * i + 1], den, rd);
            if (kRoundOut) {
                v0 = round_bf16(v0);
                v1 = round_bf16(v1);
            }
            store_pair(dst + n * 8 + 2 * tg, v0, v1);
        }
    }
    __syncthreads();
    constexpr int kPer = 16 / static_cast<int>(sizeof(OT));  // elements a 16-byte store
    const bool ovec = hd % kPer == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int e = tid; e < kBR * (HDP / kPer); e += kThreads) {
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

}  // namespace prefill_mma
