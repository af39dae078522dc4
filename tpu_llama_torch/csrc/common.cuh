// Shared helpers for the port's hand-written Hopper kernels.
//
// Every source in this directory compiles on its own (one nvcc per file)
// into a shared library with a plain C interface that
// tpu_llama_torch/ops/_kernels.py loads through ctypes.  Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Built WITHOUT --use_fast_math: the kernels rely on IEEE division for the
// quant scales (absmax / 127, 1 / s), on rintf's round-half-to-even and on
// an accurate expf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, kept in step with _DTYPE_CODES and I32_CODE in ops/_kernels.py
// (TL_I32: K1's int32 form's output)
enum TlDtype : int { TL_F32 = 0, TL_BF16 = 1, TL_I8 = 2, TL_I32 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x rounded to the nearest bf16 (ties to even), as a float: jnp's astype
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded as a store to T rounds it, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return round_bf16(x); }

// Two neighbouring elements (p must be aligned to two of them).
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(v);
    b = __high2float(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide reductions over the NT threads of a block (NT a multiple of
// 32): every thread must call, and every thread gets the same result (an
// xor butterfly adds the same two values in every lane).  `red` is NT / 32
// values of shared memory; the trailing barrier frees it for the next call
// and makes the block's earlier shared-memory writes visible to all.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {  // of values >= 0
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = warp_max(lane < NT / 32 ? red[lane] : 0.f);
    __syncthreads();
    return v;
}

template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = warp_sum(lane < NT / 32 ? red[lane] : 0.0);
    __syncthreads();
    return v;
}

// ---------------------------------------------------------------------------
// Symmetric INT8 quantization of a row (or head) of f32 values: K2
// quantize_rows.cu, K3 rmsnorm_quantize.cu, K4 silu_mul_quantize.cu, K5
// rope_split_quantize.cu.  The formula of tpu_llama/ops/quant.py:255-263 as
// XLA compiles it inside jit, where the JAX package quantizes activations
// and KV rows (its Pallas kernels included):
//   s = absmax * f32(1/127)    (XLA's rewrite of absmax / 127),
//   inv = s > 0 ? 1 / s : 0,   q = clip(rint(x * inv), -127, 127)
// -- a multiply by the reciprocal, rint rounding half to even, so the int8
// bytes equal the JAX package's.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quant_scale(float absmax) { return absmax * (1.0f / 127.0f); }
__device__ __forceinline__ float quant_inv(float s) { return s > 0.f ? 1.0f / s : 0.f; }
__device__ __forceinline__ int8_t quant_i8(float x, float inv) {
    const float r = rintf(x * inv);
    return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// K3's rmsnorm factor r = 1 / sqrt(1e-5 + f32(ss) * f32(1/n)) from the f64
// sum of squares ss of a row of n values: two correctly rounded operations
// for 1 / sqrt.  The plain version (ops/quant.py) takes the sqrt in f64 and
// rounds it once to f32, because PyTorch's vectorised f32 sqrt is not
// correctly rounded on AVX-512 hosts (1 ulp off on some rows).
__device__ __forceinline__ float rms_factor(double ss, long long n) {
    const float ms = __fmul_rn(static_cast<float>(ss), __frcp_rn(static_cast<float>(n)));
    return __frcp_rn(__fsqrt_rn(__fadd_rn(1e-5f, ms)));
}

// RoPE on an interleaved pair (x0, x1) = (x[2j], x[2j+1]) in f32, every
// product and sum rounded (nvcc would contract them into FMAs):
//   r0 = x0 cos - x1 sin,   r1 = x0 sin + x1 cos.
__device__ __forceinline__ void rope_pair(float x0, float x1, float c, float s, float& r0,
                                          float& r1) {
    r0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
    r1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
}

template <typename T>
struct Vec;  // 16-byte vector of T and its int8 image
template <>
struct Vec<float> {
    static constexpr int n = 4;
    using q_t = uint32_t;
};
template <>
struct Vec<__nv_bfloat16> {
    static constexpr int n = 8;
    using q_t = uint2;
};

// The Vec<T>::n values at p (16-byte aligned) as f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[Vec<T>::n]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < Vec<T>::n; ++k) f[k] = to_f32(e[k]);
}

// cp.async (sm_80+): global -> shared copies that bypass the registers.
// cp_async16 copies src_bytes (0 or 16) and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Deferred-flush decode attention (K9 flash_decode_dma.cu, K19
// flash_decode_fresh.cu, K12's trailing cells), templated on the cache
// element type CT: int8_t (values with f32 per-row scales), float or
// __nv_bfloat16 (the fp caches, no scales).  One block of kDecThreads
// threads per (kv head, slot); its G query rows share every K/V byte it
// reads.  Cache rows are staged in shared memory tiles of pitch P elements,
// hd rounded up to 16 bytes (the pad columns are zero, and so are the
// queries' pad columns).
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecMaxG = 8;  // query heads per kv head
constexpr int kDecMaxHd = 128;
constexpr int kDecMaxE = kDecMaxG * kDecMaxHd / kDecThreads;  // output elements a thread owns
constexpr float kNegInf = -1e30f;  // the JAX package's _NEG_INF

template <typename CT>
__host__ __device__ __forceinline__ int dec_pitch(int hd) {
    constexpr int v = 16 / static_cast<int>(sizeof(CT));  // elements per 16 bytes
    return (hd + v - 1) / v * v;
}

// The (slot, kv head)'s G query rows q [G, hd]: qf = f32(q) / sqrt_hd and
// qb = bf16(qf), each [G, P] with zero pad columns.
template <typename QT>
__device__ void dec_load_q(const QT* __restrict__ q, float* qf, float* qb, int G, int hd, int P,
                           float sqrt_hd) {
    for (int e = threadIdx.x; e < G * P; e += kDecThreads) {
        const int g = e / P, d = e % P;
        const float x = d < hd ? to_f32(q[g * hd + d]) / sqrt_hd : 0.f;
        qf[e] = x;
        qb[e] = round_bf16(x);
    }
}

// Zero the pad columns [hd, P) of `n` rows of pitch P (every element type
// is zero as all-zero bytes).
template <typename CT>
__device__ __forceinline__ void dec_zero_pad(CT* t, int n, int hd, int P) {
    constexpr int sz = static_cast<int>(sizeof(CT));
    const int w = (P - hd) * sz;
    unsigned char* b = reinterpret_cast<unsigned char*>(t);
    for (int e = threadIdx.x; e < n * w; e += kDecThreads) b[(e / w) * P * sz + hd * sz + e % w] = 0;
}

// Start copying `rows` cache rows of hd elements into a tile of pitch P
// (CH-byte chunks: 16 when a row is a multiple of 16 bytes, else 4), and
// `rows` f32 scales from each non-null scale row; commits one cp.async
// group.
template <int CH, typename CT>
__device__ void dec_issue_tile(CT* dst, const CT* __restrict__ src, int rows, int hd, int P,
                               float* dst_s0, const float* __restrict__ src_s0, float* dst_s1,
                               const float* __restrict__ src_s1) {
    const int row_b = hd * static_cast<int>(sizeof(CT)), pitch_b = P * static_cast<int>(sizeof(CT));
    const int per_row = row_b / CH;
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    const unsigned char* sp = reinterpret_cast<const unsigned char*>(src);
    for (int c = threadIdx.x; c < rows * per_row; c += kDecThreads) {
        const int r = c / per_row, o = (c % per_row) * CH;
        if (CH == 16)
            cp_async16(d + r * pitch_b + o, sp + (long long)r * row_b + o, 16);
        else
            cp_async4(d + r * pitch_b + o, sp + (long long)r * row_b + o);
    }
    for (int r = threadIdx.x; r < rows; r += kDecThreads) {
        if (src_s0) cp_async4(dst_s0 + r, src_s0 + r);
        if (src_s1) cp_async4(dst_s1 + r, src_s1 + r);
    }
    cp_async_commit();
}

// The 16 bytes at p as f32 values (16 / sizeof(CT) of them).
template <typename CT>
struct Chunk;
template <>
struct Chunk<int8_t> {
    static constexpr int n = 16;
    __device__ static void load(const int8_t* p, float (&f)[16]) {
        const int4 w = *reinterpret_cast<const int4*>(p);
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
            f[i] = static_cast<float>(static_cast<int8_t>(words[i >> 2] >> (8 * (i & 3))));
    }
};
template <>
struct Chunk<float> {
    static constexpr int n = 4;
    __device__ static void load(const float* p, float (&f)[4]) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x;
        f[1] = v.y;
        f[2] = v.z;
        f[3] = v.w;
    }
};
template <>
struct Chunk<__nv_bfloat16> {
    static constexpr int n = 8;
    __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
        load_vec(p, f);
    }
};

// store(g, r, dot) for rows r < rows of the tile kt and g < G, where
// dot = sum_d qs[g, d] * f32(k[r, d]) in f32.  Eight lanes share a row,
// each on every eighth 16-byte chunk; every thread of the block must call
// it.
template <typename CT, class Store>
__device__ void dec_qk_tile(const float* qs, const CT* kt, int rows, int G, int P, Store store) {
    constexpr int V = Chunk<CT>::n;
    const int sub = threadIdx.x & 7, nch = P / V;
    for (int r0 = 0; r0 < rows; r0 += kDecThreads / 8) {
        const int r = r0 + (threadIdx.x >> 3);
        float part[kDecMaxG];
#pragma unroll
        for (int g = 0; g < kDecMaxG; ++g) part[g] = 0.f;
        if (r < rows) {
            for (int c = sub; c < nch; c += 8) {
                float kf[V];
                Chunk<CT>::load(kt + r * P + c * V, kf);
#pragma unroll
                for (int g = 0; g < kDecMaxG; ++g) {
                    if (g >= G) break;
                    const float* qg = qs + g * P + c * V;
#pragma unroll
                    for (int i = 0; i < V; ++i) part[g] = fmaf(qg[i], kf[i], part[g]);
                }
            }
        }
#pragma unroll
        for (int g = 0; g < kDecMaxG; ++g) {
            if (g >= G) break;
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
        }
        if (sub == 0 && r < rows) {
            for (int g = 0; g < G; ++g) store(g, r, part[g]);
        }
    }
}

// part[j] = sum_{r < rows} pv[g, r] * f32(v[r, d]) for the output element
// e = threadIdx.x + kDecThreads * j = g * hd + d (0 where e >= G * hd).
// `rows` must not reach past the rows the tile holds: a tile's tail keeps
// stale shared memory, which in an fp tile may be a NaN (0 * NaN is NaN).
template <typename CT>
__device__ __forceinline__ void dec_pv_tile(const float* pv, int ldp, const CT* vt, int rows,
                                            int G, int hd, int P, float (&part)[kDecMaxE]) {
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        part[j] = 0.f;
        const int e = threadIdx.x + kDecThreads * j;
        if (e < G * hd) {
            const int g = e / hd, d = e % hd;
            const float* pg = pv + g * ldp;
            for (int r = 0; r < rows; ++r) part[j] = fmaf(pg[r], to_f32(vt[r * P + d]), part[j]);
        }
    }
}

// s_new[g] = (sum_d qf[g, d] * f32(nk[d])) * nks: the fresh row's score from
// the UNROUNDED f32 queries (attention.py:158-163, :319-323); nks is 1 for
// an fp cache.  One warp per query row.
template <typename CT>
__device__ __forceinline__ void dec_fresh_scores(const float* qf, int P, const CT* nk, float nks,
                                                 int G, int hd, float* s_new) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int g = warp; g < G; g += kDecThreads / 32) {
        float s = 0.f;
        for (int d = lane; d < hd; d += 32) s = fmaf(qf[g * P + d], to_f32(nk[d]), s);
        s = warp_sum(s);
        if (lane == 0) s_new[g] = s * nks;
    }
}

// The shared-memory layout of one decode cell: two tiles of TS rows of
// pitch P (K, then V), the K tile's two scale rows, the G query rows as f32
// and as bf16, the block's scores, and the online-softmax state.
template <typename CT>
struct DecSmem {
    CT* kt;
    CT* vt;
    float *kst, *vst, *qf, *qb, *sc, *m_s, *l_s, *c_s, *n_s;
    __device__ DecSmem(unsigned char* base, int TS, int P, int G) {
        kt = reinterpret_cast<CT*>(base);  // stage 0: K tile [TS, P]
        vt = kt + TS * P;                  // stage 1: V tile [TS, P]
        kst = reinterpret_cast<float*>(vt + TS * P);  // stage 0's scales: ks [TS]
        vst = kst + TS;                               //   and vs [TS]
        qf = vst + TS;           // [G, P] f32 queries (fresh column; an fp cache's rows)
        qb = qf + G * P;         // [G, P] bf16 queries (an INT8 cache's rows)
        sc = qb + G * P;         // [G, TS] scores, then p (bf16(p * vs) for INT8)
        m_s = sc + G * TS;       // [kDecMaxG] running max
        l_s = m_s + kDecMaxG;    // running denominator
        c_s = l_s + kDecMaxG;    // this block's correction exp(m_old - m_new)
        n_s = c_s + kDecMaxG;    // fresh-column score
    }
    static __host__ __device__ int bytes(int TS, int P, int G) {
        return 2 * TS * P * static_cast<int>(sizeof(CT)) +
               4 * (2 * TS + 2 * G * P + G * TS + 4 * kDecMaxG);
    }
};

// Where a decode cell's key block j starts: its row offset (in rows of hd
// elements, and in scales) from the cell's kc / vc / ks / vs pointers.  A
// dense cache's rows are contiguous, so block j starts at row j * TS (K9,
// K12); K13 (paged_flash_decode_dma.cu) passes a functor that looks the
// block's page up in the page table.  A block never straddles two pages:
// TS divides the page size (K20 and K22 take TS = ps: block j is page j).
struct DecDenseRows {
    int TS;
    __device__ __forceinline__ long long operator()(int j) const { return (long long)j * TS; }
};

// The paged kernels' row functor (K13 paged_flash_decode_dma.cu, K20
// paged_flash_decode_fresh.cu, K22 paged_flash_decode.cu): the start row
// of key block j of (layer, slot b, kv head h) in the pool
// [L, P, KVH, ps, hd] (rows of hd elements; the scales [L, P, KVH, ps]
// share the row index).
struct PagedRows {
    const int* pt;  // page_table[b, :]
    long long layer_page0;  // layer * P
    int P, KVH, h, ps, TS;
    __device__ __forceinline__ long long operator()(int j) const {
        const int r0 = j * TS;
        int pg = __ldg(pt + r0 / ps);
        if (pg < 0 || pg >= P) pg = 0;  // the trash page
        return ((layer_page0 + pg) * KVH + h) * ps + r0 % ps;
    }
};

// One decode cell (the cells of K27 fused_step.cu, K21's
// blocked form in flash_decode.cu; K9 and K13 run decode_split.cuh, which
// equals it at one split): the G query rows of one (slot, kv head) attend
// over its cache rows s < p (k and v at kc / vc + rows_of(j) rows of hd
// elements for key block j, for an INT8 cache scales ks / vs at the same
// row offset) with an online softmax over blocks of TS rows, then (kFresh,
// the deferred-flush form) over the fresh row (nk, nks, nv, nvs) as
// one more column; writes the G x hd outputs to out.  Without kFresh (K21's write-then-attend form: the
// caller passes p = pos + 1, and the fresh arguments go unread) the output
// is acc / max(l, 1e-30) after the last block.  The caller has filled sm.qf
// and sm.qb; this function's barriers publish them.  K and V tiles stream
// through a two-stage cp.async ring: t = 2j is K block j (with ks and vs)
// into stage 0, t = 2j + 1 is V block j into stage 1.
// Rounding, kept from the TPU kernel: for an INT8 cache the score is
// dot(qb, k) in f32, times ks, and p = exp(s - m_block) is UNNORMALIZED when
// it is rounded, as bf16(p * vs), before the PV dot; for an fp cache
// (attention.py:274-295, dt = f32) the score is dot(qf, f32(k)) and p stays
// f32, with no scales.  The fresh column's score uses qf (times nks) and its
// value f32(nv) * nvs, merged after the last block (_fresh_tail_merge,
// attention.py:307-332); nks and nvs are 1 for an fp cache.
template <typename CT, int CH, class Rows, bool kFresh = true>
__device__ void dec_attend_rows(const DecSmem<CT>& sm, const CT* __restrict__ kc,
                                const CT* __restrict__ vc, const float* __restrict__ ks,
                                const float* __restrict__ vs, int p, int TS, int G, int hd,
                                const CT* nk, float nks, const CT* nv, float nvs, float* out,
                                Rows rows_of) {
    constexpr bool kInt8 = sizeof(CT) == 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int P = dec_pitch<CT>(hd);
    const int nb = (p + TS - 1) / TS;
    if (P != hd) dec_zero_pad(sm.kt, 2 * TS, hd, P);  // both stages
    if (tid < G) {
        sm.m_s[tid] = kNegInf;
        sm.l_s[tid] = 0.f;
    }
    float acc[kDecMaxE];
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) acc[j] = 0.f;

    auto issue = [&](int t) {
        const int j = t >> 1;
        const int rows = min(TS, p - j * TS);
        const long long r = rows_of(j);
        if (t & 1)
            dec_issue_tile<CH>(sm.vt, vc + r * hd, rows, hd, P, nullptr, nullptr, nullptr, nullptr);
        else if (kInt8)
            dec_issue_tile<CH>(sm.kt, kc + r * hd, rows, hd, P, sm.kst, ks + r, sm.vst, vs + r);
        else
            dec_issue_tile<CH>(sm.kt, kc + r * hd, rows, hd, P, nullptr, nullptr, nullptr, nullptr);
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
            dec_qk_tile(kInt8 ? sm.qb : sm.qf, sm.kt, TS, G, P, [&](int g, int r, float dot) {
                const bool valid = base + r < p;
                sm.sc[g * TS + r] = valid ? (kInt8 ? dot * sm.kst[r] : dot) : kNegInf;
            });
            __syncthreads();
            // online softmax over the block, one warp per query row
            for (int g = warp; g < G; g += kDecThreads / 32) {
                float* s = sm.sc + g * TS;
                const float m_old = sm.m_s[g];
                float mx = kNegInf;
                for (int r = lane; r < TS; r += 32) mx = fmaxf(mx, s[r]);
                const float m_new = fmaxf(m_old, warp_max(mx));
                float sum = 0.f;
                for (int r = lane; r < TS; r += 32) {
                    const bool valid = base + r < p;
                    const float e = valid ? expf(s[r] - m_new) : 0.f;
                    sum += e;
                    s[r] = kInt8 ? (valid ? round_bf16(e * sm.vst[r]) : 0.f) : e;
                }
                sum = warp_sum(sum);
                if (lane == 0) {
                    const float corr = expf(m_old - m_new);
                    sm.c_s[g] = corr;
                    sm.l_s[g] = sm.l_s[g] * corr + sum;
                    sm.m_s[g] = m_new;
                }
            }
        } else {
            float part[kDecMaxE];
            dec_pv_tile(sm.sc, TS, sm.vt, min(TS, p - base), G, hd, P, part);
#pragma unroll
            for (int j = 0; j < kDecMaxE; ++j) {
                const int e = tid + kDecThreads * j;
                if (e < G * hd) acc[j] = acc[j] * sm.c_s[e / hd] + part[j];
            }
        }
        __syncthreads();  // the stage is free for tile t + 2
    }

    if (nt == 0) __syncthreads();  // the q rows and m, l (no tile made the loop sync)
    if constexpr (!kFresh) {  // write-then-attend: no fresh column
#pragma unroll
        for (int j = 0; j < kDecMaxE; ++j) {
            const int e = tid + kDecThreads * j;
            if (e < G * hd) out[e] = acc[j] / fmaxf(sm.l_s[e / hd], 1e-30f);
        }
        return;
    }
    // the fresh column (_fresh_tail_merge, attention.py:307-332)
    dec_fresh_scores(sm.qf, P, nk, nks, G, hd, sm.n_s);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDecMaxE; ++j) {
        const int e = tid + kDecThreads * j;
        if (e < G * hd) {
            const int g = e / hd, d = e % hd;
            const float m = sm.m_s[g], s_new = sm.n_s[g];
            const float m_fin = fmaxf(m, s_new);
            const float corr = expf(m - m_fin);
            const float e_new = expf(s_new - m_fin);
            const float l_fin = sm.l_s[g] * corr + e_new;
            const float nvf = kInt8 ? to_f32(nv[d]) * nvs : to_f32(nv[d]);
            out[e] = (acc[j] * corr + e_new * nvf) / fmaxf(l_fin, 1e-30f);
        }
    }
}

// dec_attend_rows over a dense cache's contiguous rows (K27).
template <typename CT, int CH>
__device__ __forceinline__ void dec_attend(const DecSmem<CT>& sm, const CT* __restrict__ kc,
                                           const CT* __restrict__ vc,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, int p, int TS, int G,
                                           int hd, const CT* nk, float nks, const CT* nv,
                                           float nvs, float* out) {
    dec_attend_rows<CT, CH>(sm, kc, vc, ks, vs, p, TS, G, hd, nk, nks, nv, nvs, out,
                            DecDenseRows{TS});
}

extern "C" const char* tl_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
