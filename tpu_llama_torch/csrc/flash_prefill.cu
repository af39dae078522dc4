// K6: causal prefill attention over an INT8, f32 or bf16 K/V cache,
// GQA-native.
//
// Replaces tpu_llama/ops/attention.py:1654 flash_prefill_attention (its
// Pallas kernels _flash_prefill_kernel :1583, _flash_prefill_fresh_kernel
// :1499 and _flash_prefill_hb_kernel :1421).  Contract (attention.py
// :1675-1768): q [B, T, NH, hd] is pre-scaled by 1/sqrt(hd) (a division,
// :1699); the G = NH / KVH query heads of kv head h fold into rows
// r = t * G + g; key s attends iff s <= start[b] + t; for an INT8 cache K
// scales multiply the score columns and V scales the probability columns
// (an fp cache has none: its f32 dots and f32 p, attention.py:1613-1640,
// are this kernel's arithmetic with scales of 1); the output
// [B, T, NH * hd] is acc / max(l, 1e-30), cast once to the output type.
//
// Rounding: this kernel stays in f32 throughout (SIMT FMAs).  The TPU kernel
// rounds q and p * vs to bf16 before its MXU dots (attention.py:1534-1548);
// here neither is rounded, so the result agrees with the plain f32 version
// to f32 summation-order noise.
//
// Bound on the H100: at the 7B prefill shape (T = 512, hd = 128) the causal
// work is ~0.5 GFLOP per (b, kv head) pair against 0.2 MB of int8 K/V, so
// operations bound it.  Design: one block per (q tile of 64 folded rows,
// kv head, batch row), an online softmax over 64-key tiles that stops at
// the tile holding the block's last attended key (causal tile skip), K/V
// converted from the cache type (KT: int8, f32 or bf16) to f32 once per
// tile into shared memory, and each
// thread holding a 4 x 8 score tile and a 4 x hd/8 output tile in
// registers.  The f32 SIMT rate is ~1/15 of the bf16 tensor-core rate the
// bound assumes; moving the dots onto bf16 mma is a later change.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBR = 64;       // folded query rows per block
constexpr int kBC = 64;       // keys per tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)

template <int HDP>
struct Smem {
    static constexpr int kLdq = HDP + 1;  // +1: conflict-free column reads
    static constexpr int kLdp = kBC + 1;
    static constexpr int kFloats = kBR * kLdq + kBC * kLdq + kBR * kLdp + 2 * kBC;
};

template <int HDP, typename QT, typename KT, typename OT>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                     const KT* __restrict__ vc, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ start,
                     OT* __restrict__ out, int T, int NH, int KVH, int S, int hd,
                     float sqrt_hd) {
    using SM = Smem<HDP>;
    constexpr int LDQ = SM::kLdq, LDP = SM::kLdp, DJ = HDP / 8;
    extern __shared__ float smem[];
    float* Qs = smem;                // [BR][LDQ] pre-scaled queries
    float* KV = Qs + kBR * LDQ;      // [BC][LDQ] int8 K, then V, as f32
    float* Ps = KV + kBC * LDQ;      // [BR][LDP] p * v_scale
    float* ksc = Ps + kBR * LDP;     // [BC]
    float* vsc = ksc + kBC;          // [BC]

    const int G = NH / KVH;
    const int rows = T * G;
    const int r0 = blockIdx.x * kBR, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
    const int st = start[b];
    const long long kv_base = ((long long)b * KVH + h) * S;  // row index of key 0

    for (int e = tid; e < kBR * HDP; e += kThreads) {
        const int r = e / HDP, d = e % HDP, row = r0 + r;
        float v = 0.f;
        if (row < rows && d < hd) {
            const int t = row / G, gg = row % G;
            v = to_f32(q[(((long long)b * T + t) * NH + h * G + gg) * hd + d]) / sqrt_hd;
        }
        Qs[r * LDQ + d] = v;
    }

    // causal tile skip: the block's last real row attends keys < kend
    const int last_t = (min(r0 + kBR, rows) - 1) / G;
    const int kend = min(S, st + last_t + 1);
    const int n_tiles = (kend + kBC - 1) / kBC;

    float m[4], l[4], acc[4][DJ];
    int qpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        qpos[i] = st + (r0 + ty + 16 * i) / G;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int c0 = tile * kBC;
        __syncthreads();  // previous tile's V and P reads are done
        for (int e = tid; e < kBC * HDP; e += kThreads) {
            const int c = e / HDP, d = e % HDP;
            KV[c * LDQ + d] = (c0 + c < S && d < hd)
                                  ? to_f32(kc[(kv_base + c0 + c) * hd + d])
                                  : 0.f;
        }
        if (tid < kBC) {
            const bool ok = c0 + tid < S;
            ksc[tid] = ok ? (ks ? ks[kv_base + c0 + tid] : 1.f) : 0.f;  // fp: no scales
            vsc[tid] = ok ? (vs ? vs[kv_base + c0 + tid] : 1.f) : 0.f;
        }
        __syncthreads();

        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
        for (int d = 0; d < HDP; ++d) {
            float qv[4], kv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] = KV[(tx + 8 * j) * LDQ + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

        // online softmax; the 8 lanes of a row group (tx) share each row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = c0 + tx + 8 * j;
                const bool ok = c <= qpos[i] && c < S;
                sc[i][j] = ok ? sc[i][j] * ksc[tx + 8 * j] : -INFINITY;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            // key 0 is in tile 0 and every row attends it, so m_new is finite
            const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
                sum += p;
                Ps[(ty + 16 * i) * LDP + tx + 8 * j] = p * vsc[tx + 8 * j];
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();  // K reads and P writes done

        for (int e = tid; e < kBC * HDP; e += kThreads) {
            const int c = e / HDP, d = e % HDP;
            KV[c * LDQ + d] = (c0 + c < S && d < hd)
                                  ? to_f32(vc[(kv_base + c0 + c) * hd + d])
                                  : 0.f;
        }
        __syncthreads();

        for (int c = 0; c < kBC; ++c) {
            float pv[4], vv[DJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
            for (int j = 0; j < DJ; ++j) vv[j] = KV[c * LDQ + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= rows) continue;
        const int t = row / G, gg = row % G;
        OT* o = out + (((long long)b * T + t) * NH + h * G + gg) * hd;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const int d = tx + 8 * j;
            if (d < hd) store_as(o + d, acc[i][j] / den);
        }
    }
}

template <int HDP, typename QT, typename KT, typename OT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* start, void* out, int B, int T, int NH, int KVH, int S, int hd,
           float sqrt_hd, cudaStream_t st) {
    auto kern = flash_prefill_kernel<HDP, QT, KT, OT>;
    const int bytes = Smem<HDP>::kFloats * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = T * (NH / KVH);
    dim3 grid((rows + kBR - 1) / kBR, KVH, B);
    kern<<<grid, kThreads, bytes, st>>>(static_cast<const QT*>(q), static_cast<const KT*>(k),
                                        static_cast<const KT*>(v), ks, vs, start,
                                        static_cast<OT*>(out), T, NH, KVH, S, hd, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

#define TL_K6_ARGS q, k, v, ks, vs, start, out, B, T, NH, KVH, S, hd, sqrt_hd, st

template <int HDP, typename QT, typename KT>
int dispatch_out(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* start, void* out, int out_dtype, int B, int T, int NH, int KVH,
                 int S, int hd, float sqrt_hd, cudaStream_t st) {
    if (out_dtype == TL_F32) return launch<HDP, QT, KT, float>(TL_K6_ARGS);
    if (out_dtype == TL_BF16) return launch<HDP, QT, KT, __nv_bfloat16>(TL_K6_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP, typename QT>
int dispatch_cache(const void* q, int kv_dtype, const void* k, const void* v, const float* ks,
                   const float* vs, const int* start, void* out, int out_dtype, int B, int T,
                   int NH, int KVH, int S, int hd, float sqrt_hd, cudaStream_t st) {
    if (kv_dtype == TL_I8) return dispatch_out<HDP, QT, int8_t>(q, k, v, ks, vs, start, out,
                                                               out_dtype, B, T, NH, KVH, S, hd,
                                                               sqrt_hd, st);
    if (kv_dtype == TL_F32) return dispatch_out<HDP, QT, float>(q, k, v, ks, vs, start, out,
                                                               out_dtype, B, T, NH, KVH, S, hd,
                                                               sqrt_hd, st);
    if (kv_dtype == TL_BF16)
        return dispatch_out<HDP, QT, __nv_bfloat16>(q, k, v, ks, vs, start, out, out_dtype, B, T,
                                                    NH, KVH, S, hd, sqrt_hd, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int dispatch_types(const void* q, int q_dtype, int kv_dtype, const void* k, const void* v,
                   const float* ks, const float* vs, const int* start, void* out, int out_dtype,
                   int B, int T, int NH, int KVH, int S, int hd, float sqrt_hd, cudaStream_t st) {
    if (q_dtype == TL_F32)
        return dispatch_cache<HDP, float>(q, kv_dtype, k, v, ks, vs, start, out, out_dtype, B, T,
                                          NH, KVH, S, hd, sqrt_hd, st);
    if (q_dtype == TL_BF16)
        return dispatch_cache<HDP, __nv_bfloat16>(q, kv_dtype, k, v, ks, vs, start, out,
                                                  out_dtype, B, T, NH, KVH, S, hd, sqrt_hd, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

#undef TL_K6_ARGS

}  // namespace

// q [B, T, NH, hd]; k/v [B, KVH, S, hd] of kv_dtype (int8, f32 or bf16)
// with, for int8 only, f32 scales ks/vs [B, KVH, S] (null for an fp cache);
// start int32 [B] (device), out [B, T, NH * hd]; all contiguous; hd <= 128.
extern "C" int tl_flash_prefill(const void* q, int q_dtype, int kv_dtype, const void* k,
                                const void* v, const float* ks, const float* vs, const int* start,
                                void* out, int out_dtype, int B, int T, int NH, int KVH, int S,
                                int hd, float sqrt_hd, void* stream) {
    if (B <= 0 || T <= 0) return 0;
    if ((kv_dtype == TL_I8) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (hd <= 64)
        return dispatch_types<64>(q, q_dtype, kv_dtype, k, v, ks, vs, start, out, out_dtype, B, T,
                                  NH, KVH, S, hd, sqrt_hd, st);
    if (hd <= 128)
        return dispatch_types<128>(q, q_dtype, kv_dtype, k, v, ks, vs, start, out, out_dtype, B,
                                   T, NH, KVH, S, hd, sqrt_hd, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
