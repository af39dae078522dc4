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
// Bound on the H100: at the 7B prefill shape (T = 512, hd = 128) the causal
// work is ~0.5 GFLOP per (b, kv head) pair against 0.2 MB of int8 K/V, so
// operations bound it.  Design: prefill_cell.cuh's f32 SIMT cell (shared
// with K16), its key source the slot's run of S cache rows: every 64-key
// tile is read from that run, K/V converted from the cache type (KT: int8,
// f32 or bf16) to f32 once per tile.  Rounding: f32 throughout; the TPU
// kernel's bf16 rounding of q and p * vs (attention.py:1534-1548) is left
// out, so the result agrees with the plain f32 version to f32
// summation-order noise.
#include "prefill_cell.cuh"

namespace {

using prefill::kBC;
using prefill::kThreads;

// K6's keys: rows [0, S) of one (slot, kv head) of a dense cache; an fp
// cache has no scales (1).
template <int HDP, typename KT>
struct DenseKeys {
    const KT* kc;
    const KT* vc;
    const float* ks;
    const float* vs;
    long long base;  // row index of key 0
    int S, hd;

    __device__ __forceinline__ int kend(int e) const { return min(S, e); }
    __device__ __forceinline__ bool ok(int c) const { return c < S; }
    __device__ __forceinline__ void load_k(int c0, float* KV, float* ksc, float* vsc) const {
        prefill::load_run<HDP>(kc, base + c0, S - c0, hd, KV);
        const int tid = threadIdx.x;
        if (tid < kBC) {
            const bool ok = c0 + tid < S;
            ksc[tid] = ok ? (ks ? __ldg(ks + base + c0 + tid) : 1.f) : 0.f;  // fp: no scales
            vsc[tid] = ok ? (vs ? __ldg(vs + base + c0 + tid) : 1.f) : 0.f;
        }
    }
    __device__ __forceinline__ void load_v(int c0, float* KV) const {
        prefill::load_run<HDP>(vc, base + c0, S - c0, hd, KV);
    }
};

template <int HDP, typename QT, typename KT, typename OT>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                     const KT* __restrict__ vc, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ start,
                     OT* __restrict__ out, int T, int NH, int KVH, int S, int hd,
                     float sqrt_hd) {
    const int h = blockIdx.y, b = blockIdx.z;
    DenseKeys<HDP, KT> keys{kc, vc, ks, vs, ((long long)b * KVH + h) * S, S, hd};
    prefill::attend<HDP>(q, out, keys, start[b], T, NH, KVH, hd, sqrt_hd);
}

template <int HDP, typename QT, typename KT, typename OT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* start, void* out, int B, int T, int NH, int KVH, int S, int hd,
           float sqrt_hd, cudaStream_t st) {
    auto kern = flash_prefill_kernel<HDP, QT, KT, OT>;
    const int bytes = prefill::kCellFloats<HDP> * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = T * (NH / KVH);
    dim3 grid((rows + prefill::kBR - 1) / prefill::kBR, KVH, B);
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
