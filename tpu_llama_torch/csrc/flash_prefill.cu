// K6: causal prefill attention over an INT8, f32 or bf16 K/V cache,
// GQA-native.
//
// Replaces tpu_llama/ops/attention.py:1654 flash_prefill_attention (its
// Pallas kernels _flash_prefill_kernel :1583, _flash_prefill_fresh_kernel
// :1499 and _flash_prefill_hb_kernel :1421).  Contract (attention.py
// :1675-1768): q [B, T, NH, hd] is pre-scaled by 1/sqrt(hd) (a division,
// :1699); the G = NH / KVH query heads of kv head h fold into rows
// r = t * G + g; key s attends iff s <= start[b] + t; for an INT8 cache K
// scales multiply the score columns and V scales the probability columns;
// the output [B, T, NH * hd] is acc / max(l, 1e-30), cast once to the
// output type.
//
// Bound on the H100: at the 7B prefill shape (T = 512, hd = 128) the causal
// work is ~0.5 GFLOP per (b, kv head) pair against 0.2 MB of int8 K/V, so
// bf16 tensor-core operations bound it.
//
// The INT8 form runs prefill_mma.cuh's bf16 tensor-core cell (shared with
// K16) at the TPU kernels' own rounding points: q and p * vs rounded to
// bf16 before mma.sync dots with f32 accumulation (the contract is in that
// header).  Its key source is the slot's run of S cache rows.  (It replaced
// the f32 SIMT cell's INT8 form, 1.51 and 0.98 ms at the two phase-3 shapes
// on an H100: 25x and 12x SDPA on the dequantized cache.)
//
// The fp forms (f32 and bf16 caches) run prefill_split.cuh's split
// tensor-core cells: JAX's fp branch is f32 dots and f32 p (attention.py
// :1613-1640), which a bf16 dot is not, so each f32 operand goes in as a
// sum of terms the tensor cores take exactly (three bf16 terms on a bf16
// cache, two TF32 terms on an f32 one) and every dot as a sum of exact
// products, which agree with the plain version to f32 noise; they scale
// q . k by 1 / sqrt(hd), as the plain version attention_prefill does, where
// the INT8 form pre-scales q.  K/V rows come straight from the cache in its
// own type.
#include "prefill_mma.cuh"
#include "prefill_split.cuh"

namespace {

// K6's fp keys for the split cell: rows [0, S) of one (slot, kv head) of a
// dense f32 or bf16 cache.
template <typename KT>
struct DenseKeysFp {
    const KT* kc;
    const KT* vc;
    long long base;  // row index of key 0
    int S, hd;

    __device__ __forceinline__ int kend(int e) const { return min(S, e); }
    __device__ __forceinline__ bool ok(int c) const { return c < S; }
    __device__ __forceinline__ bool all_ok(int c0) const { return c0 + prefill_split::kBC <= S; }
    __device__ __forceinline__ const KT* k_row(int c) const { return kc + (base + c) * hd; }
    __device__ __forceinline__ const KT* v_row(int c) const { return vc + (base + c) * hd; }
};

// K6's INT8 keys for the tensor-core cell: rows [0, S) of one (slot, kv
// head) of a dense cache.
struct DenseKeys8 {
    const int8_t* kc;
    const int8_t* vc;
    const float* ks;
    const float* vs;
    long long base;  // row index of key 0
    int S, hd;

    __device__ __forceinline__ int kend(int e) const { return min(S, e); }
    __device__ __forceinline__ bool ok(int c) const { return c < S; }
    __device__ __forceinline__ bool all_ok(int c0) const { return c0 + prefill_mma::kBC <= S; }
    __device__ __forceinline__ prefill_mma::KeyRow locate(int c) const {
        const bool have = c < S;
        const long long r = base + (have ? c : 0);
        return {kc + r * hd, vc + r * hd, ks + r, vs + r, have};
    }
};

template <int HDP, typename QT, typename OT>
__global__ void __launch_bounds__(32 * prefill_mma::kNW)
flash_prefill_i8_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                        const int8_t* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ start,
                        OT* __restrict__ out, int T, int NH, int KVH, int S, int hd,
                        float sqrt_hd, int vec) {
    const int h = blockIdx.x, b = blockIdx.y;
    const DenseKeys8 keys{kc, vc, ks, vs, ((long long)b * KVH + h) * S, S, hd};
    prefill_mma::attend<HDP, prefill_mma::kNW, false>(q, out, keys, start[b], T, NH, KVH, hd,
                                                      sqrt_hd, vec != 0);
}

template <int HDP, typename QT, typename OT>
int launch_i8(const void* q, const void* k, const void* v, const float* ks, const float* vs,
              const int* start, void* out, int B, int T, int NH, int KVH, int S, int hd,
              float sqrt_hd, cudaStream_t st) {
    auto kern = flash_prefill_i8_kernel<HDP, QT, OT>;
    constexpr int bytes = prefill_mma::kSmemBytes<HDP>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies where every row starts on 16 bytes
    const int vec = hd % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
    const int rows = T * (NH / KVH);
    constexpr int kBR = 16 * prefill_mma::kNW;
    dim3 grid(KVH, B, (rows + kBR - 1) / kBR);
    kern<<<grid, 32 * prefill_mma::kNW, bytes, st>>>(
        static_cast<const QT*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        ks, vs, start, static_cast<OT*>(out), T, NH, KVH, S, hd, sqrt_hd, vec);
    return static_cast<int>(cudaGetLastError());
}

template <int HDP, int NW, typename QT, typename KT, typename OT>
__global__ void __launch_bounds__(32 * NW)
flash_prefill_fp_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc, const int* __restrict__ start,
                        OT* __restrict__ out, int T, int NH, int KVH, int S, int hd,
                        float sqrt_hd, int vec) {
    const int h = blockIdx.x, b = blockIdx.y;
    const DenseKeysFp<KT> keys{kc, vc, ((long long)b * KVH + h) * S, S, hd};
    const bool qvec = hd % (16 / static_cast<int>(sizeof(QT))) == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0;
    if constexpr (sizeof(KT) == 2)
        prefill_split::attend_bf16<HDP, NW, QT, OT>(q, out, keys, start[b], T, NH, KVH, hd,
                                                    sqrt_hd, vec != 0, qvec);
    else
        prefill_split::attend_tf32<HDP, NW, QT, OT>(q, out, keys, start[b], T, NH, KVH, hd,
                                                    sqrt_hd, vec != 0, qvec);
}

template <int HDP, int NW, typename QT, typename KT, typename OT>
int launch_fp(const void* q, const void* k, const void* v, const int* start, void* out, int B,
              int T, int NH, int KVH, int S, int hd, float sqrt_hd, int vec, cudaStream_t st) {
    auto kern = flash_prefill_fp_kernel<HDP, NW, QT, KT, OT>;
    constexpr int bytes = prefill_split::kSmemBytes<HDP, NW, QT, KT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = T * (NH / KVH);
    dim3 grid(KVH, B, (rows + 16 * NW - 1) / (16 * NW));
    kern<<<grid, 32 * NW, bytes, st>>>(static_cast<const QT*>(q), static_cast<const KT*>(k),
                                       static_cast<const KT*>(v), start, static_cast<OT*>(out),
                                       T, NH, KVH, S, hd, sqrt_hd, vec);
    return static_cast<int>(cudaGetLastError());
}

// The fp forms' blocks of 8 warps (128 folded rows) where that still gives
// every SM a block, else of 4.
template <int HDP, typename QT, typename KT, typename OT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* start, void* out, int B, int T, int NH, int KVH, int S, int hd,
           float sqrt_hd, cudaStream_t st) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    // 16-byte copies where every row starts on 16 bytes
    const int vec = hd % (16 / static_cast<int>(sizeof(KT))) == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
    const long long blocks8 = (long long)KVH * B * ((T * (NH / KVH) + 127) / 128);
    if (blocks8 >= sms)
        return launch_fp<HDP, 8, QT, KT, OT>(q, k, v, start, out, B, T, NH, KVH, S, hd, sqrt_hd,
                                             vec, st);
    return launch_fp<HDP, 4, QT, KT, OT>(q, k, v, start, out, B, T, NH, KVH, S, hd, sqrt_hd, vec,
                                         st);
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
int dispatch_out_i8(const void* q, const void* k, const void* v, const float* ks,
                    const float* vs, const int* start, void* out, int out_dtype, int B, int T,
                    int NH, int KVH, int S, int hd, float sqrt_hd, cudaStream_t st) {
    if (out_dtype == TL_F32) return launch_i8<HDP, QT, float>(TL_K6_ARGS);
    if (out_dtype == TL_BF16) return launch_i8<HDP, QT, __nv_bfloat16>(TL_K6_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP, typename QT>
int dispatch_cache(const void* q, int kv_dtype, const void* k, const void* v, const float* ks,
                   const float* vs, const int* start, void* out, int out_dtype, int B, int T,
                   int NH, int KVH, int S, int hd, float sqrt_hd, cudaStream_t st) {
    if (kv_dtype == TL_I8) return dispatch_out_i8<HDP, QT>(q, k, v, ks, vs, start, out,
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
