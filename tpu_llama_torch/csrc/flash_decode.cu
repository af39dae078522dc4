// K21: write-then-attend decode attention over an INT8, f32 or bf16 cache:
// each slot's G query rows per kv head attend the rows s <= pos[b] of layer
// `layer` (the step's row was written before the call).
//
// Replaces tpu_llama/ops/attention.py:616 flash_decode_attention, in both
// of its forms:
// * the default, block_s = None, so one key block of all S rows: the
//   single-pass _flash_decode_simple_kernel (:569).  Rows s <= pos are
//   masked in, then e = exp(s - m), l = sum(e), p = e / l, NORMALIZED
//   before the V scale and the bf16 round (INT8: bf16(p * vs) . bf16(v)).
//   This is decode_split_norm.cuh's cell without K19's fresh column: the
//   rows split over a thread-block cluster of `splits` blocks that agree on
//   m and l before any p is rounded;
// * the blocked online softmax, _flash_decode_kernel (:38) without its
//   fresh refs, when block_s gives TS < S: blocks past pos // TS are
//   skipped, p = exp(s - m_block) stays UNNORMALIZED when it is rounded as
//   bf16(p * vs), and out = acc / max(l, 1e-30).  This is common.cuh's
//   dec_attend_rows with DecDenseRows and kFresh = false.
// The two round at other points and are not bit-equal.  Contract: q
// [B, KVH, G, hd] raw, qs = f32(q) / sqrt(f32(hd)) (a true division,
// :655); scores dot(bf16(qs), k) times ks for an INT8 cache, dot(qs, f32(k))
// for an fp one (nothing rounded, no scales); out f32 [B, KVH, G, hd].  The
// TPU's padding of G to 8 query rows (_pad_g) is a Mosaic tile rule and is
// not carried.  A negative pos attends nothing: zeros.
//
// Bound on the H100: bytes: each (slot, kv head) reads pos[b] + 1 rows of K
// and V and, for INT8, their two f32 scales -- at 7B, batch 8 at position
// 512, 8 * 32 * 513 * (2 * 128 + 8) B = 34.7 MB per layer, 10.3 us at
// 3.35 TB/s.  Design: the default form splits each slot's rows over a
// cluster (the host rule ops/attention.py norm_splits: at the unfused TP
// decode's local shapes one split at tp 1, up to eight at tp 8), each split
// streaming its span's K tiles, then its V tiles, through
// decode_split.cuh's ring; the blocked form keeps one block per (kv head,
// slot) and K9's two-stage ring of K / V tiles.
#include "decode_split_norm.cuh"

namespace {

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_blocked_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                            const CT* __restrict__ vc, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            float* __restrict__ out, int layer, int B, int KVH, int G, int S,
                            int hd, int TS, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y;
    const DecSmem<CT> sm(smem, TS, dec_pitch<CT>(hd), G);
    const int p = min(max(pos[b] + 1, 0), S);  // rows s <= pos
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    const bool scaled = ks != nullptr;  // an INT8 cache
    dec_load_q(q + bh * G * hd, sm.qf, sm.qb, G, hd, dec_pitch<CT>(hd), sqrt_hd);
    dec_attend_rows<CT, CH, DecDenseRows, false>(
        sm, kc + row0 * hd, vc + row0 * hd, scaled ? ks + row0 : nullptr,
        scaled ? vs + row0 : nullptr, p, TS, G, hd, nullptr, 0.f, nullptr, 0.f,
        out + bh * G * hd, DecDenseRows{TS});
}

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_simple_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                           const CT* __restrict__ vc, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ pos,
                           float* __restrict__ out, int layer, int B, int KVH, int G, int S,
                           int hd, int TS, int splits, int nt, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b] + 1, 0), S);  // rows s <= pos
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    const bool scaled = ks != nullptr;  // an INT8 cache
    norm_decode_cell<QT, CT, CH, false>(
        smem, nt, q + bh * G * hd, kc + row0 * hd, vc + row0 * hd, scaled ? ks + row0 : nullptr,
        scaled ? vs + row0 : nullptr, p, S, TS, G, hd, splits, nullptr, 1.f, nullptr, 1.f,
        out + bh * G * hd, sqrt_hd);
}

template <typename QT, typename CT, int CH>
int launch_blocked(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const int* pos, float* out, int layer, int B, int KVH, int G, int S, int hd,
                   int TS, float sqrt_hd, cudaStream_t st) {
    auto kern = flash_decode_blocked_kernel<QT, CT, CH>;
    const int bytes = DecSmem<CT>::bytes(TS, dec_pitch<CT>(hd), G);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, bytes, st>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks, vs,
        pos, out, layer, B, KVH, G, S, hd, TS, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

// splits >= 1: the single-pass form over ring tiles of TS rows; 0: the
// blocked form over key blocks of TS rows
template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, float* out, int layer, int B, int KVH, int G, int S, int hd, int TS,
           int splits, float sqrt_hd, cudaStream_t st) {
    if (splits == 0)
        return launch_blocked<QT, CT, CH>(q, k, v, ks, vs, pos, out, layer, B, KVH, G, S, hd, TS,
                                          sqrt_hd, st);
    int nt = 0, bytes = 0;
    norm_plan<CT>(G, hd, S, TS, splits, &nt, &bytes);
    return norm_launch(flash_decode_simple_kernel<QT, CT, CH>, nt, bytes, splits, KVH, B, st,
                       static_cast<const QT*>(q), static_cast<const CT*>(k),
                       static_cast<const CT*>(v), ks, vs, pos, out, layer, B, KVH, G, S, hd, TS,
                       splits, nt, sqrt_hd);
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, float* out, int layer, int B, int KVH, int G,
                   int S, int hd, int TS, int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K21_ARGS q, k, v, ks, vs, pos, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K21_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K21_ARGS);
#undef TL_K21_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, float* out, int layer,
                   int B, int KVH, int G, int S, int hd, int TS, int splits, float sqrt_hd,
                   cudaStream_t st) {
#define TL_K21_ARGS ch, q, k, v, ks, vs, pos, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (kv_dtype == TL_I8) return dispatch_chunk<QT, int8_t>(TL_K21_ARGS);
    if (kv_dtype == TL_F32) return dispatch_chunk<QT, float>(TL_K21_ARGS);
    if (kv_dtype == TL_BF16) return dispatch_chunk<QT, __nv_bfloat16>(TL_K21_ARGS);
#undef TL_K21_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename CT>
int residency(int G, int hd, int S, int TS, int splits, int* res) {
    int nt = 0, bytes = 0;
    norm_plan<CT>(G, hd, S, TS, splits, &nt, &bytes);
    return norm_residency(flash_decode_simple_kernel<__nv_bfloat16, CT, 16>, nt, bytes, splits, 1,
                          1, res);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the cache k/v [L, B, KVH, S, hd] of
// kv_dtype (int8, f32 or bf16) with, for int8 only, f32 scales ks/vs
// [L, B, KVH, S] (null for an fp cache); pos int32 [B] (device); out f32
// [B, KVH, G, hd]; all contiguous.  splits 1 to 8 runs the single-pass form
// over ring tiles of TS rows (norm_tile_ok), which also set the splits'
// spans; G times the longest span's rows of scores stay in shared memory
// (refused when they do not fit).  splits 0 runs the blocked form over key
// blocks of TS rows (TS | S, TS < S, TS <= 256).  ch as for K9.
extern "C" int tl_flash_decode(const void* q, int q_dtype, int kv_dtype, const void* k,
                               const void* v, const float* ks, const float* vs, const int* pos,
                               float* out, int layer, int B, int KVH, int G, int S, int hd,
                               int TS, int splits, float sqrt_hd, int ch, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    const bool blocked = splits == 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || S < 1 || TS < 1 ||
        (blocked ? (S % TS != 0 || TS >= S || TS > 256) : !norm_tile_ok(S, TS)) ||
        (kv_dtype == TL_I8) != (ks != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K21_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K21_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K21_ARGS);
#undef TL_K21_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// The single-pass form's residency at these shapes, as
// tl_flash_decode_fresh_residency (csrc/flash_decode_fresh.cu).
extern "C" int tl_flash_decode_residency(int kv_dtype, int G, int hd, int S, int TS, int splits,
                                         int* res) {
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || !norm_tile_ok(S, TS))
        return static_cast<int>(cudaErrorInvalidValue);
    if (kv_dtype == TL_I8) return residency<int8_t>(G, hd, S, TS, splits, res);
    if (kv_dtype == TL_F32) return residency<float>(G, hd, S, TS, splits, res);
    if (kv_dtype == TL_BF16) return residency<__nv_bfloat16>(G, hd, S, TS, splits, res);
    return static_cast<int>(cudaErrorInvalidValue);
}
