// K19: deferred-flush decode attention over an INT8, f32 or bf16 cache,
// single pass over the rows below each slot's position with the softmax
// normalized before its bf16 rounding.
//
// Replaces tpu_llama/ops/attention.py:807 flash_decode_attention_fresh (its
// Pallas kernel _flash_decode_fresh_kernel :127).  The contract is K9's
// (csrc/flash_decode_dma.cu): q [B, KVH, G, hd] raw, qs = f32(q) /
// sqrt(f32(hd)); cache rows s < pos[b] of layer `layer` (STRICT: row pos is
// stale until the step's K10 flush) plus the fresh row nk/nv as one extra
// column; out f32 [B, KVH, G, hd].  The TPU kernel's head_block folding of
// KV heads into one grid cell is a TPU grid detail and is not carried.
//
// Rounding, kept from the TPU kernel (attention.py:150-185): the cache score
// is dot(bf16(qs), k) in f32, times ks; the fresh score uses the unrounded
// f32 qs, times nks; m = max(scores, fresh score); p = exp(s - m) / l is
// NORMALIZED before it is rounded, as bf16(p * vs), for the PV dot (f32
// accumulation); the fresh column adds (exp(s_new - m) / l * nvs) * f32(nv).
// That is where this kernel differs from K9, which rounds unnormalized
// blockwise p: the two agree only to about 2e-2 (tests/test_attention.py).
// For an fp cache (the kernel's int8=False branch, attention.py:152-181)
// nothing is rounded and there are no scales: s = dot(qs, f32(k)), p =
// exp(s - m) / l in f32; K9 and K19 then agree to f32 summation noise.  The
// kernel is templated on the cache type (CT), one kernel for all three.
//
// Bound on the H100: bytes, as K9: each (slot, kv head) reads pos[b] rows of
// K and V and their scales -- at B = 1 and position 2047, 32 kv heads x
// 2047 x (2 * 128 + 8) B = 17.3 MB per layer, 5.2 us at 3.35 TB/s.
// Design: decode_split_norm.cuh's cell with the fresh column: the slot's
// rows split over a thread-block cluster of `splits` blocks (the host rule
// ops/attention.py norm_splits), which agree on the global max and
// denominator through distributed shared memory before any p is rounded,
// and merge their PV partials in the launch.
#include "decode_split_norm.cuh"

namespace {

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_fresh_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                          const CT* __restrict__ vc, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ pos,
                          const CT* __restrict__ nk, const CT* __restrict__ nv,
                          const float* __restrict__ nks, const float* __restrict__ nvs,
                          float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                          int TS, int splits, int nt, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b], 0), S);  // rows s < pos
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    const bool scaled = ks != nullptr;  // an INT8 cache
    norm_decode_cell<QT, CT, CH, true>(
        smem, nt, q + bh * G * hd, kc + row0 * hd, vc + row0 * hd, scaled ? ks + row0 : nullptr,
        scaled ? vs + row0 : nullptr, p, S, TS, G, hd, splits, nk + bh * hd,
        scaled ? nks[bh] : 1.f, nv + bh * hd, scaled ? nvs[bh] : 1.f, out + bh * G * hd,
        sqrt_hd);
}

template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, const void* nk, const void* nv, const float* nks, const float* nvs,
           float* out, int layer, int B, int KVH, int G, int S, int hd, int TS, int splits,
           float sqrt_hd, cudaStream_t st) {
    int nt = 0, bytes = 0;
    norm_plan<CT>(G, hd, S, TS, splits, &nt, &bytes);
    return norm_launch(flash_decode_fresh_kernel<QT, CT, CH>, nt, bytes, splits, KVH, B, st,
                       static_cast<const QT*>(q), static_cast<const CT*>(k),
                       static_cast<const CT*>(v), ks, vs, pos, static_cast<const CT*>(nk),
                       static_cast<const CT*>(nv), nks, nvs, out, layer, B, KVH, G, S, hd, TS,
                       splits, nt, sqrt_hd);
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const void* nk, const void* nv,
                   const float* nks, const float* nvs, float* out, int layer, int B, int KVH,
                   int G, int S, int hd, int TS, int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K19_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K19_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, const void* nk,
                   const void* nv, const float* nks, const float* nvs, float* out, int layer,
                   int B, int KVH, int G, int S, int hd, int TS, int splits, float sqrt_hd,
                   cudaStream_t st) {
#define TL_K19_ARGS ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (kv_dtype == TL_I8) return dispatch_chunk<QT, int8_t>(TL_K19_ARGS);
    if (kv_dtype == TL_F32) return dispatch_chunk<QT, float>(TL_K19_ARGS);
    if (kv_dtype == TL_BF16) return dispatch_chunk<QT, __nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename CT>
int residency(int G, int hd, int S, int TS, int splits, int* res) {
    int nt = 0, bytes = 0;
    norm_plan<CT>(G, hd, S, TS, splits, &nt, &bytes);
    return norm_residency(flash_decode_fresh_kernel<__nv_bfloat16, CT, 16>, nt, bytes, splits, 1,
                          1, res);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the cache k/v [L, B, KVH, S, hd] of
// kv_dtype (int8, f32 or bf16) with, for int8 only, f32 scales ks/vs
// [L, B, KVH, S] (null for an fp cache); pos int32 [B] (device); the fresh
// rows nk/nv [B, KVH, hd] of the cache's type with, for int8 only, scales
// nks/nvs f32 [B, KVH]; out f32 [B, KVH, G, hd]; all contiguous.  TS is the
// ring's tile rows (norm_tile_ok) and sets the spans of the `splits` (1 to 8) blocks of a
// (slot, kv head); every score of a span stays in shared memory, so G times
// the longest span is bounded (refused past what one block's shared memory
// holds beside a two-tile ring).  ch as for K9.
extern "C" int tl_flash_decode_fresh(const void* q, int q_dtype, int kv_dtype, const void* k,
                                     const void* v, const float* ks, const float* vs,
                                     const int* pos, const void* nk, const void* nv,
                                     const float* nks, const float* nvs, float* out, int layer,
                                     int B, int KVH, int G, int S, int hd, int TS, int splits,
                                     float sqrt_hd, int ch, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || !norm_tile_ok(S, TS) ||
        (kv_dtype == TL_I8) != (ks != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K19_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K19_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// res[0] = the blocks one SM keeps resident for a launch of these shapes,
// res[1] its ring's tiles, res[2] its shared memory bytes, res[3] the
// clusters of `splits` blocks the card keeps resident at once (CUDA's
// occupancy queries); q is bf16 and the copy chunk 16 bytes.
extern "C" int tl_flash_decode_fresh_residency(int kv_dtype, int G, int hd, int S, int TS,
                                               int splits, int* res) {
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || !norm_tile_ok(S, TS))
        return static_cast<int>(cudaErrorInvalidValue);
    if (kv_dtype == TL_I8) return residency<int8_t>(G, hd, S, TS, splits, res);
    if (kv_dtype == TL_F32) return residency<float>(G, hd, S, TS, splits, res);
    if (kv_dtype == TL_BF16) return residency<__nv_bfloat16>(G, hd, S, TS, splits, res);
    return static_cast<int>(cudaErrorInvalidValue);
}
