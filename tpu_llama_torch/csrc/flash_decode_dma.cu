// K9: deferred-flush decode attention over an INT8, f32 or bf16 cache that
// reads only the rows below each slot's position, online softmax over key
// blocks.
//
// Replaces tpu_llama/ops/attention.py:335 flash_decode_attention_dma (its
// Pallas kernel _dma_decode_kernel :188 and the XLA epilogue
// _fresh_tail_merge :307).  Contract: one query token per slot; q
// [B, KVH, G, hd] raw, qs = f32(q) / sqrt(f32(hd)); layer `layer` of the
// cache k/v int8 [L, B, KVH, S, hd] with f32 scales [L, B, KVH, S]; cache
// row s attends iff s < pos[b] (STRICT: row pos is stale until the step's
// K10 flush); the step's fresh row nk/nv int8 [B, KVH, hd] with scales
// nks/nvs [B, KVH] joins the softmax as one extra column; out f32
// [B, KVH, G, hd].
//
// Rounding, kept from the TPU kernel so that this kernel, its plain version
// and the JAX package agree to f32 noise: the cache score is
// dot(bf16(qs), k) accumulated in f32, times ks; the online softmax runs
// over blocks of TS rows, p = exp(s - m_block) is UNNORMALIZED when it is
// rounded, as bf16(p * vs), before the PV dot (f32 accumulation); the
// fresh column's score uses the unrounded f32 qs (times nks) and its value
// f32(nv) * nvs, merged after the last block as _fresh_tail_merge does.
// TS is the JAX function's block_s (128 rows for int8): the rounding points
// depend on it.  For an fp cache (attention.py:274-295, dt = f32) nothing is
// rounded: the score is dot(qs, f32(k)), p stays f32 and there are no
// scales; the default block is 64 rows (attention.py:372-373).  The cell is
// templated on the cache type (common.cuh dec_attend), one kernel for all
// three.
//
// Bound on the H100: bytes.  Each (slot, kv head) must read pos[b] rows of
// K and V (hd bytes each) and their two f32 scales: at Llama-2 7B, batch 8
// at position 512, 8 * 32 * 512 * (2 * 128 + 8) B = 34.6 MB per layer,
// 10.3 us at 3.35 TB/s.  Design: the TPU kernel's one-cell-per-slot grid
// with a cross-cell DMA prefetch existed because TPU grid cells run in
// order; here one block per (kv head, slot) (256 blocks at 7B batch 8)
// streams its ceil(pos / TS) blocks of K, then V, through a two-stage
// cp.async ring in shared memory (16-byte chunks), the next tile in flight
// while the current one is used.  Rows >= pos are never read.  The G query
// heads of a GQA group share every K/V byte, and the fresh-column merge
// runs in the same launch.  pos is read on the device: no host sync.  The
// cell's body is common.cuh's dec_attend, which K12's trailing cells run too.
#include <math.h>

#include "common.cuh"

namespace {

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_dma_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                        const CT* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ pos,
                        const CT* __restrict__ nk, const CT* __restrict__ nv,
                        const float* __restrict__ nks, const float* __restrict__ nvs,
                        float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                        int TS, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y;
    const DecSmem<CT> sm(smem, TS, dec_pitch<CT>(hd), G);
    const int p = min(max(pos[b], 0), S);
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    const bool scaled = ks != nullptr;  // an INT8 cache
    dec_load_q(q + bh * G * hd, sm.qf, sm.qb, G, hd, dec_pitch<CT>(hd), sqrt_hd);
    dec_attend<CT, CH>(sm, kc + row0 * hd, vc + row0 * hd, scaled ? ks + row0 : nullptr,
                       scaled ? vs + row0 : nullptr, p, TS, G, hd, nk + bh * hd,
                       scaled ? nks[bh] : 1.f, nv + bh * hd, scaled ? nvs[bh] : 1.f,
                       out + bh * G * hd);
}

template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, const void* nk, const void* nv, const float* nks, const float* nvs,
           float* out, int layer, int B, int KVH, int G, int S, int hd, int TS, float sqrt_hd,
           cudaStream_t st) {
    auto kern = flash_decode_dma_kernel<QT, CT, CH>;
    const int bytes = DecSmem<CT>::bytes(TS, dec_pitch<CT>(hd), G);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, bytes, st>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks, vs,
        pos, static_cast<const CT*>(nk), static_cast<const CT*>(nv), nks, nvs, out, layer, B, KVH,
        G, S, hd, TS, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const void* nk, const void* nv,
                   const float* nks, const float* nvs, float* out, int layer, int B, int KVH,
                   int G, int S, int hd, int TS, float sqrt_hd, cudaStream_t st) {
#define TL_K9_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K9_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, const void* nk,
                   const void* nv, const float* nks, const float* nvs, float* out, int layer,
                   int B, int KVH, int G, int S, int hd, int TS, float sqrt_hd, cudaStream_t st) {
#define TL_K9_ARGS ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, sqrt_hd, st
    if (kv_dtype == TL_I8) return dispatch_chunk<QT, int8_t>(TL_K9_ARGS);
    if (kv_dtype == TL_F32) return dispatch_chunk<QT, float>(TL_K9_ARGS);
    if (kv_dtype == TL_BF16) return dispatch_chunk<QT, __nv_bfloat16>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the cache k/v [L, B, KVH, S, hd] of
// kv_dtype (int8, f32 or bf16) with, for int8 only, f32 scales ks/vs
// [L, B, KVH, S] (null for an fp cache); pos int32 [B] (device); the fresh
// rows nk/nv [B, KVH, hd] of the cache's type with, for int8 only, scales
// nks/nvs f32 [B, KVH]; out f32 [B, KVH, G, hd]; all contiguous.  The
// wrapper checks G <= 8, hd <= 128, TS | S, TS <= 256, and ch: 16 promises
// rows of a multiple of 16 bytes and 16-byte aligned k/v, 4 rows of a
// multiple of 4 bytes.
extern "C" int tl_flash_decode_dma(const void* q, int q_dtype, int kv_dtype, const void* k,
                                   const void* v, const float* ks, const float* vs,
                                   const int* pos, const void* nk, const void* nv,
                                   const float* nks, const float* nvs, float* out, int layer,
                                   int B, int KVH, int G, int S, int hd, int TS, float sqrt_hd,
                                   int ch, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256 ||
        (kv_dtype == TL_I8) != (ks != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K9_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K9_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
