// K9: deferred-flush decode attention over an INT8 cache that reads only the
// rows below each slot's position, online softmax over key blocks.
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
// depend on it.
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

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_dma_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                        const int8_t* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ pos,
                        const int8_t* __restrict__ nk, const int8_t* __restrict__ nv,
                        const float* __restrict__ nks, const float* __restrict__ nvs,
                        float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                        int TS, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y;
    const DecSmem sm(smem, TS, dec_pitch(hd), G);
    const int p = min(max(pos[b], 0), S);
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    dec_load_q(q + bh * G * hd, sm.qf, sm.qb, G, hd, dec_pitch(hd), sqrt_hd);
    dec_attend<CH>(sm, kc + row0 * hd, vc + row0 * hd, ks + row0, vs + row0, p, TS, G, hd,
                   nk + bh * hd, nks[bh], nv + bh * hd, nvs[bh], out + bh * G * hd);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pos, const int8_t* nk, const int8_t* nv, const float* nks,
           const float* nvs, float* out, int layer, int B, int KVH, int G, int S, int hd, int TS,
           float sqrt_hd, cudaStream_t st) {
    auto kern = flash_decode_dma_kernel<QT, CH>;
    const int bytes = DecSmem::bytes(TS, dec_pitch(hd), G);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, bytes, st>>>(static_cast<const QT*>(q), k, v, ks, vs, pos, nk,
                                                   nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS,
                                                   sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16), k/v int8 [L, B, KVH, S, hd], ks/vs f32
// [L, B, KVH, S], pos int32 [B] (device), nk/nv int8 [B, KVH, hd], nks/nvs
// f32 [B, KVH], out f32 [B, KVH, G, hd]; all contiguous.  The wrapper
// checks G <= 8, hd <= 128, TS | S, TS <= 256, and ch: 16 promises
// hd % 16 == 0 and 16-byte aligned k/v, 4 promises hd % 4 == 0.
extern "C" int tl_flash_decode_dma(const void* q, int q_dtype, const int8_t* k, const int8_t* v,
                                   const float* ks, const float* vs, const int* pos,
                                   const int8_t* nk, const int8_t* nv, const float* nks,
                                   const float* nvs, float* out, int layer, int B, int KVH, int G,
                                   int S, int hd, int TS, float sqrt_hd, int ch, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K9_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, TS, sqrt_hd, st
    if (q_dtype == TL_F32 && ch == 16) return launch<float, 16>(TL_K9_ARGS);
    if (q_dtype == TL_F32 && ch == 4) return launch<float, 4>(TL_K9_ARGS);
    if (q_dtype == TL_BF16 && ch == 16) return launch<__nv_bfloat16, 16>(TL_K9_ARGS);
    if (q_dtype == TL_BF16 && ch == 4) return launch<__nv_bfloat16, 4>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
