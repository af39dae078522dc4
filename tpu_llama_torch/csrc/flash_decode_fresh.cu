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
// Design: decode_simple.cuh's cell (K21's default form is the same cell
// without the fresh column): the same block per (kv head, slot) and
// two-stage cp.async ring as K9, but a two-pass softmax over every score of
// the slot's rows in shared memory.
#include "decode_simple.cuh"

namespace {

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_fresh_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                          const CT* __restrict__ vc, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ pos,
                          const CT* __restrict__ nk, const CT* __restrict__ nv,
                          const float* __restrict__ nks, const float* __restrict__ nvs,
                          float* __restrict__ out, int layer, int B, int KVH, int G, int S, int hd,
                          float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    dec_simple::cell<QT, CT, CH, true>(smem, q, kc, vc, ks, vs, pos, nk, nv, nks, nvs, out, layer,
                                       B, KVH, G, S, hd, sqrt_hd);
}

template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, const void* nk, const void* nv, const float* nks, const float* nvs,
           float* out, int layer, int B, int KVH, int G, int S, int hd, float sqrt_hd,
           cudaStream_t st) {
    return dec_simple::launch(flash_decode_fresh_kernel<QT, CT, CH>,
                              dec_simple::smem_bytes<CT>(G, S, hd), KVH, B, st,
                              static_cast<const QT*>(q), static_cast<const CT*>(k),
                              static_cast<const CT*>(v), ks, vs, pos, static_cast<const CT*>(nk),
                              static_cast<const CT*>(nv), nks, nvs, out, layer, B, KVH, G, S, hd,
                              sqrt_hd);
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const void* nk, const void* nv,
                   const float* nks, const float* nvs, float* out, int layer, int B, int KVH,
                   int G, int S, int hd, float sqrt_hd, cudaStream_t st) {
#define TL_K19_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K19_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, const void* nk,
                   const void* nv, const float* nks, const float* nvs, float* out, int layer,
                   int B, int KVH, int G, int S, int hd, float sqrt_hd, cudaStream_t st) {
#define TL_K19_ARGS ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (kv_dtype == TL_I8) return dispatch_chunk<QT, int8_t>(TL_K19_ARGS);
    if (kv_dtype == TL_F32) return dispatch_chunk<QT, float>(TL_K19_ARGS);
    if (kv_dtype == TL_BF16) return dispatch_chunk<QT, __nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Arguments as tl_flash_decode_dma (csrc/flash_decode_dma.cu) without TS;
// every score of a (slot, kv head) stays in shared memory, so G * S is
// bounded (about 50k f32 at hd 128).
extern "C" int tl_flash_decode_fresh(const void* q, int q_dtype, int kv_dtype, const void* k,
                                     const void* v, const float* ks, const float* vs,
                                     const int* pos, const void* nk, const void* nv,
                                     const float* nks, const float* nvs, float* out, int layer,
                                     int B, int KVH, int G, int S, int hd, float sqrt_hd, int ch,
                                     void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || (kv_dtype == TL_I8) != (ks != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K19_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, S, hd, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K19_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K19_ARGS);
#undef TL_K19_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
