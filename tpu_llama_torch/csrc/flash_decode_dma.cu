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
// templated on the cache type (decode_split.cuh split_decode_cell), one
// kernel for all three.
//
// Bound on the H100: bytes.  Each (slot, kv head) must read pos[b] rows of
// K and V (hd bytes each) and their two f32 scales: at Llama-2 7B, batch 8
// at position 512, 8 * 32 * 512 * (2 * 128 + 8) B = 34.6 MB per layer,
// 10.3 us at 3.35 TB/s.  Design: decode_split.cuh's split cell.  The grid
// is (splits, KVH, B): each block walks one contiguous span of the slot's
// key blocks through a cp.async ring of up to six K / V tiles (as many as
// leave an SM two blocks), the partials of a (slot, kv head) merged in the
// same launch by its last block, then the fresh column.  `splits` comes from the host
// rule (ops/attention.py decode_splits: one wherever B * KVH >= 132 or
// S <= 512, so the 7B batch-8 steps keep common.cuh dec_attend_rows'
// arithmetic bit for bit; else up to 264 blocks, two an SM); rows >= pos are never read, the G query heads
// of a GQA group share every K/V byte, and pos is read on the device: no
// host sync.  At more than one split a p is rounded against its split's
// running max: within 2^-8 of max |out| of the JAX function's sequential
// blocks (decode_split.cuh).
#include <math.h>

#include "decode_split.cuh"

namespace {

template <typename QT, typename CT, int CH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_dma_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                        const CT* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ pos,
                        const CT* __restrict__ nk, const CT* __restrict__ nv,
                        const float* __restrict__ nks, const float* __restrict__ nvs,
                        float* __restrict__ out, float* __restrict__ ws, int* __restrict__ ticket,
                        int layer, int B, int KVH, int G, int S, int hd, int TS, int splits,
                        int nt, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b], 0), S);
    const long long row0 = (((long long)layer * B + b) * KVH + h) * S;  // cache row of s = 0
    const long long bh = (long long)b * KVH + h;
    const bool scaled = ks != nullptr;  // an INT8 cache
    split_decode_cell<QT, CT, CH>(
        smem, nt, q + bh * G * hd, kc + row0 * hd, vc + row0 * hd, scaled ? ks + row0 : nullptr,
        scaled ? vs + row0 : nullptr, p, S, TS, G, hd, splits, nk + bh * hd,
        scaled ? nks[bh] : 1.f, nv + bh * hd, scaled ? nvs[bh] : 1.f, out + bh * G * hd,
        ws ? ws + bh * splits * (G * hd + 2 * G) : nullptr, ticket ? ticket + bh : nullptr,
        sqrt_hd, DecDenseRows{TS});
}

template <typename QT, typename CT, int CH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pos, const void* nk, const void* nv, const float* nks, const float* nvs,
           float* out, float* ws, int* ticket, int layer, int B, int KVH, int G, int S, int hd,
           int TS, int splits, float sqrt_hd, cudaStream_t st) {
    auto kern = flash_decode_dma_kernel<QT, CT, CH>;
    const int P = dec_pitch<CT>(hd);
    const int nt = SplitSmem<CT>::tiles(TS, P, G);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = SplitSmem<CT>::bytes(nt, TS, P, G);
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(splits, KVH, B), kDecThreads, bytes, st>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks, vs,
        pos, static_cast<const CT*>(nk), static_cast<const CT*>(nv), nks, nvs, out, ws, ticket,
        layer, B, KVH, G, S, hd, TS, splits, nt, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

// The blocks of this form one SM keeps resident, its ring's tiles and its
// shared memory bytes.
template <typename QT, typename CT, int CH>
int residency(int G, int hd, int TS, int* res) {
    const int P = dec_pitch<CT>(hd);
    const int nt = SplitSmem<CT>::tiles(TS, P, G);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = SplitSmem<CT>::bytes(nt, TS, P, G);
    auto kern = flash_decode_dma_kernel<QT, CT, CH>;
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[0], kern, kDecThreads, bytes);
    res[1] = nt;
    res[2] = bytes;
    return static_cast<int>(err);
}

template <typename QT, typename CT>
int dispatch_chunk(int ch, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const void* nk, const void* nv,
                   const float* nks, const float* nvs, float* out, float* ws, int* ticket,
                   int layer, int B, int KVH, int G, int S, int hd, int TS, int splits,
                   float sqrt_hd, cudaStream_t st) {
#define TL_K9_ARGS q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, ws, ticket, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, CT, 16>(TL_K9_ARGS);
    if (ch == 4) return launch<QT, CT, 4>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int dispatch_cache(int kv_dtype, int ch, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, const void* nk,
                   const void* nv, const float* nks, const float* nvs, float* out, float* ws,
                   int* ticket, int layer, int B, int KVH, int G, int S, int hd, int TS,
                   int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K9_ARGS ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, ws, ticket, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
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
// nks/nvs f32 [B, KVH]; out f32 [B, KVH, G, hd]; all contiguous.  With
// splits > 1, ws is f32 [B, KVH, splits, G * hd + 2 * G] (any contents) and
// ticket int32 [B, KVH], zero (the launch leaves it zero); both may be
// null at one split.  The wrapper checks G <= 8, hd <= 128, TS | S,
// TS <= 256, and ch: 16 promises rows of a multiple of 16 bytes and 16-byte
// aligned k/v, 4 rows of a multiple of 4 bytes.
extern "C" int tl_flash_decode_dma(const void* q, int q_dtype, int kv_dtype, const void* k,
                                   const void* v, const float* ks, const float* vs,
                                   const int* pos, const void* nk, const void* nv,
                                   const float* nks, const float* nvs, float* out, int layer,
                                   int B, int KVH, int G, int S, int hd, int TS, int splits,
                                   float sqrt_hd, int ch, float* ws, int* ticket, void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256 ||
        (kv_dtype == TL_I8) != (ks != nullptr) || splits < 1 || splits > 65535 ||
        (splits > 1 && (ws == nullptr || ticket == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_K9_ARGS kv_dtype, ch, q, k, v, ks, vs, pos, nk, nv, nks, nvs, out, ws, ticket, layer, B, KVH, G, S, hd, TS, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_cache<float>(TL_K9_ARGS);
    if (q_dtype == TL_BF16) return dispatch_cache<__nv_bfloat16>(TL_K9_ARGS);
#undef TL_K9_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// res[0] = the blocks one SM keeps resident for a launch of these shapes
// (CUDA's occupancy query), res[1] its ring's tiles, res[2] its shared
// memory bytes; q is bf16 and the copy chunk 16 bytes.
extern "C" int tl_flash_decode_dma_residency(int kv_dtype, int G, int hd, int TS, int* res) {
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256)
        return static_cast<int>(cudaErrorInvalidValue);
    if (kv_dtype == TL_I8) return residency<__nv_bfloat16, int8_t, 16>(G, hd, TS, res);
    if (kv_dtype == TL_F32) return residency<__nv_bfloat16, float, 16>(G, hd, TS, res);
    if (kv_dtype == TL_BF16) return residency<__nv_bfloat16, __nv_bfloat16, 16>(G, hd, TS, res);
    return static_cast<int>(cudaErrorInvalidValue);
}
