// K13: deferred-flush INT8 decode attention over a page pool, reading only
// the pages below each slot's position, online softmax over sub-page key
// blocks.
//
// Replaces tpu_llama/ops/attention.py:466 paged_flash_decode_attention_dma
// (its Pallas kernel _dma_decode_kernel :188 with a page-table src_of, and
// the XLA epilogue _fresh_tail_merge :307).  Contract: K9's
// (csrc/flash_decode_dma.cu) with the cache as a pool: q [B, KVH, G, hd]
// raw, qs = f32(q) / sqrt(f32(hd)); layer `layer` of the pools k/v int8
// [L, P, KVH, ps, hd] with f32 scales [L, P, KVH, ps]; slot b's position s
// lives in page page_table[b, s / ps], row s % ps; cache rows s < pos[b]
// attend (STRICT: row pos is written by the step's K14 flush); the fresh
// row nk/nv int8 [B, KVH, hd] with scales nks/nvs [B, KVH] joins the
// softmax as one extra column; out f32 [B, KVH, G, hd].  pos is clamped to
// [0, MP * ps]; a page id outside [0, P) reads page 0 (the trash page), so
// a bad table entry cannot read outside the pool.
//
// Rounding: K9's, over blocks of TS = min(256, ps) rows (halved until it
// divides ps), the JAX function's sub-page block: bf16(qs) for the cache
// scores, p = exp(s - m_block) UNNORMALIZED when rounded as bf16(p * vs),
// f32 sums, the fresh column from the unrounded qs merged after the last
// block.  The rounding points depend on TS, so K13 equals K9 bit for bit
// on a paged copy of a dense cache when K9 runs with block_s = TS.
//
// Bound on the H100: bytes, as K9: each (slot, kv head) reads pos[b] rows
// of K and V (hd bytes each) and their two f32 scales -- at Llama-2 7B,
// batch 8 at position 512, 34.6 MB per layer, 10.3 us at 3.35 TB/s.
// Design: K9's split cell (decode_split.cuh: grid (splits, KVH, B), a
// cp.async ring of K / V tiles, the partials merged by the last block of
// each (slot, kv head)), with the one difference of paging: the
// start row of key block j comes from a functor that reads
// page_table[b, j * TS / ps] (one cached load per key block) and adds the
// layer's and head's offsets in 64-bit arithmetic -- one pool array at 7B
// is 33 pages x 64 MB, past 2^31 bytes.  A key block of TS rows lies in one
// page, contiguous in the pool.  The host rule gives K13 the spans K9
// takes for the same (B, KVH, TS, rows_max = MP * ps), so K13 equals K9 on
// a paged copy bit for bit at any split.  Pages at and past pos are never
// read.  The TPU kernel's cross-cell DMA prefetch was for its in-order
// grid and is not carried.
#include <math.h>

#include "decode_split.cuh"

namespace {

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_flash_decode_dma_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                              const int8_t* __restrict__ vp, const float* __restrict__ ks,
                              const float* __restrict__ vs, const int* __restrict__ page_table,
                              const int* __restrict__ pos, const int8_t* __restrict__ nk,
                              const int8_t* __restrict__ nv, const float* __restrict__ nks,
                              const float* __restrict__ nvs, float* __restrict__ out,
                              float* __restrict__ ws, int* __restrict__ ticket, int layer,
                              int KVH, int G, int P, int ps, int MP, int hd, int TS, int splits,
                              int nt, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b], 0), MP * ps);
    const long long bh = (long long)b * KVH + h;
    const PagedRows rows{page_table + (long long)b * MP, (long long)layer * P, P, KVH, h, ps, TS};
    split_decode_cell<QT, int8_t, CH>(
        smem, nt, q + bh * G * hd, kp, vp, ks, vs, p, MP * ps, TS, G, hd, splits, nk + bh * hd,
        nks[bh], nv + bh * hd, nvs[bh], out + bh * G * hd,
        ws ? ws + bh * splits * (G * hd + 2 * G) : nullptr, ticket ? ticket + bh : nullptr,
        sqrt_hd, rows);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pt, const int* pos, const int8_t* nk, const int8_t* nv, const float* nks,
           const float* nvs, float* out, float* ws, int* ticket, int layer, int B, int KVH, int G,
           int P, int ps, int MP, int hd, int TS, int splits, float sqrt_hd, cudaStream_t st) {
    auto kern = paged_flash_decode_dma_kernel<QT, CH>;
    const int pitch = dec_pitch<int8_t>(hd);
    const int nt = SplitSmem<int8_t>::tiles(TS, pitch, G);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = SplitSmem<int8_t>::bytes(nt, TS, pitch, G);
    cudaError_t err = split_smem_attr(kern, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(splits, KVH, B), kDecThreads, bytes, st>>>(
        static_cast<const QT*>(q), k, v, ks, vs, pt, pos, nk, nv, nks, nvs, out, ws, ticket, layer,
        KVH, G, P, ps, MP, hd, TS, splits, nt, sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_chunk(int ch, const void* q, const int8_t* k, const int8_t* v, const float* ks,
                   const float* vs, const int* pt, const int* pos, const int8_t* nk,
                   const int8_t* nv, const float* nks, const float* nvs, float* out, float* ws,
                   int* ticket, int layer, int B, int KVH, int G, int P, int ps, int MP, int hd,
                   int TS, int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K13_ARGS q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, TS, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, 16>(TL_K13_ARGS);
    if (ch == 4) return launch<QT, 4>(TL_K13_ARGS);
#undef TL_K13_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the pools k/v int8 [L, P, KVH, ps, hd]
// and ks/vs f32 [L, P, KVH, ps]; page_table int32 [B, MP] and pos int32 [B]
// (device); the fresh rows nk/nv int8 [B, KVH, hd] with scales nks/nvs f32
// [B, KVH]; out f32 [B, KVH, G, hd]; ws and ticket as K9's
// (flash_decode_dma.cu); all contiguous.  The wrapper checks G <= 8,
// hd <= 128, TS | ps, TS <= 256, and ch as for K9.
extern "C" int tl_paged_flash_decode_dma(const void* q, int q_dtype, const void* k,
                                         const void* v, const float* ks, const float* vs,
                                         const int* page_table, const int* pos, const void* nk,
                                         const void* nv, const float* nks, const float* nvs,
                                         float* out, int layer, int B, int KVH, int G, int P,
                                         int ps, int MP, int hd, int TS, int splits,
                                         float sqrt_hd, int ch, float* ws, int* ticket,
                                         void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256 ||
        ps % TS != 0 || MP < 1 || P < 1 || splits < 1 || splits > 65535 ||
        (splits > 1 && (ws == nullptr || ticket == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *k8 = static_cast<const int8_t*>(k), *v8 = static_cast<const int8_t*>(v);
    const int8_t *nk8 = static_cast<const int8_t*>(nk), *nv8 = static_cast<const int8_t*>(nv);
#define TL_K13_ARGS ch, q, k8, v8, ks, vs, page_table, pos, nk8, nv8, nks, nvs, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, TS, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_chunk<float>(TL_K13_ARGS);
    if (q_dtype == TL_BF16) return dispatch_chunk<__nv_bfloat16>(TL_K13_ARGS);
#undef TL_K13_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
