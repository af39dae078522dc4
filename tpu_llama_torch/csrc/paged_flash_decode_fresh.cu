// K20: deferred-flush INT8 decode attention over a page pool with whole
// pages as the softmax's blocks, the TPU kernel's rounding.
//
// Replaces tpu_llama/ops/attention.py:1012 paged_flash_decode_attention_fresh
// (its Pallas kernel _flash_decode_kernel :38 with TS = ps on the grid
// (B, KVH, MP), the page block clamped at pos // ps).  Contract: K13's
// (csrc/paged_flash_decode_dma.cu): q [B, KVH, G, hd] raw, qs = f32(q) /
// sqrt(f32(hd)); layer `layer` of the pools k/v int8 [L, P, KVH, ps, hd]
// with f32 scales [L, P, KVH, ps]; position s of slot b in page
// page_table[b, s / ps], row s % ps; cache rows s < pos[b] attend (STRICT);
// the fresh row nk/nv int8 [B, KVH, hd] with scales nks/nvs [B, KVH] joins
// the softmax as one extra column after the last page; out f32
// [B, KVH, G, hd].  pos is clamped to [0, MP * ps]; a page id outside
// [0, P) reads page 0 (the trash page).
//
// Rounding, kept from the TPU kernel, whose key block is a WHOLE page: the
// cache score is dot(bf16(qs), k) in f32, times ks; per page m_new = max(m,
// the page's max), corr = exp(m - m_new), l = l * corr + sum exp(s -
// m_new), p = exp(s - m_new) UNNORMALIZED rounded as bf16(p * vs) for the
// PV dot (f32 sums), acc = acc * corr + p.v.  The fresh column in the
// kernel's own order (attention.py:97-121): s_new = sum(qs * nk) * nks,
// m_fin = max(m, s_new), l_fin = l * corr + e_new, out = (acc * corr +
// (e_new * nvs) * nv) / max(l_fin, 1e-30).  At more than one split each p
// rounds against its split's running max: within 2^-8 of max |out| of the
// sequential page walk.
//
// Bound on the H100: bytes, as K13: each (slot, kv head) reads pos[b] rows
// of K and V (hd bytes each) and their two f32 scales.  Design:
// decode_split_page.cuh's page-block split cell: grid (splits, KVH, B),
// split i a contiguous run of whole pages, each page read as ring tiles of
// T rows (K tiles with their scale rows, then V tiles) through a cp.async
// ring sized so an SM keeps two blocks, the page's scores and exps in
// shared memory, the partials merged in the launch by the last block of
// each (slot, kv head).  Pages at and past pos are never read.  Row
// offsets in 64-bit arithmetic: one pool array at 7B is past 2^31 bytes.
#include <math.h>

#include "decode_split_page.cuh"

namespace {

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_flash_decode_fresh_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                                const int8_t* __restrict__ vp, const float* __restrict__ ks,
                                const float* __restrict__ vs, const int* __restrict__ page_table,
                                const int* __restrict__ pos, const int8_t* __restrict__ nk,
                                const int8_t* __restrict__ nv, const float* __restrict__ nks,
                                const float* __restrict__ nvs, float* __restrict__ out,
                                float* __restrict__ ws, int* __restrict__ ticket, int layer,
                                int KVH, int G, int P, int ps, int MP, int hd, int T, int splits,
                                float sqrt_hd, int nt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b], 0), MP * ps);
    const long long bh = (long long)b * KVH + h;
    const PagedRows pages{page_table + (long long)b * MP, (long long)layer * P, P, KVH, h, ps, ps};
    split_page_cell<QT, CH, true>(
        smem, nt, q + bh * G * hd, kp, vp, ks, vs, p, MP, ps, T, G, hd, splits, nk + bh * hd,
        nks + bh, nv + bh * hd, nvs + bh, out + bh * G * hd,
        ws ? ws + bh * splits * (G * hd + 2 * G) : nullptr, ticket ? ticket + bh : nullptr,
        sqrt_hd, pages);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pt, const int* pos, const int8_t* nk, const int8_t* nv, const float* nks,
           const float* nvs, float* out, float* ws, int* ticket, int layer, int B, int KVH, int G,
           int P, int ps, int MP, int hd, int T, int splits, float sqrt_hd, cudaStream_t st) {
    return split_page_launch(paged_flash_decode_fresh_kernel<QT, CH>, splits, KVH, B, T, ps, hd,
                             G, st, static_cast<const QT*>(q), k, v, ks, vs, pt, pos, nk, nv,
                             nks, nvs, out, ws, ticket, layer, KVH, G, P, ps, MP, hd, T, splits,
                             sqrt_hd);
}

template <typename QT>
int dispatch_chunk(int ch, const void* q, const int8_t* k, const int8_t* v, const float* ks,
                   const float* vs, const int* pt, const int* pos, const int8_t* nk,
                   const int8_t* nv, const float* nks, const float* nvs, float* out, float* ws,
                   int* ticket, int layer, int B, int KVH, int G, int P, int ps, int MP, int hd,
                   int T, int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K20_ARGS q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, T, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, 16>(TL_K20_ARGS);
    if (ch == 4) return launch<QT, 4>(TL_K20_ARGS);
#undef TL_K20_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Arguments as tl_paged_flash_decode_dma (csrc/paged_flash_decode_dma.cu),
// with T the ring tile's rows (T divides ps) and splits runs of whole
// pages.  A page's G x ps scores and exps stay in shared memory, so G * ps
// is bounded; the launch is refused where not even a ring of two tiles
// fits one block.
extern "C" int tl_paged_flash_decode_fresh(const void* q, int q_dtype, const void* k,
                                           const void* v, const float* ks, const float* vs,
                                           const int* page_table, const int* pos, const void* nk,
                                           const void* nv, const float* nks, const float* nvs,
                                           float* out, int layer, int B, int KVH, int G, int P,
                                           int ps, int MP, int hd, int T, int splits,
                                           float sqrt_hd, int ch, float* ws, int* ticket,
                                           void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || T < 1 || ps % T != 0 || MP < 1 ||
        P < 1 || splits < 1 || splits > 65535 ||
        (splits > 1 && (ws == nullptr || ticket == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *k8 = static_cast<const int8_t*>(k), *v8 = static_cast<const int8_t*>(v);
    const int8_t *nk8 = static_cast<const int8_t*>(nk), *nv8 = static_cast<const int8_t*>(nv);
#define TL_K20_ARGS ch, q, k8, v8, ks, vs, page_table, pos, nk8, nv8, nks, nvs, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, T, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_chunk<float>(TL_K20_ARGS);
    if (q_dtype == TL_BF16) return dispatch_chunk<__nv_bfloat16>(TL_K20_ARGS);
#undef TL_K20_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// res[0] = the blocks one SM keeps resident for a launch of these shapes
// (CUDA's occupancy query), res[1] its ring's tiles, res[2] its shared
// memory bytes; q is bf16 and the copy chunk 16 bytes.
extern "C" int tl_paged_flash_decode_fresh_residency(int G, int hd, int T, int ps, int* res) {
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || T < 1 || ps % T != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return split_page_residency(paged_flash_decode_fresh_kernel<__nv_bfloat16, 16>, G, hd, T, ps,
                                res);
}
