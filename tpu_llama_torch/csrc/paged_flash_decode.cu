// K22: write-then-attend INT8 decode attention over a page pool: each
// slot's query attends its rows t <= pos through the page table, with
// whole pages as the softmax's blocks, the TPU kernel's rounding.
//
// Replaces tpu_llama/ops/attention.py:933 paged_flash_decode_attention (its
// Pallas kernel _flash_decode_kernel :38 with TS = ps and no fresh refs).
// Contract: q [B, KVH, G, hd] raw, qs = f32(q) / sqrt(f32(hd)); layer
// `layer` of the pools k/v int8 [L, P, KVH, ps, hd] with f32 scales
// [L, P, KVH, ps]; slot b's position s lives in page page_table[b, s / ps],
// row s % ps; rows s <= pos[b] attend (the step's row was written before
// the call); out f32 [B, KVH, G, hd] = acc / max(l, 1e-30).  pos is clamped
// to [-1, MP * ps - 1] (a negative pos attends nothing: zeros, as the JAX
// kernel's all-masked blocks give); a page id outside [0, P) reads page 0
// (the trash page), so a bad table entry cannot read outside the pool.
//
// Rounding, kept from the TPU kernel, whose key block is a WHOLE page:
// bf16(qs) for the scores, times ks; per page m_new = max(m, the page's
// max), corr = exp(m - m_new), l = l * corr + sum exp(s - m_new), p =
// exp(s - m_new) UNNORMALIZED rounded as bf16(p * vs), f32 sums, acc = acc
// * corr + p.v.  At more than one split each p rounds against its split's
// running max: within 2^-8 of max |out| of the sequential page walk.
//
// Bound on the H100: bytes, as K13: each (slot, kv head) reads pos[b] + 1
// rows of K and V (hd bytes each) and their two f32 scales.  Design: K20's
// page-block split cell (decode_split_page.cuh) without the fresh column,
// through p = pos + 1.  Nothing in the JAX package calls the TPU kernel;
// the port's serving path does not call this one either.
#include <math.h>

#include "decode_split_page.cuh"

namespace {

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_flash_decode_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                          const int8_t* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ page_table,
                          const int* __restrict__ pos, float* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ ticket, int layer, int KVH,
                          int G, int P, int ps, int MP, int hd, int T, int splits, float sqrt_hd,
                          int nt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int p = min(max(pos[b], -1), MP * ps - 1) + 1;  // rows t <= pos
    const long long bh = (long long)b * KVH + h;
    const PagedRows pages{page_table + (long long)b * MP, (long long)layer * P, P, KVH, h, ps, ps};
    split_page_cell<QT, CH, false>(smem, nt, q + bh * G * hd, kp, vp, ks, vs, p, MP, ps, T, G, hd,
                                   splits, nullptr, nullptr, nullptr, nullptr, out + bh * G * hd,
                                   ws ? ws + bh * splits * (G * hd + 2 * G) : nullptr,
                                   ticket ? ticket + bh : nullptr, sqrt_hd, pages);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pt, const int* pos, float* out, float* ws, int* ticket, int layer, int B,
           int KVH, int G, int P, int ps, int MP, int hd, int T, int splits, float sqrt_hd,
           cudaStream_t st) {
    return split_page_launch(paged_flash_decode_kernel<QT, CH>, splits, KVH, B, T, ps, hd, G, st,
                             static_cast<const QT*>(q), k, v, ks, vs, pt, pos, out, ws, ticket,
                             layer, KVH, G, P, ps, MP, hd, T, splits, sqrt_hd);
}

template <typename QT>
int dispatch_chunk(int ch, const void* q, const int8_t* k, const int8_t* v, const float* ks,
                   const float* vs, const int* pt, const int* pos, float* out, float* ws,
                   int* ticket, int layer, int B, int KVH, int G, int P, int ps, int MP, int hd,
                   int T, int splits, float sqrt_hd, cudaStream_t st) {
#define TL_K22_ARGS q, k, v, ks, vs, pt, pos, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, T, splits, sqrt_hd, st
    if (ch == 16) return launch<QT, 16>(TL_K22_ARGS);
    if (ch == 4) return launch<QT, 4>(TL_K22_ARGS);
#undef TL_K22_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the pools k/v int8 [L, P, KVH, ps, hd]
// and ks/vs f32 [L, P, KVH, ps]; page_table int32 [B, MP] and pos int32 [B]
// (device); out f32 [B, KVH, G, hd]; T the ring tile's rows (T divides
// ps); splits runs of whole pages, with ws and ticket as K13's
// (paged_flash_decode_dma.cu); all contiguous.  The wrapper checks G <= 8,
// hd <= 128, that a page fits, and ch as for K13.
extern "C" int tl_paged_flash_decode(const void* q, int q_dtype, const void* k, const void* v,
                                     const float* ks, const float* vs, const int* page_table,
                                     const int* pos, float* out, int layer, int B, int KVH, int G,
                                     int P, int ps, int MP, int hd, int T, int splits,
                                     float sqrt_hd, int ch, float* ws, int* ticket,
                                     void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || T < 1 || ps % T != 0 || MP < 1 ||
        P < 1 || splits < 1 || splits > 65535 ||
        (splits > 1 && (ws == nullptr || ticket == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *k8 = static_cast<const int8_t*>(k), *v8 = static_cast<const int8_t*>(v);
#define TL_K22_ARGS ch, q, k8, v8, ks, vs, page_table, pos, out, ws, ticket, layer, B, KVH, G, P, ps, MP, hd, T, splits, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_chunk<float>(TL_K22_ARGS);
    if (q_dtype == TL_BF16) return dispatch_chunk<__nv_bfloat16>(TL_K22_ARGS);
#undef TL_K22_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

// res as tl_paged_flash_decode_fresh_residency (paged_flash_decode_fresh.cu).
extern "C" int tl_paged_flash_decode_residency(int G, int hd, int T, int ps, int* res) {
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || T < 1 || ps % T != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return split_page_residency(paged_flash_decode_kernel<__nv_bfloat16, 16>, G, hd, T, ps, res);
}
