// K22: write-then-attend INT8 decode attention over a page pool: each
// slot's query attends its rows t <= pos through the page table.
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
// Rounding: K13's (K9's dec_attend cell): bf16(qs) for the scores, p =
// exp(s - m_block) UNNORMALIZED when rounded as bf16(p * vs), f32 sums,
// over blocks of TS = min(256, ps) rows (halved until it divides ps).  The
// JAX kernel's blocks are whole pages: at ps <= 256 the rounding points are
// the same, at ps = 512 the port rounds p against the running max of each
// 256-row half page, JAX of the whole page, so the two part by about one
// bf16 step of p.
//
// Bound on the H100: bytes, as K13: each (slot, kv head) reads pos[b] + 1
// rows of K and V (hd bytes each) and their two f32 scales.  Design: K13's
// kernel with dec_attend_rows' write-then-attend form (kFresh = false: the
// mask t <= pos through p = pos + 1, no fresh column) over the same
// page-table row functor (common.cuh PagedRows); K9, K12 and K13 compile
// the kFresh form, unchanged.  Nothing in the JAX package calls the TPU
// kernel; the port's serving path does not call this one either.
#include <math.h>

#include "common.cuh"

namespace {

template <typename QT, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_flash_decode_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                          const int8_t* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ page_table,
                          const int* __restrict__ pos, float* __restrict__ out, int layer, int KVH,
                          int G, int P, int ps, int MP, int hd, int TS, float sqrt_hd) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int h = blockIdx.x, b = blockIdx.y;
    const DecSmem<int8_t> sm(smem, TS, dec_pitch<int8_t>(hd), G);
    const int p = min(max(pos[b], -1), MP * ps - 1) + 1;  // rows t <= pos
    const long long bh = (long long)b * KVH + h;
    const PagedRows rows{page_table + (long long)b * MP, (long long)layer * P, P, KVH, h, ps, TS};
    dec_load_q(q + bh * G * hd, sm.qf, sm.qb, G, hd, dec_pitch<int8_t>(hd), sqrt_hd);
    dec_attend_rows<int8_t, CH, PagedRows, false>(sm, kp, vp, ks, vs, p, TS, G, hd, nullptr, 0.f,
                                                   nullptr, 0.f, out + bh * G * hd, rows);
}

template <typename QT, int CH>
int launch(const void* q, const int8_t* k, const int8_t* v, const float* ks, const float* vs,
           const int* pt, const int* pos, float* out, int layer, int B, int KVH, int G, int P,
           int ps, int MP, int hd, int TS, float sqrt_hd, cudaStream_t st) {
    auto kern = paged_flash_decode_kernel<QT, CH>;
    const int bytes = DecSmem<int8_t>::bytes(TS, dec_pitch<int8_t>(hd), G);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(KVH, B), kDecThreads, bytes, st>>>(static_cast<const QT*>(q), k, v, ks, vs, pt,
                                                    pos, out, layer, KVH, G, P, ps, MP, hd, TS,
                                                    sqrt_hd);
    return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_chunk(int ch, const void* q, const int8_t* k, const int8_t* v, const float* ks,
                   const float* vs, const int* pt, const int* pos, float* out, int layer, int B,
                   int KVH, int G, int P, int ps, int MP, int hd, int TS, float sqrt_hd,
                   cudaStream_t st) {
#define TL_K22_ARGS q, k, v, ks, vs, pt, pos, out, layer, B, KVH, G, P, ps, MP, hd, TS, sqrt_hd, st
    if (ch == 16) return launch<QT, 16>(TL_K22_ARGS);
    if (ch == 4) return launch<QT, 4>(TL_K22_ARGS);
#undef TL_K22_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, KVH, G, hd] (f32 or bf16); the pools k/v int8 [L, P, KVH, ps, hd]
// and ks/vs f32 [L, P, KVH, ps]; page_table int32 [B, MP] and pos int32 [B]
// (device); out f32 [B, KVH, G, hd]; all contiguous.  The wrapper checks
// G <= 8, hd <= 128, TS | ps, TS <= 256, and ch as for K13.
extern "C" int tl_paged_flash_decode(const void* q, int q_dtype, const void* k, const void* v,
                                     const float* ks, const float* vs, const int* page_table,
                                     const int* pos, float* out, int layer, int B, int KVH, int G,
                                     int P, int ps, int MP, int hd, int TS, float sqrt_hd, int ch,
                                     void* stream) {
    if (B <= 0 || KVH <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256 ||
        ps % TS != 0 || MP < 1 || P < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *k8 = static_cast<const int8_t*>(k), *v8 = static_cast<const int8_t*>(v);
#define TL_K22_ARGS ch, q, k8, v8, ks, vs, page_table, pos, out, layer, B, KVH, G, P, ps, MP, hd, TS, sqrt_hd, st
    if (q_dtype == TL_F32) return dispatch_chunk<float>(TL_K22_ARGS);
    if (q_dtype == TL_BF16) return dispatch_chunk<__nv_bfloat16>(TL_K22_ARGS);
#undef TL_K22_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
