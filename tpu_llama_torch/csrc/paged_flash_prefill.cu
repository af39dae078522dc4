// K16: causal prefill attention of one chunk against a page pool: each
// query of the chunk attends the slot's past keys in the pool, read through
// the page table, plus the chunk's own fresh keys t' <= t.
//
// Replaces tpu_llama/ops/attention.py:1990 paged_flash_prefill_attention
// (its Pallas kernel _paged_prefill_kernel :1922).  Contract: q
// [B, Tc, NH, hd] raw roped queries, pre-scaled by 1/sqrt(hd) (a division);
// GQA folds query rows as t * G + g; layer `layer` of the pools k/v int8
// [L, P, KVH, ps, hd] with f32 scales [L, P, KVH, ps]; slot b's past key s
// (s < start[b]) lives in page page_table[b, s / ps], row s % ps, and only
// the first W = past_pages pages are walked (JAX's static bound: keys at
// and past W * ps are not attended); the fresh rows fk/fv int8
// [B, KVH, Tc, hd] with scales fks/fvs f32 [B, KVH, Tc] sit at positions
// start[b] + t'; query t attends past keys s < start[b] and fresh keys
// t' <= t; K scales multiply the scores, V scales the probabilities; out
// [B, Tc, NH * hd] = acc / max(l, 1e-30), rounded to bf16 (the JAX
// kernel's output type) and cast to the output type.  A page id outside
// [0, P) reads page 0 (the trash page), never outside the pool; a negative
// start is read as 0 (no past keys, as JAX's mask s < start gives).
//
// Rounding: the TPU kernel's own, through prefill_mma.cuh's bf16
// tensor-core cell (its header states the contract): q rounded to bf16
// after the pre-scale (attention.py:2030-2034), p * vs rounded to bf16
// before the PV dot, f32 accumulation and softmax.  K16 equals K6's INT8
// form bit for bit (with bf16 outputs) on a dense cache that holds the
// same past rows at [0, start) and the fresh rows at [start, start + Tc):
// the keys are indexed s = 0 .. start + Tc - 1, past then fresh, "s attends
// iff s <= start + t" is exactly K16's mask, and both kernels run the one
// cell over the same 64-key tiles.
//
// Bound on the H100: operations at a 7B admission wave (B 16, KVH 32, Tc
// 256, hd 128, start 768: ~6.0e10 bf16-rate operations against ~0.2 GB).
// Design: the cell with a paged key source.  64 threads of a block resolve
// a tile's keys to their rows -- a pool page's (one page-table lookup,
// 64-bit offsets: one 7B pool array of 97 pages is 6.5 GB), a fresh row, or
// none -- into a table in shared memory, and the block's cp.async copies
// read whole rows from it, so a tile that spans pages (a page size below
// 64) or the past and the fresh rows loads as a one-run tile does.  (The
// f32 SIMT cell that this replaces took 4.05 and 3.98 ms at the two phase-3
// shapes on an H100, 15-16x SDPA on the dequantized cache.)
#include "prefill_mma.cuh"

namespace {

using prefill_mma::kBC;
using prefill_mma::KeyRow;

// K16's keys for one (slot, kv head): past keys s < past_end in the pool
// pages pt[s / ps] (a page id outside [0, P) reads the trash page 0), then
// the fresh keys s in [st, st + Tc) in the chunk's rows.
struct PagedKeys {
    const int8_t* kp;
    const int8_t* vp;
    const float* ks;
    const float* vs;
    const int8_t* fk;
    const int8_t* fv;
    const float* fks;
    const float* fvs;
    const int* pt;
    long long layer_page0, fresh0;  // the layer's first page; fresh row of t' = 0
    int P, ps, KVH, h, st, past_end, Tc, hd;

    __device__ __forceinline__ int kend(int e) const { return e; }
    __device__ __forceinline__ bool ok(int c) const { return c < past_end || c >= st; }
    __device__ __forceinline__ bool all_ok(int c0) const {
        return c0 + kBC <= past_end || c0 >= st;
    }
    __device__ __forceinline__ KeyRow locate(int c) const {
        if (c < past_end) {
            int pg = __ldg(pt + c / ps);
            if (pg < 0 || pg >= P) pg = 0;  // the trash page
            const long long r = ((layer_page0 + pg) * KVH + h) * ps + c % ps;
            return {kp + r * hd, vp + r * hd, ks + r, vs + r, true};
        }
        const bool fresh = c >= st && c < st + Tc;
        const long long r = fresh0 + (fresh ? c - st : 0);
        return {fk + r * hd, fv + r * hd, fks + r, fvs + r, fresh};
    }
};

template <int HDP, typename QT, typename OT>
__global__ void __launch_bounds__(32 * prefill_mma::kNW)
paged_flash_prefill_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                           const int8_t* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ page_table,
                           const int* __restrict__ start, const int8_t* __restrict__ fk,
                           const int8_t* __restrict__ fv, const float* __restrict__ fks,
                           const float* __restrict__ fvs, OT* __restrict__ out, int layer,
                           int Tc, int NH, int KVH, int P, int ps, int MP, int W, int hd,
                           float sqrt_hd, int vec) {
    const int h = blockIdx.x, b = blockIdx.y;
    const int st = max(start[b], 0);
    const PagedKeys keys{kp, vp, ks, vs, fk, fv, fks, fvs, page_table + (long long)b * MP,
                         (long long)layer * P, ((long long)b * KVH + h) * Tc, P, ps, KVH, h, st,
                         (int)min((long long)st, (long long)W * ps), Tc, hd};
    prefill_mma::attend<HDP, prefill_mma::kNW, true>(q, out, keys, st, Tc, NH, KVH, hd, sqrt_hd,
                                                     vec != 0);
}

#define TL_K16_PARAMS                                                                          \
    const void *q, const int8_t *kp, const int8_t *vp, const float *ks, const float *vs,      \
        const int *pt, const int *start, const int8_t *fk, const int8_t *fv, const float *fks, \
        const float *fvs, void *out, int layer, int B, int Tc, int NH, int KVH, int P, int ps, \
        int MP, int W, int hd, float sqrt_hd, cudaStream_t st
#define TL_K16_ARGS \
    q, kp, vp, ks, vs, pt, start, fk, fv, fks, fvs, out, layer, B, Tc, NH, KVH, P, ps, MP, W, hd, sqrt_hd, st

template <int HDP, typename QT, typename OT>
int launch(TL_K16_PARAMS) {
    auto kern = paged_flash_prefill_kernel<HDP, QT, OT>;
    constexpr int bytes = prefill_mma::kSmemBytes<HDP>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies where every row starts on 16 bytes
    const int vec = hd % 16 == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vp) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(fk) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(fv) % 16 == 0;
    const int rows = Tc * (NH / KVH);
    constexpr int kBR = 16 * prefill_mma::kNW;
    dim3 grid(KVH, B, (rows + kBR - 1) / kBR);
    kern<<<grid, 32 * prefill_mma::kNW, bytes, st>>>(static_cast<const QT*>(q), kp, vp, ks, vs,
                                                     pt, start, fk, fv, fks, fvs,
                                                     static_cast<OT*>(out), layer, Tc, NH, KVH,
                                                     P, ps, MP, W, hd, sqrt_hd, vec);
    return static_cast<int>(cudaGetLastError());
}

template <int HDP, typename QT>
int dispatch_out(int out_dtype, TL_K16_PARAMS) {
    if (out_dtype == TL_F32) return launch<HDP, QT, float>(TL_K16_ARGS);
    if (out_dtype == TL_BF16) return launch<HDP, QT, __nv_bfloat16>(TL_K16_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int dispatch_q(int q_dtype, int out_dtype, TL_K16_PARAMS) {
    if (q_dtype == TL_F32) return dispatch_out<HDP, float>(out_dtype, TL_K16_ARGS);
    if (q_dtype == TL_BF16) return dispatch_out<HDP, __nv_bfloat16>(out_dtype, TL_K16_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Tc, NH, hd] (f32 or bf16); the pools k/v int8 [L, P, KVH, ps, hd]
// and ks/vs f32 [L, P, KVH, ps]; page_table int32 [B, MP] (the chunk's
// slots' rows) and start int32 [B] (device); fk/fv int8 [B, KVH, Tc, hd],
// fks/fvs f32 [B, KVH, Tc]; out [B, Tc, NH * hd] (f32 or bf16); all
// contiguous; hd <= 128; 0 <= W <= MP (the wrapper checks).
extern "C" int tl_paged_flash_prefill(const void* q, int q_dtype, const void* k, const void* v,
                                      const float* ks, const float* vs, const int* page_table,
                                      const int* start, const void* fk, const void* fv,
                                      const float* fks, const float* fvs, void* out,
                                      int out_dtype, int layer, int B, int Tc, int NH, int KVH,
                                      int P, int ps, int MP, int W, int hd, float sqrt_hd,
                                      void* stream) {
    if (B <= 0 || Tc <= 0) return 0;
    if (KVH < 1 || NH % KVH || P < 1 || ps < 1 || MP < 1 || W < 0 || W > MP)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t *kp = static_cast<const int8_t*>(k), *vp = static_cast<const int8_t*>(v);
    const int8_t *f8k = static_cast<const int8_t*>(fk), *f8v = static_cast<const int8_t*>(fv);
#define TL_K16_CALL q, kp, vp, ks, vs, page_table, start, f8k, f8v, fks, fvs, out, layer, B, Tc, NH, KVH, P, ps, MP, W, hd, sqrt_hd, st
    if (hd <= 64) return dispatch_q<64>(q_dtype, out_dtype, TL_K16_CALL);
    if (hd <= 128) return dispatch_q<128>(q_dtype, out_dtype, TL_K16_CALL);
#undef TL_K16_CALL
    return static_cast<int>(cudaErrorInvalidValue);
}
