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
// [B, Tc, NH * hd] = acc / max(l, 1e-30), cast once to the output type.  A
// page id outside [0, P) reads page 0 (the trash page), never outside the
// pool; a negative start is read as 0 (no past keys, as JAX's mask s <
// start gives).
//
// Rounding: K6's, f32 throughout, through the same cell (prefill_cell.cuh):
// the TPU kernel rounds the scaled q to bf16 at its boundary
// (attention.py:2030-2034) and p * vs to bf16 before its MXU dots, and
// emits bf16; here neither is rounded and the output is cast once.  So K16
// agrees with its f32 plain version to summation-order noise, and equals K6
// bit for bit on a dense cache that holds the same past rows at [0, start)
// and the fresh rows at [start, start + Tc): the keys are indexed s = 0 ..
// start + Tc - 1, past then fresh, "s attends iff s <= start + t" is exactly
// K16's mask, and both kernels run the one cell over the same 64-key tiles.
//
// Bound on the H100: operations at a 7B admission wave (B 16, KVH 32, Tc
// 256, hd 128, start 768: ~6.0e10 bf16-rate operations against ~0.2 GB).
// Design: the cell with a paged key source.  A 64-key tile that is one run
// of rows -- all past keys in one page (one page-table lookup, 64-bit
// offsets: one 7B pool array of 97 pages is 6.5 GB) or all fresh keys, as
// every tile of the served path is -- is read from that run's base as K6
// reads its cache; any other tile (a start or page size that is not a
// multiple of 64) first has 64 threads resolve each key's row -- pool,
// fresh, or none -- into shared memory, and its loads read those rows.
// (A first shared cell that resolved every key that way made K6 1.8-2.3x
// slower on an H100; with run tiles K6 keeps its time within 1%.)
#include "prefill_cell.cuh"

namespace {

using prefill::kBC;
using prefill::kThreads;
constexpr int kNone = 0, kPool = 1, kFresh = 2;  // where a tile's key lives

// K16's keys for one (slot, kv head): past keys s < past_end in the pool
// pages pt[s / ps] (a page id outside [0, P) reads the trash page 0), then
// the fresh keys s in [st, st + Tc) in the chunk's rows.  krow / ksrc are
// shared memory [kBC] each, for tiles resolved key by key.
template <int HDP>
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
    long long* krow;
    int* ksrc;
    int run_src;    // this tile's run: kPool, kFresh, or kNone (key by key)
    long long run;  // ... its first row

    __device__ __forceinline__ int kend(int e) const { return e; }
    __device__ __forceinline__ bool ok(int c) const { return c < past_end || c >= st; }
    __device__ __forceinline__ long long pool_row(int s) const {
        int pg = __ldg(pt + s / ps);
        if (pg < 0 || pg >= P) pg = 0;  // the trash page
        return ((layer_page0 + pg) * KVH + h) * ps + s % ps;
    }
    __device__ __forceinline__ void load_k(int c0, float* KV, float* ksc, float* vsc) {
        // one run holds the whole tile when its keys are all past keys of
        // one page or all fresh keys (block-uniform)
        run_src = kNone;
        if (c0 + kBC <= past_end && c0 / ps == (c0 + kBC - 1) / ps) {
            run_src = kPool;
            run = pool_row(c0);
        } else if (c0 >= st && c0 + kBC <= st + Tc) {
            run_src = kFresh;
            run = fresh0 + (c0 - st);
        }
        const int tid = threadIdx.x;
        if (run_src != kNone) {
            prefill::load_run<HDP>(run_src == kPool ? kp : fk, run, kBC, hd, KV);
            if (tid < kBC) {
                ksc[tid] = __ldg((run_src == kPool ? ks : fks) + run + tid);
                vsc[tid] = __ldg((run_src == kPool ? vs : fvs) + run + tid);
            }
            return;
        }
        if (tid < kBC) {  // resolve key c0 + tid: a pool row, a fresh row, or none
            const int s = c0 + tid;
            int src = kNone;
            long long r = 0;
            if (s < past_end) {
                src = kPool;
                r = pool_row(s);
            } else if (s >= st && s < st + Tc) {
                src = kFresh;
                r = fresh0 + (s - st);
            }
            krow[tid] = r;
            ksrc[tid] = src;
            ksc[tid] = src == kPool ? ks[r] : src == kFresh ? fks[r] : 0.f;
            vsc[tid] = src == kPool ? vs[r] : src == kFresh ? fvs[r] : 0.f;
        }
        __syncthreads();
        load_rows(kp, fk, KV);
    }
    __device__ __forceinline__ void load_v(int c0, float* KV) const {
        if (run_src != kNone)
            prefill::load_run<HDP>(run_src == kPool ? vp : fv, run, kBC, hd, KV);
        else
            load_rows(vp, fv, KV);
    }
    // a resolved tile's rows from the pool or the fresh block
    __device__ __forceinline__ void load_rows(const int8_t* pool, const int8_t* fresh,
                                              float* KV) const {
        for (int e = threadIdx.x; e < kBC * HDP; e += kThreads) {
            const int c = e / HDP, d = e % HDP;
            const int src = ksrc[c];
            const long long o = krow[c] * hd + d;
            float x = 0.f;
            if (d < hd && src != kNone) x = to_f32(src == kPool ? __ldg(pool + o) : __ldg(fresh + o));
            KV[c * (HDP + 1) + d] = x;
        }
    }
};

template <int HDP, typename QT, typename OT>
__global__ void __launch_bounds__(kThreads)
paged_flash_prefill_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kp,
                           const int8_t* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ page_table,
                           const int* __restrict__ start, const int8_t* __restrict__ fk,
                           const int8_t* __restrict__ fv, const float* __restrict__ fks,
                           const float* __restrict__ fvs, OT* __restrict__ out, int layer,
                           int Tc, int NH, int KVH, int P, int ps, int MP, int W, int hd,
                           float sqrt_hd) {
    extern __shared__ float smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const int st = max(start[b], 0);
    long long* krow = reinterpret_cast<long long*>(smem + prefill::kCellFloats<HDP>);
    PagedKeys<HDP> keys{kp, vp, ks, vs, fk, fv, fks, fvs, page_table + (long long)b * MP,
                        (long long)layer * P, ((long long)b * KVH + h) * Tc, P, ps, KVH, h, st,
                        (int)min((long long)st, (long long)W * ps), Tc, hd, krow,
                        reinterpret_cast<int*>(krow + kBC), kNone, 0};
    prefill::attend<HDP>(q, out, keys, st, Tc, NH, KVH, hd, sqrt_hd);
}

// the cell's shared memory, then krow (8 bytes) and ksrc (4 bytes) per key
template <int HDP>
constexpr int kSmemFloats = prefill::kCellFloats<HDP> + 3 * kBC;

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
    const int bytes = kSmemFloats<HDP> * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = Tc * (NH / KVH);
    dim3 grid((rows + prefill::kBR - 1) / prefill::kBR, KVH, B);
    kern<<<grid, kThreads, bytes, st>>>(static_cast<const QT*>(q), kp, vp, ks, vs, pt, start, fk,
                                        fv, fks, fvs, static_cast<OT*>(out), layer, Tc, NH, KVH,
                                        P, ps, MP, W, hd, sqrt_hd);
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
