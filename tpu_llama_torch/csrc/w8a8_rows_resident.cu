// K29: K1's W8A8 product with the activation rows held resident in shared
// memory while the weights stream past them.
//
// Replaces tpu_llama/ops/matmul.py:314 _w8a8_rows_resident_call (its
// Pallas kernels _w8a8_rows_res_kernel :279 and _w8a8_rows_res_res_kernel
// :296), which w8a8_matmul_prequant takes above 256 rows when
// TPU_LLAMA_ROWS_RESIDENT=1 (matmul.py:513-519).  K1's function:
//   out[m, n] = cast((f32(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
// and with a residual r [M, N] of the output type, out = r + cast(mm), the
// product rounded to the output type first (an explicit round-to-nearest
// add).  The int32 sums are exact and the epilogue is K1's, so K29 equals
// K1 bit for bit.
//
// Bound on the H100: int8 tensor-core operations at the prefill shapes
// (M = 4096; wo 4096 x 4096: 0.069 ms at 1979 TOP/s).  What bounds this
// design before that, measured on the card: how fast a consumer warpgroup
// issues wgmma this narrow (N = 32 or 16).  A block's time per stage did
// not move with 8 or 128 blocks on the card, with one accumulator or one
// per k-step, or with the weights fetched by one block or shared by
// multicast; it fell with four consumer warpgroups against two.  Design,
// the TPU kernel's idea (x rows loaded once per block, weights streamed
// past them) on this card:
// * Swapped operands: the block computes out^T = W x^T, with A = a 64-row
//   weight tile (K-major, 128-byte swizzle) streamed through a TMA ring and
//   B = the block's resident x slice of BM rows (wgmma N = BM), loaded once
//   by TMA as K / 128 swizzled [BM, 128-byte] boxes, the layout the B
//   descriptor reads.  A consumer's accumulator is 64 x BM / 128 = 16 or 8
//   int32 registers.
// * One producer thread keeps a ring of `stages` stages full, each 64
//   weight rows x 128 k-bytes for every consumer warpgroup (a weight tile
//   is 64 x consumers rows); four wgmma.m64n{BM}k32 a stage and consumer,
//   one stage's group in flight, the stage before it freed.  BM, the
//   consumers and the ring follow from the 227 KB a block may use
//   (plan_for; ops/matmul.py rows_resident_plan mirrors it): 32 rows and 4
//   consumers up to K 5120, 32 and 2 up to 6144, 16 and 4 up to 10240, 16
//   and 2 up to 12288 (Llama-2 7B: 32 x 4 at K 4096, 16 x 2 at its w2's
//   11008, where 256 blocks of 16 rows each stream all of W: two waves).
// * A thread-block cluster of C blocks along M (C from the caller,
//   ops/matmul.py rows_resident_cluster): the blocks hold different x
//   slices and walk the same weight tiles, so each fetches 1/C of every
//   stage and multicasts it to all C (cp.async.bulk.tensor
//   .multicast::cluster): each weight byte leaves L2 M / (BM C) times
//   instead of M / BM.  A stage is refilled only after the consumers of
//   every block of the cluster have freed it (each consumer warp arrives on
//   the "empty" barrier of every block, through mapa); a cluster barrier at
//   the end keeps a block alive while another may still arrive on its
//   barriers.  Since L2 is not what bounds the block, the cluster's lockstep
//   costs time at the 7B shapes against C = 1 (PERF.md §6).  Only 30
//   clusters of 4 (15 of 8) fit on the card at once, so M = 4096's 128
//   blocks take two waves there.
// * The epilogue stages a tile's int32 sums, transposed, in the consumer's
//   64-row part of the stage it just read (an xor swizzle keeps both the
//   writes and the reads free of bank conflicts), then each warp stores
//   whole rows of 64 columns with K1's rounding, and frees the stage.
// * Grid: ceil(M / BM) m-blocks rounded up to a multiple of C (blocks past
//   M join the cluster's loads and store nothing); where fewer m-blocks
//   than SMs run, the weight tiles are split over floor(SMs / m-blocks)
//   blocks along y.
#include "hopper.cuh"

namespace {

constexpr int kMaxConsumers = 4;                     // consumer warpgroups: 4 or 2
constexpr int kMaxThreads = (1 + kMaxConsumers) * 128;  // and the producer warpgroup
constexpr int kBK = 128;                   // k bytes of a stage and of an x box
constexpr int kSteps = kBK / 32;           // wgmma k32 steps a stage
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;
constexpr int kMaxSmem = 232448;
constexpr int kFixed = 1024 + (2 * kMaxStages + 1) * 8;  // alignment slack, barriers

int k_boxes(int K) { return (K + kBK - 1) / kBK; }

// A stage: 64 weight rows x kBK bytes for each consumer.
int stage_bytes(int consumers) { return 64 * consumers * kBK; }

// The ring's stages beside a slice of bm rows for `consumers` consumer
// warpgroups, 0 where fewer than kMinStages fit.
int ring_stages(int bm, int consumers, int K) {
    const int left = kMaxSmem - kFixed - bm * k_boxes(K) * kBK;
    const int s = left < 0 ? 0 : left / stage_bytes(consumers);
    return s < kMinStages ? 0 : (s > kMaxStages ? kMaxStages : s);
}

struct Plan {
    int bm = 0, consumers = 0, stages = 0;
};

// The block's x rows BM, consumer warpgroups and ring for a product of
// inner size K, in this order of preference: 32 rows and 4 consumers, 32
// and 2, 16 and 4, 16 and 2 -- the first beside which two stages fit (bm
// 0: the kernel does not take K).  More consumers issue more of the narrow
// wgmma at once, which is what bounds the block; more rows make each wgmma
// wider and halve the blocks that stream W.  ops/matmul.py
// rows_resident_plan mirrors it.
Plan plan_for(int K) {
    Plan p;
    if (K < 16 || K % 16) return p;
    const int order[4][2] = {{32, 4}, {32, 2}, {16, 4}, {16, 2}};
    for (const auto& o : order) {
        const int s = ring_stages(o[0], o[1], K);
        if (s) {
            p.bm = o[0];
            p.consumers = o[1];
            p.stages = s;
            return p;
        }
    }
    return p;
}

// d (64 x 32 s32) += a (64 x 32 s8) * b (32 x 32 s8), both K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n32k32(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
}
// d (64 x 16 s32) += a (64 x 32 s8) * b (32 x 16 s8), both K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n16k32(int (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
}
template <int BM>
__device__ __forceinline__ void wgmma_rows(int (&d)[BM / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rows<32>(int (&d)[16], uint64_t da, uint64_t db) {
    wgmma_m64n32k32(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_rows<16>(int (&d)[8], uint64_t da, uint64_t db) {
    wgmma_m64n16k32(d, da, db);
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// free stage s: one arrival per consumer warp on its "empty" barrier in
// every block of the cluster
__device__ __forceinline__ void release(uint64_t* empty, int s, int csize, int lane) {
    __syncwarp();
    if (lane == 0) {
        if (csize == 1) {
            mbar_arrive(&empty[s]);
        } else {
            for (int r = 0; r < csize; ++r) mbar_arrive_cluster(&empty[s], r);
        }
    }
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 1)
rows_resident_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                     const float* __restrict__ sw, const OutT* __restrict__ res,
                     OutT* __restrict__ out, int M, int N, int K, int consumers, int stages,
                     int csize) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    const int nkb = (K + kBK - 1) / kBK;
    const int rows = 64 * consumers, stage = rows * kBK;  // a stage's weight rows, bytes
    unsigned char* xs = base;                     // [nkb][BM][kBK], 128-byte swizzle, resident
    unsigned char* ring = base + BM * nkb * kBK;  // [stages][rows][kBK]
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage);
    uint64_t* empty = full + kMaxStages;
    uint64_t* xbar = empty + kMaxStages;

    const int m0 = blockIdx.x * BM;
    const int ntiles = (N + rows - 1) / rows;
    const int tid = threadIdx.x, wg_id = tid / 128;
    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 4 * consumers * csize);  // every consumer warp of the cluster
        }
        mbar_init(xbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (csize > 1) {
        cluster_sync();  // every block's barriers exist before any multicast or remote arrive
    } else {
        __syncthreads();
    }

    if (wg_id == 0) {
        if (tid == 0) {  // the producer: the x slice once, then the weight ring
            const unsigned rank = csize > 1 ? cluster_rank() : 0;
            const int share = rows / csize;  // rows of each stage this block fetches
            const uint16_t mask = static_cast<uint16_t>((1u << csize) - 1);
            mbar_expect_tx(xbar, BM * nkb * kBK);
            for (int kb = 0; kb < nkb; ++kb) tma_load(xs + kb * BM * kBK, &xmap, kb * kBK, m0, xbar);
            int it = 0;
            for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
                for (int kb = 0; kb < nkb; ++kb, ++it) {
                    const int s = it % stages;
                    if (it >= stages) mbar_wait(&empty[s], ((it / stages) - 1) & 1);
                    mbar_expect_tx(&full[s], stage);
                    unsigned char* dst = ring + s * stage;
                    if (csize == 1) {
                        tma_load(dst, &wmap, kb * kBK, t * rows, &full[s]);
                    } else {
                        tma_load_multicast(dst + rank * share * kBK, &wmap, kb * kBK,
                                           t * rows + rank * share, &full[s], mask);
                    }
                }
            }
        }
    } else if (wg_id <= consumers) {
        // a consumer: weight rows n0 .. n0 + 63 of each tile of `rows`
        const int c = wg_id - 1, lane = tid & 31, w = (tid >> 5) & 3;
        const int g = lane >> 2, t4 = lane & 3;
        mbar_wait(xbar, 0);
        int acc[BM / 2];
        int it = 0, held = -1;  // held: a stage read but not yet freed
        for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
            const int n0 = t * rows + c * 64;
            const bool active = m0 < M && n0 < N;
#pragma unroll
            for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
            for (int kb = 0; kb < nkb; ++kb, ++it) {
                const int s = it % stages;
                mbar_wait(&full[s], (it / stages) & 1);
                if (active) {
                    fence_acc(acc);
                    wgmma_fence();
                    const uint64_t da = desc_sw128(ring + s * stage + c * 64 * kBK);
                    const uint64_t db = desc_sw128(xs + kb * BM * kBK);
#pragma unroll
                    for (int k = 0; k < kSteps; ++k) wgmma_rows<BM>(acc, da + 2 * k, db + 2 * k);
                    wgmma_commit();
                    wgmma_wait<1>();  // the previous stage's group has read its tile
                    fence_acc(acc);
                }
                if (held >= 0) release(empty, held, csize, lane);
                held = s;
            }
            if (active) {
                wgmma_wait<0>();
                fence_acc(acc);
            }
            named_sync(1 + c, 128);  // the warpgroup's wgmma are done with the held stage
            if (active) {
                // the sums, transposed: stg[m][n ^ swz(m)] of the tile's BM x
                // rows and 64 weight rows, in this consumer's half of the held
                // stage; acc[4 j + e] = D(n = 16 w + g + 8 (e / 2), m = 8 j + 2 t4 + e % 2)
                int* stg = reinterpret_cast<int*>(ring + held * stage + c * 64 * kBK);
#pragma unroll
                for (int j = 0; j < BM / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int m = 8 * j + 2 * t4 + (e & 1), n = 16 * w + g + 8 * (e >> 1);
                        stg[m * 64 + (n ^ (((m >> 1) & 3) << 3))] = acc[4 * j + e];
                    }
                named_sync(1 + c, 128);
                // warp w stores rows w, w + 4, ...: lane l columns n0 + 2 l, + 1
                const int col = n0 + 2 * lane;
                const bool in0 = col < N, both = col + 1 < N;
                const bool pairs = (N & 1) == 0;
                const float s0 = in0 ? sw[col] : 0.f, s1 = both ? sw[col + 1] : 0.f;
                for (int m = w; m < BM && m0 + m < M; m += 4) {
                    if (!in0) break;
                    const int row = m0 + m;
                    const int2 q = *reinterpret_cast<const int2*>(
                        stg + m * 64 + ((2 * lane) ^ (((m >> 1) & 3) << 3)));
                    const float a = sx[row];
                    const long long o = (long long)row * N + col;
                    float v0 = (static_cast<float>(q.x) * a) * s0;
                    float v1 = (static_cast<float>(q.y) * a) * s1;
                    if (pairs && both) {
                        if (res) {
                            float r0, r1;
                            load_pair(res + o, r0, r1);
                            v0 = __fadd_rn(r0, round_to<OutT>(v0));
                            v1 = __fadd_rn(r1, round_to<OutT>(v1));
                        }
                        store_pair(out + o, v0, v1);
                    } else {
                        store_as(out + o, res ? __fadd_rn(to_f32(res[o]), round_to<OutT>(v0)) : v0);
                        if (both)
                            store_as(out + o + 1,
                                     res ? __fadd_rn(to_f32(res[o + 1]), round_to<OutT>(v1)) : v1);
                    }
                }
                fence_proxy_async();  // the staging's accesses before the stage's next TMA write
            }
            release(empty, held, csize, lane);
            held = -1;
        }
    }
    if (csize > 1) {
        __syncwarp();
        cluster_sync();  // no block leaves while another may still arrive on its barriers
    }
}

template <int BM, typename OutT>
int launch(const Plan& p, const int8_t* x, const float* sx, const int8_t* w, const float* sw,
           const void* res, void* out, int M, int N, int K, int csize, cudaStream_t st) {
    const int rows = 64 * p.consumers;
    CUtensorMap xm, wm;
    if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, M, K, BM, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, rows / csize, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kern = rows_resident_kernel<BM, OutT>;
    const int smem = kFixed + BM * k_boxes(K) * kBK + p.stages * stage_bytes(p.consumers);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nm = ((M + BM - 1) / BM + csize - 1) / csize * csize;
    const int tiles = (N + rows - 1) / rows;
    int split = sms / nm;  // fewer m-blocks than SMs: split the weight tiles
    split = split < 1 ? 1 : (split > tiles ? tiles : split);
    const OutT* r = static_cast<const OutT*>(res);
    OutT* o = static_cast<OutT*>(out);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nm, split);
    cfg.blockDim = dim3((1 + p.consumers) * 128);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = csize > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kern, xm, wm, sx, sw, r, o, M, N, K, p.consumers, p.stages,
                             csize);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The clusters of csize blocks that can be resident at once for an inner
// size K (cudaOccupancyMaxActiveClusters at the launch's shape).
int max_clusters(int K, int csize, int* n) {
    const Plan p = plan_for(K);
    if (p.bm == 0) return static_cast<int>(cudaErrorInvalidValue);
    auto kern = p.bm == 32 ? rows_resident_kernel<32, __nv_bfloat16>
                           : rows_resident_kernel<16, __nv_bfloat16>;
    const int smem = kFixed + p.bm * k_boxes(K) * kBK + p.stages * stage_bytes(p.consumers);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(csize * 64, 1);
    cfg.blockDim = dim3((1 + p.consumers) * 128);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kern, &cfg));
}

template <typename OutT>
int dispatch(const Plan& p, const int8_t* x, const float* sx, const int8_t* w, const float* sw,
             const void* res, void* out, int M, int N, int K, int csize, cudaStream_t st) {
    if (p.bm == 32) return launch<32, OutT>(p, x, sx, w, sw, res, out, M, N, K, csize, st);
    return launch<16, OutT>(p, x, sx, w, sw, res, out, M, N, K, csize, st);
}

}  // namespace

// As tl_w8a8_matmul (w8a8_matmul.cu), with bm the rows plan_for(K) picks
// and csize the cluster's blocks along M (1, 2, 4 or 8): xq int8 [M, K] and
// wq int8 [N, K] contiguous and 16-byte aligned, K a multiple of 16; res
// null or [M, N] of the output type.
extern "C" int tl_w8a8_rows_resident(const int8_t* x, const float* sx, const int8_t* w,
                                     const float* sw, const void* res, void* out, int out_dtype,
                                     int M, int N, int K, int bm, int csize, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    const Plan p = plan_for(K);
    if (p.bm == 0 || bm != p.bm || (csize != 1 && csize != 2 && csize != 4 && csize != 8))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_dtype == TL_F32) return dispatch<float>(p, x, sx, w, sw, res, out, M, N, K, csize, st);
    if (out_dtype == TL_BF16)
        return dispatch<__nv_bfloat16>(p, x, sx, w, sw, res, out, M, N, K, csize, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The clusters of csize blocks K29 can keep resident at once for inner size K.
extern "C" int tl_w8a8_rows_resident_clusters(int K, int csize, int* n) {
    return max_clusters(K, csize, n);
}
