// K1: W8A8 matrix product with int32 accumulation and a per-row x
// per-column rescale.
//
// Replaces tpu_llama/ops/matmul.py:483 w8a8_matmul_prequant (its Pallas
// kernels _w8a8_kernel, matmul.py:364, and _w8a8_res_kernel, :388).
//   out[m, n] = cast((f32(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
// xq int8 [M, K] row-major, wq int8 [N, K] (K-major: the transpose of the
// JAX package's [IN, OUT]), sx f32 [M], sw f32 [N], out f32 or bf16 [M, N].
// The epilogue multiplies in the order of matmul.py:383-385 and rounds once
// to the output type; the int32 sums are exact in any order, so the result
// is bit-equal to the plain version.  With a residual r [M, N] (of the
// output type) the epilogue is the residual one (matmul.py:388-409): out =
// r + cast(mm), the matmul term rounded to the output type first, then
// added in that type -- the unfused x + mm -- with an explicit
// round-to-nearest add, so nvcc cannot contract it into an FMA with the
// rescale.
//
// The int32 form (out type int32, code TL_I32) stores the exact sums
// themselves, with no epilogue: sx, sw and res go unread.  A rank of the
// sharded engine runs it on its K-slice of a row-sharded product (wo, w2);
// the slices' sums are all-reduced as int32, exactly, and the epilogue runs
// once after (ops/matmul.py w8a8_epilogue), so the result equals K1 on the
// whole K bit for bit.
//
// Two kernels, by M:
// * M <= 16 (decode; K8 too at B <= 16), w8a8_kernel on a 16 x 32 tile.
//   Bound on the H100: bytes -- every weight byte is read once per step
//   and reused by at most 16 rows.  Design: mma.sync m16n8k32 (s8 x s8 ->
//   s32) on K-contiguous operands, every fragment one 32-bit shared-memory
//   load; a four-stage cp.async ring of 256-byte k-tiles over many small
//   blocks keeps the loads deep.  Any K (byte loads where K % 16 != 0).
// * M > 16 (prefill, the continuation, 4f's 32-row decode and classifier),
//   w8a8_wgmma_kernel.  Bound on the H100: int8 tensor-core operations at
//   M 4096 (w13: 739 GOP, 0.373 ms at 1979 TOP/s); bytes at M 17-64.
//   Design: a wgmma + TMA GEMM on operands that are both K-major already,
//   the only major-ness int8 wgmma takes, so A (x) and B (W) both come from
//   shared memory and nothing is converted or permuted.  A block of five
//   warpgroups owns a 128 (m) x 256 (n) output tile.  One producer thread
//   (its warpgroup's registers given to the others, setmaxnreg) starts TMA
//   loads of the x tile (128 x 128 bytes) and the W tile (256 x 128) under
//   the 128-byte swizzle into a ring of four 48 KB stages, each completing
//   on a "full" mbarrier; rows past M, columns past N and k past K load as
//   zeros.  Four consumer warpgroups, 2 x 2 over the tile, own 64 x 128
//   each and issue four wgmma.m64n128k32.s32.s8.s8 a stage (the
//   descriptors' start address advanced 32 bytes a k-step inside the
//   swizzle atom), keep one stage's group in flight (wait_group 1) and then
//   free the stage before it on an "empty" mbarrier, so no block-wide
//   barrier stands in the k-loop; a consumer whose part lies past M or N
//   issues no wgmma.  Four consumers of 64 x 128 ran faster at every 7B
//   shape than two of 64 x 256 over the same tiles and bytes (PERF.md §6):
//   a warpgroup's wgmma issue, not the tensor cores, bounded the two.  The
//   accumulator is 64 int32 registers a thread.  Blocks run in groups of
//   kGroupN column blocks, the m-blocks of a group after one another, so
//   the W tiles of a group are reused from L2 by the m-blocks running
//   beside each other (ops/matmul.py w8a8_raster mirrors the order).  The
//   epilogue stores each thread's column pairs (8 bytes of f32, 4 of bf16)
//   and masks rows past M and columns past N.  TMA needs 16-byte global
//   strides and bases: the wrapper zero-pads K to a multiple of 16 where
//   it is not one (ops/matmul.py w8a8_plan), which changes no int32 sum.
#include <type_traits>

#include "hopper.cuh"

namespace {

// the int32 form: the sums stored as they are
template <typename T>
constexpr bool kAcc = std::is_same<T, int32_t>::value;

// ---------------------------------------------------------------------------
// The decode kernel (M <= 16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BM x BN block tile, BK bytes of K per stage, warps of WM x WN.
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tile {
    static constexpr int kWarpsN = BN / WN;
    static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
    static constexpr int kLds = BK + 16;  // padded row stride: conflict-free fragments
    static constexpr int kSmem = STAGES * (BM + BN) * kLds;
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename OutT>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN, STAGES>::kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
            const int8_t* __restrict__ w, const float* __restrict__ sw,
            const OutT* __restrict__ res, OutT* __restrict__ out, int M, int N, int K,
            int vec) {
    using C = Tile<BM, BN, BK, WM, WN, STAGES>;
    constexpr int NT = C::kThreads, LDS = C::kLds;
    constexpr int MT = WM / 16, NTL = WN / 8;  // mma tiles per warp
    extern __shared__ __align__(16) int8_t smem[];
    int8_t* As = smem;                      // [STAGES][BM][LDS]
    int8_t* Bs = smem + STAGES * BM * LDS;  // [STAGES][BN][LDS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
    const int g = lane >> 2, t4 = lane & 3;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nk = (K + BK - 1) / BK;

    // One k-tile of x rows [m0, m0+BM) and w rows [n0, n0+BN) into a stage;
    // out-of-range rows and k are zero-filled.
    auto load_tile = [&](int stage, int kt) {
        const int k0 = kt * BK;
        int8_t* as = As + stage * BM * LDS;
        int8_t* bs = Bs + stage * BN * LDS;
        if (vec) {  // K % 16 == 0: a 16-byte chunk is wholly in or out of range
            constexpr int CH = BK / 16;
            for (int c = tid; c < BM * CH; c += NT) {
                const int r = c / CH, kc = (c % CH) * 16;
                const bool ok = m0 + r < M && k0 + kc < K;
                const int8_t* src = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
                cp_async16(as + r * LDS + kc, src, ok ? 16 : 0);
            }
            for (int c = tid; c < BN * CH; c += NT) {
                const int r = c / CH, kc = (c % CH) * 16;
                const bool ok = n0 + r < N && k0 + kc < K;
                const int8_t* src = ok ? w + (long long)(n0 + r) * K + k0 + kc : w;
                cp_async16(bs + r * LDS + kc, src, ok ? 16 : 0);
            }
        } else {
            for (int c = tid; c < BM * BK; c += NT) {
                const int r = c / BK, kk = c % BK;
                const bool ok = m0 + r < M && k0 + kk < K;
                as[r * LDS + kk] = ok ? x[(long long)(m0 + r) * K + k0 + kk] : int8_t(0);
            }
            for (int c = tid; c < BN * BK; c += NT) {
                const int r = c / BK, kk = c % BK;
                const bool ok = n0 + r < N && k0 + kk < K;
                bs[r * LDS + kk] = ok ? w[(long long)(n0 + r) * K + k0 + kk] : int8_t(0);
            }
        }
    };

    int acc[MT][NTL][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_tile(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();  // k-tile kt has landed
        __syncthreads();              // ...for every thread; stage kt-1 is free
        const int nxt = kt + STAGES - 1;
        if (nxt < nk) load_tile(nxt % STAGES, nxt);
        cp_async_commit();

        const int8_t* as = As + (kt % STAGES) * BM * LDS + (wm * WM + g) * LDS + t4 * 4;
        const int8_t* bs = Bs + (kt % STAGES) * BN * LDS + (wn * WN + g) * LDS + t4 * 4;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            // fragment layouts of mma.m16n8k32 .s8 (PTX ISA): a thread holds
            // rows g and g+8 at k = 4*t4..+3 and 16+4*t4..+3 of A, and
            // column g at the same k of B
            unsigned af[MT][4], bf[NTL][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int8_t* p = as + i * 16 * LDS + kk;
                af[i][0] = *reinterpret_cast<const unsigned*>(p);
                af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
                af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
                af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
            }
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
                const int8_t* p = bs + j * 8 * LDS + kk;
                bf[j][0] = *reinterpret_cast<const unsigned*>(p);
                bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NTL; ++j) mma_s8(acc[i][j], af[i], bf[j]);
        }
    }
    cp_async_wait<0>();

    // epilogue: accumulator c[h*2+e] sits at row g + 8h, column 2*t4 + e
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * WM + i * 16 + g + 8 * h;
            if (row >= M) continue;
            const float a = kAcc<OutT> ? 0.f : sx[row];
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn * WN + j * 8 + 2 * t4 + e;
                    if (col >= N) continue;
                    const long long o = (long long)row * N + col;
                    if constexpr (kAcc<OutT>) {
                        out[o] = acc[i][j][h * 2 + e];
                    } else {
                        const float v = (static_cast<float>(acc[i][j][h * 2 + e]) * a) * sw[col];
                        store_as(out + o,
                                 res ? __fadd_rn(to_f32(res[o]), round_to<OutT>(v)) : v);
                    }
                }
            }
        }
    }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename OutT>
int launch(const int8_t* x, const float* sx, const int8_t* w, const float* sw, const OutT* res,
           OutT* out, int M, int N, int K, int vec, cudaStream_t st) {
    using C = Tile<BM, BN, BK, WM, WN, STAGES>;
    auto kern = w8a8_kernel<BM, BN, BK, WM, WN, STAGES, OutT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    kern<<<grid, C::kThreads, C::kSmem, st>>>(x, sx, w, sw, res, out, M, N, K, vec);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The prefill kernel (M > 16): wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128;  // x rows (output rows) a block owns: two consumer rows of 64
constexpr int BN = 256;  // weight rows (output columns): two consumer columns of WN
constexpr int BK = 128;  // k bytes a stage holds: one 128-byte swizzle span, four k32 steps
constexpr int kStages = 4;
constexpr int WN = 128;   // a consumer's columns: 2 x 2 consumers of 64 x 128 over the tile
constexpr int kConsumers = 4;
// setmaxnreg within the 640 x 96 registers the block launches with:
// 128 * 24 + 512 * 112 <= 61440 (asking for more than the producer frees hangs)
constexpr int kProducerRegs = 24, kConsumerRegs = 112;
constexpr int kThreads = (1 + kConsumers) * 128;  // the producer warpgroup, four consumers
constexpr int kXTile = BM * BK;
constexpr int kWTile = BN * BK;
constexpr int kStageBytes = kXTile + kWTile;                             // 48 KB
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // + alignment slack
constexpr int kGroupN = 16;  // column blocks of a raster group (ops/matmul.py W8A8_GROUP_N)
}  // namespace wg

// d (64 x 128 s32) += a (64 x 32 s8) * b (32 x 128 s8), both K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// Compiler barrier on the accumulators of an asynchronous wgmma: their
// reads stay after the wait_group before them.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename OutT>
__global__ void __launch_bounds__(wg::kThreads, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                  const float* __restrict__ sw, const OutT* __restrict__ res,
                  OutT* __restrict__ out, int M, int N, int K) {
    using namespace wg;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    unsigned char* xs = base;                      // [kStages][BM][BK], 128-byte swizzle
    unsigned char* ws = base + kStages * kXTile;  // [kStages][BN][BK]
    uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
    uint64_t* empty = full + kStages;

    // raster: groups of kGroupN column blocks, m slower within a group
    const int num_n = (N + BN - 1) / BN, num_m = (M + BM - 1) / BM;
    const int per_group = kGroupN * num_m;
    const int grp = blockIdx.x / per_group, first_n = grp * kGroupN;
    const int gsz = min(num_n - first_n, kGroupN);
    const int in_grp = blockIdx.x % per_group;
    const int nb = first_n + in_grp % gsz, mb = in_grp / gsz;
    const int n0 = nb * BN, m0 = mb * BM;
    const int nk = (K + BK - 1) / BK;

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < kStages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 4 * kConsumers);  // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg_id = tid / 128;
    if (wg_id == 0) {
        // the producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (tid == 0) {
            for (int kt = 0; kt < nk; ++kt) {
                const int st = kt % kStages;
                if (kt >= kStages) mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
                mbar_expect_tx(&full[st], kStageBytes);
                tma_load(xs + st * kXTile, &xmap, kt * BK, m0, &full[st]);
                tma_load(ws + st * kWTile, &wmap, kt * BK, n0, &full[st]);
            }
        }
        return;
    }

    // consumer c: x rows m0 + 64 (c / 2) + 16 w + g (+ 8) of the block's 128, weight
    // rows (output columns) n0 + WN (c % 2) ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg_id - 1, lane = tid & 31, w = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int cm = c / 2, cn = c % 2;
    const bool active = m0 + cm * 64 < M && n0 + cn * WN < N;  // else no wgmma: all past M or N

    int acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&full[st], (kt / kStages) & 1);
        if (active) {
            fence_acc(acc);
            wgmma_fence();
            const uint64_t da = desc_sw128(xs + st * kXTile + cm * 64 * BK);
            const uint64_t db = desc_sw128(ws + st * kWTile + cn * WN * BK);
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) wgmma_m64n128k32(acc, da + 2 * t, db + 2 * t);
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's group has read its tiles
            fence_acc(acc);
        }
        if (kt > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
        }
    }
    if (!active) return;
    wgmma_wait<0>();
    fence_acc(acc);

    // acc[4 j + e] = D(row 16 w + g + 8 (e / 2), column 8 j + 2 t4 + e % 2) of the
    // consumer's 64 x WN
    const int r0 = m0 + cm * 64 + w * 16 + g;
    const bool pairs = (N & 1) == 0;  // a column pair is 2-element aligned
    float a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) a[h] = !kAcc<OutT> && r0 + 8 * h < M ? sx[r0 + 8 * h] : 0.f;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + cn * WN + 8 * j + 2 * t4;
        if (col >= N) continue;
        const bool both = col + 1 < N;
        const float s0 = kAcc<OutT> ? 0.f : sw[col];
        const float s1 = !kAcc<OutT> && both ? sw[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            if (row >= M) continue;
            const long long o = (long long)row * N + col;
            if constexpr (kAcc<OutT>) {
                const int c0 = acc[4 * j + 2 * h], c1 = acc[4 * j + 2 * h + 1];
                if (pairs && both) {
                    *reinterpret_cast<int2*>(out + o) = make_int2(c0, c1);
                } else {
                    out[o] = c0;
                    if (both) out[o + 1] = c1;
                }
            } else {
                float v0 = (static_cast<float>(acc[4 * j + 2 * h]) * a[h]) * s0;
                float v1 = (static_cast<float>(acc[4 * j + 2 * h + 1]) * a[h]) * s1;
                if (pairs && both) {
                    if (res) {
                        float q0, q1;
                        load_pair(res + o, q0, q1);
                        v0 = __fadd_rn(q0, round_to<OutT>(v0));
                        v1 = __fadd_rn(q1, round_to<OutT>(v1));
                    }
                    store_pair(out + o, v0, v1);
                } else {
                    store_as(out + o, res ? __fadd_rn(to_f32(res[o]), round_to<OutT>(v0)) : v0);
                    if (both)
                        store_as(out + o + 1,
                                 res ? __fadd_rn(to_f32(res[o + 1]), round_to<OutT>(v1)) : v1);
                }
            }
        }
    }
}

template <typename OutT>
int launch_wgmma(const int8_t* x, const float* sx, const int8_t* w, const float* sw,
                 const OutT* res, OutT* out, int M, int N, int K, cudaStream_t st) {
    CUtensorMap xm, wm;
    if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, M, K, wg::BM, wg::BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, wg::BN, wg::BK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kern = w8a8_wgmma_kernel<OutT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = ((N + wg::BN - 1) / wg::BN) * ((M + wg::BM - 1) / wg::BM);
    kern<<<blocks, wg::kThreads, wg::kSmem, st>>>(xm, wm, sx, sw, res, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch(const int8_t* x, const float* sx, const int8_t* w, const float* sw, const void* res,
             void* out, int M, int N, int K, int vec, cudaStream_t st) {
    const OutT* r = static_cast<const OutT*>(res);
    OutT* o = static_cast<OutT*>(out);
    if (M <= 16) return launch<16, 32, 256, 16, 8, 4>(x, sx, w, sw, r, o, M, N, K, vec, st);
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);  // TMA: K % 16, aligned bases
    return launch_wgmma<OutT>(x, sx, w, sw, r, o, M, N, K, st);
}

}  // namespace

// vec != 0 promises K % 16 == 0 and 16-byte aligned x and w (the wrapper
// checks, and pads K for M > 16, where the kernel requires it); otherwise
// the decode tile loads byte by byte.  res is null, or a contiguous [M, N]
// residual of the output type; out_dtype TL_I32 (the int32 form) takes no
// residual and reads no scales.
extern "C" int tl_w8a8_matmul(const int8_t* x, const float* sx, const int8_t* w,
                              const float* sw, const void* res, void* out, int out_dtype,
                              int M, int N, int K, int vec, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_dtype == TL_F32) return dispatch<float>(x, sx, w, sw, res, out, M, N, K, vec, st);
    if (out_dtype == TL_BF16)
        return dispatch<__nv_bfloat16>(x, sx, w, sw, res, out, M, N, K, vec, st);
    if (out_dtype == TL_I32 && !res)
        return dispatch<int32_t>(x, sx, w, sw, res, out, M, N, K, vec, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
