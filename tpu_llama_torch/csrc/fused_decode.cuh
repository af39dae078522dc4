// Shared code of the fused decode kernels: K23 fused_ffn.cu and K24
// fused_rms_qkv.cu (gemm_tile, grid_sync and the row steps, one persistent
// cooperative launch each), and the decode layer's arguments (Linear), the
// row steps' fallbacks and the cooperative launch that fused_step2.cuh's
// streaming body -- K11 fused_layer.cu, K12 fused_step2.cu, K26
// fused_step3.cu, K27 fused_step.cu -- takes from here.
//
// The TPU kernels (tpu_llama/ops/fused_layer.py:77, :376, :488) are one
// sequential grid whose phases carry the int8 rows in VMEM from step to
// step, with each boundary (rmsnorm, row quant) at the last step of a
// phase.  CUDA blocks run in parallel and carry nothing, so here every
// block of a cooperative launch (as many as fit on the card at once) walks
// the output tiles of a phase, the phases are separated by a grid barrier,
// and the carried state lives in global scratch that stays in L2.  A
// boundary is done by one block per row, between two barriers.  A decode
// layer's phases (fused_step2.cuh runs them):
//
//   A  x2 = x + (f32(attq . wo) * satt) * wo_s              -> x_next
//   |  rmsnorm(x2, rms_ffn) -> int8 xq, sx
//   B  g, u = w13 gate / up columns j and H + j;
//      h2 = (g * (1 / (1 + exp(-g)))) * u                    -> h2 (K12: bf16-rounded)
//   |  row quant of h2 -> int8 xq3
//   C  x_next = x2 + (f32(xq3 . w2) * sx3) * w2_s             (last layer: done)
//   |  rmsnorm(x_next, rms_att[l + 1]) -> int8 xq, sx
//   D  qkv = (f32(xq . wqkv[l + 1]) * sx) * qkv_s
//
// Bound on the H100: bytes.  At M = B <= 32 rows every phase is a product
// that streams its weights once (202.4 MB per 7B layer: 60.4 us at 3.35
// TB/s).  gemm_tile (K23, K24): a tile is 32 weight rows (output columns)
// over the whole K, K1's decode mainloop -- mma.sync m16n8k32 s8 on
// K-contiguous operands, a four-stage cp.async ring of 256-byte k-tiles --
// with the activation rows read from L2 through cp.async.cg.  Numerics:
// every f32 product and sum of the epilogues and the SiLU is an explicit
// round-to-nearest intrinsic, so the plain versions (ops/fused_layer.py,
// ops/fused_step2.py) repeat them bit for bit; the rmsnorm is K3's (f64 sum
// of squares), the row quant K2's.
//
// Memory order: scratch that one block writes and another reads after a
// barrier is read with ld.global.cg / cp.async.cg (L2, never a stale L1
// line), and never through a const __restrict__ pointer, which nvcc may
// turn into the non-coherent read-only path.
#pragma once

#include <mutex>

#include "common.cuh"

namespace fd {

// Development stamps (compiled only with -DFD_STAMPS, which no committed
// build passes; tpu_llama_torch/k12_phases.py builds it): FD_STAMP(i)
// records %globaltimer (ns) at event i of the block into fd_stamps[block][i].
constexpr int kStampEvents = 24;
constexpr int kStampBlocks = 2048;
#ifdef FD_STAMPS
__device__ unsigned long long fd_stamps[kStampBlocks * kStampEvents];
#define FD_STAMP(i)                                                                          \
    do {                                                                                     \
        __syncthreads();                                                                     \
        if (threadIdx.x == 0 && blockIdx.x < fd::kStampBlocks) {                             \
            unsigned long long t_;                                                           \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                           \
            fd::fd_stamps[blockIdx.x * fd::kStampEvents + (i)] = t_;                         \
        }                                                                                    \
    } while (0)
#else
#define FD_STAMP(i) \
    do {            \
    } while (0)
#endif

constexpr int kThreads = 128;
static_assert(kThreads == kDecThreads, "K12's and K27's attention cells run in the same blocks");
constexpr int kBN = 32;      // weight rows (output columns) per tile
constexpr int kBK = 256;     // bytes of K per stage
constexpr int kStages = 4;
constexpr int kLds = kBK + 16;  // padded row stride: conflict-free fragments
constexpr int kMaxRows = 32;    // batch rows a launch takes

template <int BM>
constexpr int gemm_smem() {
    return kStages * (BM + kBN) * kLds;
}

// A barrier across the whole grid.  Valid only under a cooperative launch,
// which makes every block resident at once.  bar[0] counts arrivals and is
// back at 0 after every barrier; bar[1] is the generation.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned int* gen = bar + 1;
        const unsigned int g = *gen;
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            while (*gen == g) __nanosleep(32);
        }
        __threadfence();
    }
    __syncthreads();
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output tile: the exact int32 products of the M <= BM activation rows
// A [M, K] (row stride K, in scratch) with the kBN weight rows wrow(r)
// (K-contiguous; nullptr past the edge).  Calls epi(row, c, acc_c, acc_c1)
// for every row < M and every even local column c (the pair c, c + 1).
// Four warps, each on 8 weight rows; vec promises K % 16 == 0 and 16-byte
// aligned rows.
template <int BM, class WRow, class Epi>
__device__ void gemm_tile(const int8_t* A, int M, int K, int vec, WRow wrow, Epi epi,
                          int8_t* smem) {
    constexpr int MT = BM / 16;
    int8_t* As = smem;                          // [kStages][BM][kLds]
    int8_t* Bs = smem + kStages * BM * kLds;    // [kStages][kBN][kLds]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int nk = (K + kBK - 1) / kBK;

    auto load_tile = [&](int stage, int kt) {
        const int k0 = kt * kBK;
        int8_t* as = As + stage * BM * kLds;
        int8_t* bs = Bs + stage * kBN * kLds;
        if (vec) {
            constexpr int CH = kBK / 16;
            for (int c = tid; c < BM * CH; c += kThreads) {
                const int r = c / CH, kc = (c % CH) * 16;
                const bool ok = r < M && k0 + kc < K;
                cp_async16(as + r * kLds + kc, ok ? A + (long long)r * K + k0 + kc : A, ok ? 16 : 0);
            }
            for (int c = tid; c < kBN * CH; c += kThreads) {
                const int r = c / CH, kc = (c % CH) * 16;
                const int8_t* row = wrow(r);
                const bool ok = row != nullptr && k0 + kc < K;
                cp_async16(bs + r * kLds + kc, ok ? row + k0 + kc : A, ok ? 16 : 0);
            }
        } else {
            for (int c = tid; c < BM * kBK; c += kThreads) {
                const int r = c / kBK, kk = c % kBK;
                const bool ok = r < M && k0 + kk < K;
                as[r * kLds + kk] = ok ? __ldcg(A + (long long)r * K + k0 + kk) : int8_t(0);
            }
            for (int c = tid; c < kBN * kBK; c += kThreads) {
                const int r = c / kBK, kk = c % kBK;
                const int8_t* row = wrow(r);
                bs[r * kLds + kk] = row != nullptr && k0 + kk < K ? row[k0 + kk] : int8_t(0);
            }
        }
    };

    int acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_tile(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // k-tile kt has landed
        __syncthreads();               // ...for every thread; stage kt-1 is free
        const int nxt = kt + kStages - 1;
        if (nxt < nk) load_tile(nxt % kStages, nxt);
        cp_async_commit();

        const int8_t* as = As + (kt % kStages) * BM * kLds + g * kLds + t4 * 4;
        const int8_t* bs = Bs + (kt % kStages) * kBN * kLds + (warp * 8 + g) * kLds + t4 * 4;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 32) {
            // fragments of mma.m16n8k32 .s8, as in w8a8_matmul.cu
            unsigned af[MT][4], bf[2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int8_t* p = as + i * 16 * kLds + kk;
                af[i][0] = *reinterpret_cast<const unsigned*>(p);
                af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLds);
                af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
                af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLds + 16);
            }
            bf[0] = *reinterpret_cast<const unsigned*>(bs + kk);
            bf[1] = *reinterpret_cast<const unsigned*>(bs + kk + 16);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_s8(acc[i], af[i], bf);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages: the next tile may load

    // accumulator c[h * 2 + e] sits at row g + 8h, column 2 * t4 + e of the warp's 8
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = i * 16 + g + 8 * h;
            if (row < M) epi(row, warp * 8 + 2 * t4, acc[i][2 * h], acc[i][2 * h + 1]);
        }
}

__device__ __forceinline__ float load_w(const void* w, int i, int bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

// K3's rmsnorm + row quant of one row x [n] (scratch) with weight w [n]
// (f32, or bf16 when wbf16): q int8 [n], *s.  Every thread of the block calls.
__device__ void rms_quant_row(const float* x, const void* w, int wbf16, int n, int8_t* q,
                              float* s) {
    __shared__ double dred[kThreads / 32];
    __shared__ float fred[kThreads / 32];
    double ss = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const double v = __ldcg(x + i);
        ss += v * v;
    }
    const float r = rms_factor(block_sum<kThreads>(ss, dred), n);
    auto xf = [&](int i) { return __fmul_rn(__fmul_rn(__ldcg(x + i), r), load_w(w, i, wbf16)); };
    float amax = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) amax = fmaxf(amax, fabsf(xf(i)));
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
    for (int i = threadIdx.x; i < n; i += kThreads) q[i] = quant_i8(xf(i), inv);
    if (threadIdx.x == 0) *s = sc;
}

// K2's row quant of one row x [n] (scratch): q int8 [n], *s.
__device__ void quant_row(const float* x, int n, int8_t* q, float* s) {
    __shared__ float fred[kThreads / 32];
    float amax = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) amax = fmaxf(amax, fabsf(__ldcg(x + i)));
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
    for (int i = threadIdx.x; i < n; i += kThreads) q[i] = quant_i8(__ldcg(x + i), inv);
    if (threadIdx.x == 0) *s = sc;
}

// One layer's linear work.  Weights are the layer's views: wo [D, D], w13
// [2H, D] (gate rows, then up rows), w2 [D, H], wqkv [QO, D] of layer
// l + 1, all K-major, with their f32 column scales.
struct Linear {
    const float* x;        // [B, D] residual entering the layer (K26's second layer: scratch)
    const int8_t* attq;    // [B, D] quantized attention output (K26, K27: scratch)
    const float* satt;     // [B]
    const int8_t* wo;
    const float* wos;
    const int8_t* w13;
    const float* w13s;
    const int8_t* w2;
    const float* w2s;
    const int8_t* wqkv;
    const float* wqkvs;
    const void* rms_ffn;   // [D] of layer l
    const void* rms_att;   // [D] of layer l + 1
    int rms_bf16;
    float* x_next;         // [B, D]: x2 after phase A, the layer's output after C
    float* qkv;            // [B, QO]: phase D
    int8_t* xq;            // [B, D] scratch: xq2, then xq4
    float* sx;             // [B]
    float* h2;             // [B, H]
    int8_t* xq3;           // [B, H] h2 quantized (in the launch's workspace)
    int B, D, H, QO, last, vec;
};

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Checks the shapes a launch takes and fills a.vec.
inline int prepare(Linear& a) {
    if (a.B < 1 || a.B > kMaxRows || a.D < 1 || a.H < 1 || a.QO < 1 ||
        (a.rms_bf16 != 0 && a.rms_bf16 != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    a.vec = a.D % 16 == 0 && a.H % 16 == 0 && aligned16(a.attq) && aligned16(a.xq) &&
            aligned16(a.xq3) && aligned16(a.wo) && aligned16(a.w13) && aligned16(a.w2) &&
            aligned16(a.wqkv);
    return 0;
}

// Let kern take at least smem bytes of dynamic shared memory on the current
// device: the attribute is raised, never lowered (a launch at another size
// may follow any other, and a cooperative launch above the attribute is
// refused as too large).
template <class Args>
cudaError_t raise_smem_attr(void (*kern)(Args), int smem) {
    struct Set {
        const void* fn;
        int dev, smem;
    };
    constexpr int kSlots = 64;
    static Set known[kSlots];
    static int used = 0;
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const void* f = reinterpret_cast<const void*>(kern);
    std::lock_guard<std::mutex> hold(lock);
    int i = 0;
    while (i < used && (known[i].fn != f || known[i].dev != dev)) ++i;
    if (i < used && known[i].smem >= smem) return cudaSuccess;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (i < used)
        known[i].smem = smem;
    else if (used < kSlots)
        known[used++] = {f, dev, smem};
    return cudaSuccess;
}

// Blocks of kern that fit on one SM at once with smem bytes of dynamic
// shared memory, into *per_sm.
template <class Args>
cudaError_t resident_blocks(void (*kern)(Args), int smem, int* per_sm) {
    cudaError_t err = raise_smem_attr(kern, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, smem);
}

// The blocks of kern that one SM keeps resident at `smem` bytes of dynamic
// shared memory, and the card's SMs: the attribute, the occupancy query and
// the SM count once per (kernel, shared memory size, device), not at every
// launch (they cost the host more than the launch; 32 launches a step).
template <class Args>
cudaError_t launch_shape(void (*kern)(Args), int smem, int* per_sm, int* sms) {
    struct Shape {
        const void* fn;
        int smem, dev, per_sm, sms;
    };
    constexpr int kSlots = 64;
    static Shape known[kSlots];
    static int used = 0;
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const void* f = reinterpret_cast<const void*>(kern);
    {
        std::lock_guard<std::mutex> hold(lock);
        for (int i = 0; i < used; ++i)
            if (known[i].fn == f && known[i].smem == smem && known[i].dev == dev) {
                *per_sm = known[i].per_sm;
                *sms = known[i].sms;
                return cudaSuccess;
            }
    }
    if ((err = resident_blocks(kern, smem, per_sm)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    std::lock_guard<std::mutex> hold(lock);
    if (used < kSlots) known[used++] = {f, smem, dev, *per_sm, *sms};
    return cudaSuccess;
}

// Launches kern(args) cooperatively with as many blocks as fit on the card
// at once -- or, with per_sm_want > 0, with exactly per_sm_want blocks per
// SM (K26 runs on K12's grid, K11 on two), refused if fewer fit.  A refused launch
// (cudaErrorCooperativeLaunchTooLarge) is returned, never retried.
template <class Args>
int coop_launch(void (*kern)(Args), const Args& args, int smem, cudaStream_t st,
                int per_sm_want = 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = launch_shape(kern, smem, &per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm_want > 0) {
        if (per_sm < per_sm_want) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
        per_sm = per_sm_want;
    }
    if (per_sm * sms < kMaxRows)  // the boundaries take one block per row
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    void* params[] = {const_cast<Args*>(&args)};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms),
                                      dim3(kThreads), params, smem, st);
    return static_cast<int>(err);
}

}  // namespace fd
