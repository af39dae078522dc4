// Shared code of the fused decode kernels on fused_step2.cuh's streaming
// body -- K11 fused_layer.cu, K12 fused_step2.cu, K26 fused_step3.cu, K27
// fused_step.cu and the tensor-parallel spans K23 fused_ffn.cu and K24
// fused_rms_qkv.cu: the decode layer's arguments (Linear), the row steps'
// fallbacks for rows longer than the body holds in registers, the
// development stamps, and the cooperative launch (its grid from CUDA's
// residency query, refused and never shrunk).
//
// The TPU kernels (tpu_llama/ops/fused_layer.py:77, :376, :488) are one
// sequential grid whose phases carry the int8 rows in VMEM from step to
// step, with each boundary (rmsnorm, row quant) at the last step of a
// phase.  CUDA blocks run in parallel and carry nothing, so here every
// block of a cooperative launch (as many as fit on the card at once) takes
// a share of every phase, each boundary is a counter that blocks wait on,
// and the carried state lives in global scratch that stays in L2.  A decode
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
// TB/s).  Numerics: every f32 product and sum of the epilogues and the SiLU
// is an explicit round-to-nearest intrinsic, so the plain versions
// (ops/fused_layer.py, ops/fused_step2.py) repeat them bit for bit; the
// rmsnorm is K3's (f64 sum of squares), the row quant K2's.
//
// Memory order: scratch that one block writes and another reads later in
// the launch is read with ld.global.cg (L2, never a stale L1 line), and
// never through a const __restrict__ pointer, which nvcc may turn into the
// non-coherent read-only path.
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
constexpr int kMaxRows = 32;    // batch rows a launch (K23, K24: a row group) takes

__device__ __forceinline__ float load_w(const void* w, int i, int bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

// K3's rmsnorm + row quant of one row x [n] (scratch) with weight w [n]
// (f32, or bf16 when wbf16): q int8 [n], *s.  Every thread of the block
// calls.  The streaming body's row steps (fused_step2.cuh) fall back to it
// for rows longer than they hold in registers; quant_row likewise.
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
    const float* x;        // [B, D] residual entering the layer (K26's second layer: scratch;
                           // K23, K24: the launch's x, which their row step enters from)
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
    const void* rms_att;   // [D] of layer l + 1 (K24: of layer l)
    int rms_bf16;
    float* x_next;         // [B, D]: x2 after phase A, the layer's output after C (K23: the
                           // w2 partial)
    float* qkv;            // [B, QO]: phase D (K24's output)
    int8_t* xq;            // [B, D] scratch: xq2, then xq4
    float* sx;             // [B]
    float* h2;             // [B, H]
    int8_t* xq3;           // [B, H] h2 quantized (K23: scratch; else in the workspace)
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
