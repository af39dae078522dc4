// K29: K1's W8A8 product with the activation rows held resident in shared
// memory while the weights stream past them.
//
// Replaces tpu_llama/ops/matmul.py:314 _w8a8_rows_resident_call (its
// Pallas kernels _w8a8_rows_res_kernel :276 and _w8a8_rows_res_res_kernel
// :294), which w8a8_matmul_prequant takes above 256 rows when
// TPU_LLAMA_ROWS_RESIDENT=1 (matmul.py:513-519).  K1's function:
//   out[m, n] = cast((f32(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
// and with a residual r [M, N] of the output type, out = r + cast(mm), the
// product rounded to the output type first (an explicit round-to-nearest
// add).  The int32 sums are exact and the epilogue is K1's, so K29 equals
// K1 bit for bit.
//
// Bound on the H100: int8 tensor-core operations at the prefill shapes
// (M = 4096).  Design, the TPU kernel's idea with the card's sizes (its
// VMEM plan, _pick_rows_resident, is not carried): each block loads a BM x
// IN slice of x into shared memory once, with cp.async, and loops over its
// output tiles of 128 weight rows (K-major), streaming each tile's k-tiles
// through a four-stage cp.async ring; mma.sync m16n8k32 s8, A fragments
// read from the resident slice, eight warps of 16 columns each.  BM is set
// by the 227 KB of shared memory a block may use: 32 rows where the slice
// and the ring fit (IN <= 5952), else 16 (IN <= 11904; Llama-2 7B's w2 has
// IN = 11008).  One block per m-block walks every output tile, so each
// weight tile streams past each x slice once; where there are fewer
// m-blocks than SMs, the output tiles are split across that many more
// blocks.  wgmma and TMA are later work, as for K1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kBN = 128;       // weight rows (output columns) per tile: 16 per warp
constexpr int kBK = 64;        // bytes of K per weight stage
constexpr int kStages = 4;
constexpr int kLdw = kBK + 16;  // padded weight row pitch: conflict-free fragments
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The padded row pitch of the resident x slice: whole weight stages, plus
// 16 bytes so that rows g and g + 8 of a fragment fall in other banks.
__host__ __device__ __forceinline__ int x_pitch(int K) { return (K + kBK - 1) / kBK * kBK + 16; }

template <int BM>
__host__ __device__ __forceinline__ int smem_bytes(int K) {
    return BM * x_pitch(K) + kStages * kBN * kLdw;
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(kThreads)
rows_resident_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                     const int8_t* __restrict__ w, const float* __restrict__ sw,
                     const OutT* __restrict__ res, OutT* __restrict__ out, int M, int N, int K) {
    constexpr int MT = BM / 16;  // mma row tiles
    extern __shared__ __align__(16) int8_t smem[];
    const int LDX = x_pitch(K);
    int8_t* xs = smem;                 // [BM][LDX], resident
    int8_t* ws = smem + BM * LDX;      // [kStages][kBN][kLdw]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int m0 = blockIdx.y * BM;
    const int nk = (K + kBK - 1) / kBK;

    // the x slice, once: rows past M are zero-filled (K % 16 == 0)
    const int per_row = K / 16;
    for (int c = tid; c < BM * per_row; c += kThreads) {
        const int r = c / per_row, kc = (c % per_row) * 16;
        const bool ok = m0 + r < M;
        cp_async16(xs + r * LDX + kc, ok ? x + (long long)(m0 + r) * K + kc : x, ok ? 16 : 0);
    }
    cp_async_commit();

    for (int t = blockIdx.x; t * kBN < N; t += gridDim.x) {
        const int n0 = t * kBN;
        auto load_stage = [&](int stage, int kt) {
            const int k0 = kt * kBK;
            int8_t* bs = ws + stage * kBN * kLdw;
            constexpr int CH = kBK / 16;
            for (int c = tid; c < kBN * CH; c += kThreads) {
                const int r = c / CH, kc = (c % CH) * 16;
                const bool ok = n0 + r < N && k0 + kc < K;
                cp_async16(bs + r * kLdw + kc, ok ? w + (long long)(n0 + r) * K + k0 + kc : w,
                           ok ? 16 : 0);
            }
        };
        int acc[MT][2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
            if (s < nk) load_stage(s, s);
            cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
            cp_async_wait<kStages - 2>();  // k-tile kt (and, first, the x slice) has landed
            __syncthreads();               // ...for every thread; stage kt-1 is free
            const int nxt = kt + kStages - 1;
            if (nxt < nk) load_stage(nxt % kStages, nxt);
            cp_async_commit();
            // columns past K meet zero weights: the x pad there is never summed in
            const int8_t* as = xs + g * LDX + kt * kBK + t4 * 4;
            const int8_t* bs = ws + (kt % kStages) * kBN * kLdw + (warp * 16 + g) * kLdw + t4 * 4;
#pragma unroll
            for (int kk = 0; kk < kBK; kk += 32) {
                unsigned af[MT][4], bf[2][2];
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    const int8_t* p = as + i * 16 * LDX + kk;
                    af[i][0] = *reinterpret_cast<const unsigned*>(p);
                    af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDX);
                    af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
                    af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDX + 16);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int8_t* p = bs + j * 8 * kLdw + kk;
                    bf[j][0] = *reinterpret_cast<const unsigned*>(p);
                    bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
                }
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) mma_s8(acc[i][j], af[i], bf[j]);
            }
        }
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with the stages: the next tile may load

        // K1's epilogue: accumulator c[h*2+e] sits at row g + 8h, column 2*t4 + e
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + i * 16 + g + 8 * h;
                if (row >= M) continue;
                const float a = sx[row];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = n0 + warp * 16 + j * 8 + 2 * t4 + e;
                        if (col >= N) continue;
                        const long long o = (long long)row * N + col;
                        const float v = (static_cast<float>(acc[i][j][h * 2 + e]) * a) * sw[col];
                        store_as(out + o, res ? __fadd_rn(to_f32(res[o]), round_to<OutT>(v)) : v);
                    }
                }
            }
        }
    }
}

template <int BM, typename OutT>
int launch(const int8_t* x, const float* sx, const int8_t* w, const float* sw, const void* res,
           void* out, int M, int N, int K, cudaStream_t st) {
    auto kern = rows_resident_kernel<BM, OutT>;
    const int smem = smem_bytes<BM>(K);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nm = (M + BM - 1) / BM, tiles = (N + kBN - 1) / kBN;
    int split = (sms + nm - 1) / nm;  // fewer m-blocks than SMs: split the output tiles
    split = split < 1 ? 1 : (split > tiles ? tiles : split);
    kern<<<dim3(split, nm), kThreads, smem, st>>>(x, sx, w, sw, static_cast<const OutT*>(res),
                                                  static_cast<OutT*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch(int bm, const int8_t* x, const float* sx, const int8_t* w, const float* sw,
             const void* res, void* out, int M, int N, int K, cudaStream_t st) {
    if (bm == 32) return launch<32, OutT>(x, sx, w, sw, res, out, M, N, K, st);
    if (bm == 16) return launch<16, OutT>(x, sx, w, sw, res, out, M, N, K, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The block's rows BM for a product of inner size K: 32 or 16 where the x
// slice and the weight ring fit in a block's shared memory, else 0 (the
// kernel does not take K).  ops/matmul.py rows_resident_bm mirrors it.
int rows_bm(int K) {
    if (K < 16 || K % 16) return 0;
    if (smem_bytes<32>(K) <= kMaxSmem) return 32;
    if (smem_bytes<16>(K) <= kMaxSmem) return 16;
    return 0;
}

}  // namespace

// As tl_w8a8_matmul (w8a8_matmul.cu), with bm the rows rows_bm(K) picks:
// xq int8 [M, K] and wq int8 [N, K] contiguous and 16-byte aligned, K a
// multiple of 16; res null or [M, N] of the output type.
extern "C" int tl_w8a8_rows_resident(const int8_t* x, const float* sx, const int8_t* w,
                                     const float* sw, const void* res, void* out, int out_dtype,
                                     int M, int N, int K, int bm, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (bm == 0 || bm != rows_bm(K)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_dtype == TL_F32) return dispatch<float>(bm, x, sx, w, sw, res, out, M, N, K, st);
    if (out_dtype == TL_BF16)
        return dispatch<__nv_bfloat16>(bm, x, sx, w, sw, res, out, M, N, K, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
