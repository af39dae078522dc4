// K1: W8A8 matrix product with int32 accumulation and a per-row x
// per-column rescale.
//
// Replaces tpu_llama/ops/matmul.py:483 w8a8_matmul_prequant (its Pallas
// kernel _w8a8_kernel, matmul.py:364).
//   out[m, n] = cast((f32(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n])
// xq int8 [M, K] row-major, wq int8 [N, K] (K-major: the transpose of the
// JAX package's [IN, OUT]), sx f32 [M], sw f32 [N], out f32 or bf16 [M, N].
// The epilogue multiplies in the order of matmul.py:383-385 and rounds once
// to the output type, so the result is bit-equal to the plain version.
// With a residual r [M, N] (of the output type) the epilogue is the residual
// one, _w8a8_res_kernel (matmul.py:388-409): out = r + cast(mm), the matmul
// term rounded to the output type first, then added in that type -- the
// unfused x + mm -- with an explicit round-to-nearest add, so nvcc cannot
// contract it into an FMA with the rescale.
//
// Bound on the H100: at decode (M = 8) bytes -- every weight byte is read
// once per step and reused by only 8 rows; at prefill (M = 4096) int8
// tensor-core operations.  Design: mma.sync m16n8k32 (s8 x s8 -> s32) on
// K-contiguous operands, so every fragment is a 32-bit shared-memory load
// with no shuffles; a cp.async ring of STAGES k-tiles keeps loads in flight
// while the warps multiply.  Two tile shapes: for M <= 16 a 16 x 32 block
// with 256-byte k-tiles (many blocks, deep loads in flight, for bandwidth),
// otherwise 128 x 128 blocks of eight warps (operand reuse, for the tensor
// cores).  wgmma and TMA are left to a later change.
#include "common.cuh"

namespace {

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
            const float a = sx[row];
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn * WN + j * 8 + 2 * t4 + e;
                    if (col >= N) continue;
                    const long long o = (long long)row * N + col;
                    const float v = (static_cast<float>(acc[i][j][h * 2 + e]) * a) * sw[col];
                    store_as(out + o, res ? __fadd_rn(to_f32(res[o]), round_to<OutT>(v)) : v);
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

template <typename OutT>
int dispatch(const int8_t* x, const float* sx, const int8_t* w, const float* sw, const void* res,
             void* out, int M, int N, int K, int vec, cudaStream_t st) {
    const OutT* r = static_cast<const OutT*>(res);
    OutT* o = static_cast<OutT*>(out);
    if (M <= 16) return launch<16, 32, 256, 16, 8, 4>(x, sx, w, sw, r, o, M, N, K, vec, st);
    return launch<128, 128, 64, 64, 32, 3>(x, sx, w, sw, r, o, M, N, K, vec, st);
}

}  // namespace

// vec != 0 promises K % 16 == 0 and 16-byte aligned x and w (the wrapper
// checks); otherwise the tiles load byte by byte.  res is null, or a
// contiguous [M, N] residual of the output type.
extern "C" int tl_w8a8_matmul(const int8_t* x, const float* sx, const int8_t* w,
                              const float* sw, const void* res, void* out, int out_dtype,
                              int M, int N, int K, int vec, void* stream) {
    if (M <= 0 || N <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_dtype == TL_F32) return dispatch<float>(x, sx, w, sw, res, out, M, N, K, vec, st);
    if (out_dtype == TL_BF16)
        return dispatch<__nv_bfloat16>(x, sx, w, sw, res, out, M, N, K, vec, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
