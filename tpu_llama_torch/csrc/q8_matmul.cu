// K25: x @ W with W in the Q8_0 format (group-wise INT8 along the
// contraction), dequantized inside the kernel.
//
// Replaces tpu_llama/ops/matmul.py:142 q8_matmul (its Pallas kernel
// _q8_matmul_kernel, matmul.py:120).  Contract:
//   w[n, k]   = bf16(bf16(q[n, k]) * bf16(s[n, k / g]))
//   out[m, n] = cast(sum_k f32(bf16(x[m, k])) * f32(w[n, k]))
// -- the TPU kernel's arithmetic: q and s are each cast to bf16 and
// multiplied in bf16 (one rounding), x is cast to bf16, the products are
// exact in f32 and the sum is taken in f32, then cast once to the output
// type.  A kernel that dequantized in f32 would differ in the last bits of
// every weight.  q int8 [Np, K] is K-major (the transpose of the JAX
// package's [IN, OUT]) with K the padded in-dim (a multiple of 128 and of
// g) and Np the padded out-dim (a multiple of 128); s f32 [Np, K / g]; x
// [M, K] f32 or bf16, zero past its logical in-dim; out [M, N] f32 or bf16
// with N <= Np the logical out-dim.
//
// Bound on the H100: at decode (M = 8) bytes -- every weight byte and its
// share 4 / g of a scale is read once per step (w13 4096 x 22016 at g 64:
// 95.8 MB, 28.6 us at 3.35 TB/s); at prefill (M = 4096) bf16 tensor-core
// operations (w13: 739 GFLOP, 0.75 ms at 989 TFLOP/s).  Design: mma.sync
// m16n8k16 (bf16 x bf16 -> f32) -- exactly the TPU kernel's arithmetic --
// on K-contiguous operands staged raw (int8 weights, their scales, x in its
// own type) through a cp.async ring of STAGES k-tiles, so no bf16 copy of W
// exists in device memory.  Two kernels, by M:
// * M <= 16 (decode), q8_matmul_kernel: a 16 x 32 block with 256-element
//   k-tiles (many blocks, deep loads in flight, for bandwidth), each
//   fragment dequantized (weights) or rounded (x) to bf16 in registers as
//   it is read -- one warp per 8 columns, so nothing is converted twice;
// * M > 16 (prefill), q8_matmul_tc_kernel: 128 x 128 blocks of eight warps
//   (operand reuse, for the tensor cores); each k-tile is converted once
//   per block, all threads together, into bf16 tiles in shared memory, which
//   the warps read with ldmatrix -- converting per fragment there costs
//   two to four times over, each weight for every warp row of the block.
// wgmma and TMA are left to a later change.
#include "common.cuh"

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// Two neighbouring elements of x as a bf16 pair (lower k in the low half).
__device__ __forceinline__ unsigned x_pair(const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ unsigned x_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned*>(p);
}

// Two neighbouring int8 weights dequantized with the bf16 scale sb: each
// bf16(q) * sb is exact in f32 (8 x 8 significant bits), then rounded once.
__device__ __forceinline__ unsigned w_pair(const int8_t* p, float sb) {
    return pack_bf16(static_cast<float>(p[0]) * sb, static_cast<float>(p[1]) * sb);
}

// BM x BN block tile, BK elements of K per stage, warps of WM x WN.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename XT>
struct Tile {
    static constexpr int kWarpsN = BN / WN;
    static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
    static constexpr int kLdx = BK + 8;    // x row pitch (elements): conflict-free pairs
    static constexpr int kLdw = BK + 16;   // weight row pitch (bytes)
    static constexpr int kSg = BK / 16;    // scale slots per weight row and stage (g >= 16)
    static constexpr int kStageBytes =
        BM * kLdx * static_cast<int>(sizeof(XT)) + BN * kLdw + BN * kSg * 4;
    static constexpr int kSmem = STAGES * kStageBytes;
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename XT, typename OT>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN, STAGES, XT>::kThreads)
q8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, OT* __restrict__ out, int M, int N, int Np,
                 int K, int g) {
    using C = Tile<BM, BN, BK, WM, WN, STAGES, XT>;
    constexpr int NT = C::kThreads, LDX = C::kLdx, LDW = C::kLdw, SG = C::kSg;
    constexpr int MT = WM / 16, NTL = WN / 8;  // mma tiles per warp
    constexpr int XV = 16 / static_cast<int>(sizeof(XT));  // x elements per 16-byte chunk
    extern __shared__ __align__(16) unsigned char smem[];
    auto xs_of = [&](int st) {
        return reinterpret_cast<XT*>(smem + st * C::kStageBytes);
    };
    auto ws_of = [&](int st) {
        return reinterpret_cast<int8_t*>(smem + st * C::kStageBytes + BM * LDX * sizeof(XT));
    };
    auto ss_of = [&](int st) {
        return reinterpret_cast<float*>(smem + st * C::kStageBytes + BM * LDX * sizeof(XT) +
                                        BN * LDW);
    };

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
    const int gq = lane >> 2, t4 = lane & 3;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nk = (K + BK - 1) / BK;
    const int KG = K / g;          // scales per weight row
    const int sg = BK / g;         // scales of one row in a k-tile (BK is a multiple of g)

    // One k-tile of x rows [m0, m0+BM), weight rows [n0, n0+BN) and their
    // scales into a stage; out-of-range rows and k are zero-filled.
    auto load_tile = [&](int stage, int kt) {
        const int k0 = kt * BK;
        XT* xs = xs_of(stage);
        int8_t* ws = ws_of(stage);
        float* ss = ss_of(stage);
        constexpr int XC = BK / XV;
        for (int c = tid; c < BM * XC; c += NT) {
            const int r = c / XC, kc = (c % XC) * XV;
            const bool ok = m0 + r < M && k0 + kc < K;
            const XT* src = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
            cp_async16(xs + r * LDX + kc, src, ok ? 16 : 0);
        }
        constexpr int WC = BK / 16;
        for (int c = tid; c < BN * WC; c += NT) {
            const int r = c / WC, kc = (c % WC) * 16;
            const bool ok = n0 + r < Np && k0 + kc < K;
            const int8_t* src = ok ? q + (long long)(n0 + r) * K + k0 + kc : q;
            cp_async16(ws + r * LDW + kc, src, ok ? 16 : 0);
        }
        for (int c = tid; c < BN * sg; c += NT) {
            const int r = c / sg, j = c % sg;
            const int kg = k0 / g + j;
            if (n0 + r < Np && kg < KG)
                cp_async4(ss + r * SG + j, s + (long long)(n0 + r) * KG + kg);
            else
                ss[r * SG + j] = 0.f;
        }
    };

    float acc[MT][NTL][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nk) load_tile(st, st);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();  // k-tile kt has landed
        __syncthreads();              // ...for every thread; stage kt-1 is free
        const int nxt = kt + STAGES - 1;
        if (nxt < nk) load_tile(nxt % STAGES, nxt);
        cp_async_commit();

        const int st = kt % STAGES;
        const XT* xs = xs_of(st) + (wm * WM + gq) * LDX + 2 * t4;
        const int8_t* ws = ws_of(st) + (wn * WN + gq) * LDW + 2 * t4;
        const float* ss = ss_of(st) + (wn * WN + gq) * SG;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            // fragment layouts of mma.m16n8k16 .bf16 (PTX ISA): a thread holds
            // rows gq and gq+8 at k = 2*t4, 2*t4+1 and 8 more of A, and
            // column gq at the same k of B
            unsigned af[MT][4], bf[NTL][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const XT* p = xs + i * 16 * LDX + kk;
                af[i][0] = x_pair(p);
                af[i][1] = x_pair(p + 8 * LDX);
                af[i][2] = x_pair(p + 8);
                af[i][3] = x_pair(p + 8 * LDX + 8);
            }
            const int slot = kk / g;  // this 16-wide step lies in one group
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
                const int8_t* p = ws + j * 8 * LDW + kk;
                const float sb = round_bf16(ss[j * 8 * SG + slot]);
                bf[j][0] = w_pair(p, sb);
                bf[j][1] = w_pair(p + 8, sb);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NTL; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
        }
    }
    cp_async_wait<0>();

    // epilogue: accumulator c[h*2+e] sits at row gq + 8h, column 2*t4 + e
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * WM + i * 16 + gq + 8 * h;
            if (row >= M) continue;
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn * WN + j * 8 + 2 * t4 + e;
                    if (col < N) store_as(out + (long long)row * N + col, acc[i][j][h * 2 + e]);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The prefill kernel (M > 16): k-tiles converted once per block into bf16
// shared memory, fragments by ldmatrix.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// 16 consecutive elements of x (16-byte aligned) as 8 bf16 pairs.
__device__ __forceinline__ void x_bf16x16(const float* p, uint4 (&o)[2]) {
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(p)[i];
        w[2 * i] = pack_bf16(v.x, v.y);
        w[2 * i + 1] = pack_bf16(v.z, v.w);
    }
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}
__device__ __forceinline__ void x_bf16x16(const __nv_bfloat16* p, uint4 (&o)[2]) {
    o[0] = reinterpret_cast<const uint4*>(p)[0];
    o[1] = reinterpret_cast<const uint4*>(p)[1];
}

// 16 int8 weights (16-byte aligned) dequantized with the bf16 scale sb.
__device__ __forceinline__ void w_bf16x16(const int8_t* p, float sb, uint4 (&o)[2]) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int word = words[i >> 1], sh = 16 * (i & 1);
        const float lo = static_cast<float>(static_cast<int8_t>(word >> sh)) * sb;
        const float hi = static_cast<float>(static_cast<int8_t>(word >> (sh + 8))) * sb;
        w[i] = pack_bf16(lo, hi);
    }
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename XT>
struct TcTile {
    static constexpr int BM = 128, BN = 128, BK = 32, WM = 64, WN = 32, STAGES = 3;
    static constexpr int kWarpsN = BN / WN;
    static constexpr int kThreads = (BM / WM) * kWarpsN * 32;  // 256
    static constexpr int kLdx = BK + 16 / static_cast<int>(sizeof(XT));  // raw x pitch
    static constexpr int kLdw = BK + 16;                                 // raw weight pitch
    static constexpr int kLdb = BK + 8;  // bf16 tile pitch: 80 bytes, conflict-free ldmatrix
    static constexpr int kSg = BK / 16;
    static constexpr int kStageBytes =
        BM * kLdx * static_cast<int>(sizeof(XT)) + BN * kLdw + BN * kSg * 4;
    static constexpr int kSmem = STAGES * kStageBytes + (BM + BN) * kLdb * 2;
};

template <typename XT, typename OT>
__global__ void __launch_bounds__(TcTile<XT>::kThreads)
q8_matmul_tc_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, OT* __restrict__ out, int M, int N, int Np,
                    int K, int g) {
    using C = TcTile<XT>;
    constexpr int BM = C::BM, BN = C::BN, BK = C::BK, WM = C::WM, WN = C::WN;
    constexpr int NT = C::kThreads, LDX = C::kLdx, LDW = C::kLdw, LDB = C::kLdb, SG = C::kSg;
    constexpr int STAGES = C::STAGES;
    constexpr int MT = WM / 16, NTL = WN / 8;
    constexpr int XV = 16 / static_cast<int>(sizeof(XT));
    extern __shared__ __align__(16) unsigned char smem[];
    auto xs_of = [&](int st) { return reinterpret_cast<XT*>(smem + st * C::kStageBytes); };
    auto ws_of = [&](int st) {
        return reinterpret_cast<int8_t*>(smem + st * C::kStageBytes + BM * LDX * sizeof(XT));
    };
    auto ss_of = [&](int st) {
        return reinterpret_cast<float*>(smem + st * C::kStageBytes + BM * LDX * sizeof(XT) +
                                        BN * LDW);
    };
    __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * C::kStageBytes);
    __nv_bfloat16* bb = ab + BM * LDB;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
    const int gq = lane >> 2, t4 = lane & 3;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nk = (K + BK - 1) / BK;
    const int KG = K / g;
    const int sg = BK >= g ? BK / g : 1;  // scales of one row in a k-tile

    auto load_tile = [&](int stage, int kt) {
        const int k0 = kt * BK;
        XT* xs = xs_of(stage);
        int8_t* ws = ws_of(stage);
        float* ss = ss_of(stage);
        constexpr int XC = BK / XV;
        for (int c = tid; c < BM * XC; c += NT) {
            const int r = c / XC, kc = (c % XC) * XV;
            const bool ok = m0 + r < M && k0 + kc < K;
            const XT* src = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
            cp_async16(xs + r * LDX + kc, src, ok ? 16 : 0);
        }
        constexpr int WC = BK / 16;
        for (int c = tid; c < BN * WC; c += NT) {
            const int r = c / WC, kc = (c % WC) * 16;
            const bool ok = n0 + r < Np && k0 + kc < K;
            const int8_t* src = ok ? q + (long long)(n0 + r) * K + k0 + kc : q;
            cp_async16(ws + r * LDW + kc, src, ok ? 16 : 0);
        }
        for (int c = tid; c < BN * sg; c += NT) {
            const int r = c / sg, j = c % sg;
            const int kg = k0 / g + j;
            if (n0 + r < Np && kg < KG)
                cp_async4(ss + r * SG + j, s + (long long)(n0 + r) * KG + kg);
            else
                ss[r * SG + j] = 0.f;
        }
    };

    // one k-tile, raw -> bf16: each thread converts 16 consecutive k of one
    // x row and 16 of one weight row (BK = 32: two threads per row)
    auto convert = [&](int stage, int kt) {
        const int r = tid >> 1, h = (tid & 1) * 16;
        uint4 o[2];
        x_bf16x16(xs_of(stage) + r * LDX + h, o);
        *reinterpret_cast<uint4*>(ab + r * LDB + h) = o[0];
        *reinterpret_cast<uint4*>(ab + r * LDB + h + 8) = o[1];
        const int slot = ((kt * BK + h) / g) - (kt * BK) / g;  // this 16-run lies in one group
        w_bf16x16(ws_of(stage) + r * LDW + h, round_bf16(ss_of(stage)[r * SG + slot]), o);
        *reinterpret_cast<uint4*>(bb + r * LDB + h) = o[0];
        *reinterpret_cast<uint4*>(bb + r * LDB + h + 8) = o[1];
    };

    float acc[MT][NTL][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nk) load_tile(st, st);
        cp_async_commit();
    }
    // ldmatrix row addresses: A rows lane % 16, k halves lane / 16; B (n-major
    // rows of k) n = lane % 8 + 8 * (lane / 16), k halves (lane / 8) % 2
    const __nv_bfloat16* a_ld = ab + (wm * WM + (lane & 15)) * LDB + (lane >> 4) * 8;
    const __nv_bfloat16* b_ld = bb + (wn * WN + (lane & 7) + ((lane >> 4) << 3)) * LDB +
                                ((lane >> 3) & 1) * 8;
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();  // k-tile kt has landed
        __syncthreads();              // ...for every thread; the bf16 tiles are free
        convert(kt % STAGES, kt);
        const int nxt = kt + STAGES - 1;
        if (nxt < nk) load_tile(nxt % STAGES, nxt);
        cp_async_commit();
        __syncthreads();  // the bf16 tiles are complete
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            unsigned af[MT][4], bf[NTL][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) ldsm_x4(af[i], a_ld + i * 16 * LDB + kk);
#pragma unroll
            for (int j = 0; j < NTL; j += 2) {
                unsigned r[4];
                ldsm_x4(r, b_ld + j * 8 * LDB + kk);
                bf[j][0] = r[0];
                bf[j][1] = r[1];
                bf[j + 1][0] = r[2];
                bf[j + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NTL; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * WM + i * 16 + gq + 8 * h;
            if (row >= M) continue;
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn * WN + j * 8 + 2 * t4 + e;
                    if (col < N) store_as(out + (long long)row * N + col, acc[i][j][h * 2 + e]);
                }
            }
        }
    }
}

template <typename XT, typename OT>
int launch_tc(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int Np,
              int K, int g, cudaStream_t st) {
    using C = TcTile<XT>;
    auto kern = q8_matmul_tc_kernel<XT, OT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::kThreads, C::kSmem, st>>>(static_cast<const XT*>(x), q, s,
                                              static_cast<OT*>(out), M, N, Np, K, g);
    return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename XT, typename OT>
int launch(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int Np,
           int K, int g, cudaStream_t st) {
    using C = Tile<BM, BN, BK, WM, WN, STAGES, XT>;
    auto kern = q8_matmul_kernel<BM, BN, BK, WM, WN, STAGES, XT, OT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    kern<<<grid, C::kThreads, C::kSmem, st>>>(static_cast<const XT*>(x), q, s,
                                              static_cast<OT*>(out), M, N, Np, K, g);
    return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int dispatch(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int Np,
             int K, int g, cudaStream_t st) {
    if (M <= 16) return launch<16, 32, 256, 16, 8, 4, XT, OT>(x, q, s, out, M, N, Np, K, g, st);
    return launch_tc<XT, OT>(x, q, s, out, M, N, Np, K, g, st);
}

}  // namespace

// x [M, K] (f32 or bf16, contiguous, 16-byte aligned), q int8 [Np, K], s
// f32 [Np, K / g], out [M, N] (f32 or bf16); the wrapper checks g in {16,
// 32, 64}, K % 128 == 0, K % g == 0 and N <= Np.
extern "C" int tl_q8_matmul(const void* x, int x_dtype, const int8_t* q, const float* s,
                            void* out, int out_dtype, int M, int N, int Np, int K, int g,
                            void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (K <= 0 || K % 128 || (g != 16 && g != 32 && g != 64) || N > Np)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_dtype == TL_F32 && out_dtype == TL_F32)
        return dispatch<float, float>(x, q, s, out, M, N, Np, K, g, st);
    if (x_dtype == TL_F32 && out_dtype == TL_BF16)
        return dispatch<float, __nv_bfloat16>(x, q, s, out, M, N, Np, K, g, st);
    if (x_dtype == TL_BF16 && out_dtype == TL_F32)
        return dispatch<__nv_bfloat16, float>(x, q, s, out, M, N, Np, K, g, st);
    if (x_dtype == TL_BF16 && out_dtype == TL_BF16)
        return dispatch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, M, N, Np, K, g, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
