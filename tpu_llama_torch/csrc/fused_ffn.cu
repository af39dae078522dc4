// K23: the tensor-parallel decode's FFN span of one layer on the local
// shard, in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:376 fused_ffn_stacked (its Pallas
// kernel _fused_ffn_kernel, fused_layer.py:332).  It is K11's phases B and
// C (fused_decode.cuh) without the residual and without phases A and D:
//
//   |  rmsnorm(x, rms_ffn[l]) -> int8 xq, sx              (one block per row)
//   B  g, u = local w13 gate / up columns j and Hl + j;
//      h2 = (g * (1 / (1 + exp(-g)))) * u  in f32
//   |  row quant of h2 -> int8 xq3, sx3
//   C  out = (f32(xq3 . w2) * sx3) * w2_s                  the w2 PARTIAL
//
// The caller all-reduces the partial over the model axis and adds the
// residual.  Every f32 product and sum is K11's round-to-nearest intrinsic,
// the rmsnorm K3's (f64 sum of squares), the row quant K2's, so the plain
// version (ops/fused_layer.py) repeats it bit for bit.  Rows: any count; a
// GEMM tile takes 16 or 32 of them and the tiles walk the row blocks, the
// boundaries one block per row (the TPU kernel takes Bp % 32 == 0 rows in
// one block, and its TP path has no fallback).
//
// Bound on the H100: bytes.  At B <= 32 rows the layer's local weights are
// read once: w13 2 Hl x D and w2 D x Hl int8 -- at 7B, tp = 1, 135.3 MB,
// 40.4 us at 3.35 TB/s (tp = 2: 20.2 us).  Design: fused_decode.cuh's tile
// (32 weight rows over the whole K, mma.sync m16n8k32 s8, a four-stage
// cp.async ring) and grid barrier, as K11.
#include "fused_decode.cuh"

namespace {

struct Ffn {
    const float* x;       // [B, D] the replicated residual stream
    const int8_t* w13;    // [2H, D] the layer's local gate rows, then up rows
    const float* w13s;    // [2H]
    const int8_t* w2;     // [D, H] the layer's local w2 rows
    const float* w2s;     // [D]
    const void* rms;      // [D] rms_ffn[l], f32 or bf16
    int rms_bf16;
    float* out;           // [B, D] the w2 partial
    int8_t* xq;           // [B, D] scratch
    float* sx;            // [B]
    float* h2;            // [B, H]
    int8_t* xq3;          // [B, H]
    float* sx3;           // [B]
    unsigned int* bar;    // [2] grid barrier, zero between launches
    int B, D, H, vec;
};

template <int BM>
__global__ void __launch_bounds__(fd::kThreads) fused_ffn_kernel(const Ffn a) {
    extern __shared__ __align__(16) int8_t smem[];
    const int B = a.B, D = a.D, H = a.H;
    for (int r = blockIdx.x; r < B; r += gridDim.x)
        fd::rms_quant_row(a.x + (long long)r * D, a.rms, a.rms_bf16, D, a.xq + (long long)r * D,
                          a.sx + r);
    fd::grid_sync(a.bar);

    // B: gate column j and up column H + j in one tile, as K11
    const int nrb = (B + BM - 1) / BM, nb = (H + fd::kBN / 2 - 1) / (fd::kBN / 2);
    for (int t = blockIdx.x; t < nrb * nb; t += gridDim.x) {
        const int m0 = (t / nb) * BM, j0 = (t % nb) * (fd::kBN / 2);
        fd::gemm_tile<BM>(
            a.xq + (long long)m0 * D, min(BM, B - m0), D, a.vec,
            [&](int r) -> const int8_t* {
                const int j = j0 + (r >> 1);
                return j < H ? a.w13 + ((long long)(r & 1) * H + j) * D : nullptr;
            },
            [&](int row, int c, int ga, int ua) {
                const int j = j0 + (c >> 1);
                if (j >= H) return;
                const int m = m0 + row;
                const float s = __ldcg(a.sx + m);
                const float gv = __fmul_rn(__fmul_rn(static_cast<float>(ga), s), a.w13s[j]);
                const float uv = __fmul_rn(__fmul_rn(static_cast<float>(ua), s), a.w13s[H + j]);
                a.h2[(long long)m * H + j] =
                    __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.f, expf(-gv)))), uv);
            },
            smem);
    }
    fd::grid_sync(a.bar);
    for (int r = blockIdx.x; r < B; r += gridDim.x)
        fd::quant_row(a.h2 + (long long)r * H, H, a.xq3 + (long long)r * H, a.sx3 + r);
    fd::grid_sync(a.bar);

    // C: out = (f32(xq3 . w2) * sx3) * w2_s
    const int nc = (D + fd::kBN - 1) / fd::kBN;
    for (int t = blockIdx.x; t < nrb * nc; t += gridDim.x) {
        const int m0 = (t / nc) * BM, n0 = (t % nc) * fd::kBN;
        fd::gemm_tile<BM>(
            a.xq3 + (long long)m0 * H, min(BM, B - m0), H, a.vec,
            [&](int r) -> const int8_t* {
                return n0 + r < D ? a.w2 + (long long)(n0 + r) * H : nullptr;
            },
            [&](int row, int c, int acc0, int acc1) {
                const int acc[2] = {acc0, acc1};
                const int m = m0 + row;
                const float s = __ldcg(a.sx3 + m);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + c + e;
                    if (n < D)
                        a.out[(long long)m * D + n] =
                            __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), s), a.w2s[n]);
                }
            },
            smem);
    }
}

}  // namespace

// x f32 [B, D]; the layer's w13 int8 [2H, D] with f32 scales [2H], w2 int8
// [D, H] with f32 scales [D] (K-major views of the stacked local weights);
// rms [D] of dtype rms_dtype (f32 or bf16); out f32 [B, D]; scratch xq
// int8 [B, D], sx f32 [B], h2 f32 [B, H], xq3 int8 [B, H], sx3 f32 [B]; bar
// two zeroed uint32.  Any B >= 1.
extern "C" int tl_fused_ffn(const float* x, const int8_t* w13, const float* w13s,
                            const int8_t* w2, const float* w2s, const void* rms, int rms_dtype,
                            float* out, int8_t* xq, float* sx, float* h2, int8_t* xq3, float* sx3,
                            unsigned int* bar, int B, int D, int H, void* stream) {
    if (B <= 0) return 0;
    if (D < 1 || H < 1 || (rms_dtype != TL_F32 && rms_dtype != TL_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    Ffn a{x, w13, w13s, w2, w2s, rms, rms_dtype == TL_BF16, out, xq, sx, h2, xq3, sx3, bar,
          B, D, H, 0};
    a.vec = D % 16 == 0 && H % 16 == 0 && fd::aligned16(xq) && fd::aligned16(xq3) &&
            fd::aligned16(w13) && fd::aligned16(w2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 16) return fd::coop_launch(fused_ffn_kernel<16>, a, fd::gemm_smem<16>(), st);
    return fd::coop_launch(fused_ffn_kernel<32>, a, fd::gemm_smem<32>(), st);
}
