// K24: the tensor-parallel decode's next-layer qkv projection on the local
// shard, in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:488 fused_rms_qkv_stacked (its
// Pallas kernel _rms_qkv_kernel, fused_layer.py:473).  It is K11's phase D
// and the boundary before it (fused_decode.cuh):
//
//   |  rmsnorm(x, rms_att[l]) -> int8 xq, sx                (one block per row)
//   D  qkv = (f32(xq . wqkv[l]) * sx) * qkv_s      the local [q_i | k_i | v_i]
//
// Every f32 product is a round-to-nearest intrinsic, the rmsnorm K3's (f64
// sum of squares) and the row quant K2's, so the plain version
// (ops/fused_layer.py) repeats it bit for bit.  Rows: any count, in GEMM
// tiles of 16 or 32 rows that walk the row blocks.
//
// Bound on the H100: bytes.  At B <= 32 rows the layer's local wqkv is read
// once: QOl x D int8 -- at 7B, tp = 1, 50.3 MB, 15.0 us at 3.35 TB/s.
// Design: fused_decode.cuh's tile and grid barrier, as K11.
#include "fused_decode.cuh"

namespace {

struct RmsQkv {
    const float* x;     // [B, D] the replicated residual stream
    const int8_t* w;    // [QO, D] the layer's local wqkv rows
    const float* ws;    // [QO]
    const void* rms;    // [D] rms_att[l], f32 or bf16
    int rms_bf16;
    float* out;         // [B, QO]
    int8_t* xq;         // [B, D] scratch
    float* sx;          // [B]
    unsigned int* bar;  // [2] grid barrier, zero between launches
    int B, D, QO, vec;
};

template <int BM>
__global__ void __launch_bounds__(fd::kThreads) fused_rms_qkv_kernel(const RmsQkv a) {
    extern __shared__ __align__(16) int8_t smem[];
    const int B = a.B, D = a.D, QO = a.QO;
    for (int r = blockIdx.x; r < B; r += gridDim.x)
        fd::rms_quant_row(a.x + (long long)r * D, a.rms, a.rms_bf16, D, a.xq + (long long)r * D,
                          a.sx + r);
    fd::grid_sync(a.bar);

    const int nrb = (B + BM - 1) / BM, nc = (QO + fd::kBN - 1) / fd::kBN;
    for (int t = blockIdx.x; t < nrb * nc; t += gridDim.x) {
        const int m0 = (t / nc) * BM, n0 = (t % nc) * fd::kBN;
        fd::gemm_tile<BM>(
            a.xq + (long long)m0 * D, min(BM, B - m0), D, a.vec,
            [&](int r) -> const int8_t* {
                return n0 + r < QO ? a.w + (long long)(n0 + r) * D : nullptr;
            },
            [&](int row, int c, int acc0, int acc1) {
                const int acc[2] = {acc0, acc1};
                const int m = m0 + row;
                const float s = __ldcg(a.sx + m);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + c + e;
                    if (n < QO)
                        a.out[(long long)m * QO + n] =
                            __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), s), a.ws[n]);
                }
            },
            smem);
    }
}

}  // namespace

// x f32 [B, D]; the layer's wqkv int8 [QO, D] with f32 scales [QO] (a
// K-major view of the stacked local weights); rms [D] of dtype rms_dtype
// (f32 or bf16); out f32 [B, QO]; scratch xq int8 [B, D], sx f32 [B]; bar
// two zeroed uint32.  Any B >= 1.
extern "C" int tl_fused_rms_qkv(const float* x, const int8_t* w, const float* ws, const void* rms,
                                int rms_dtype, float* out, int8_t* xq, float* sx,
                                unsigned int* bar, int B, int D, int QO, void* stream) {
    if (B <= 0) return 0;
    if (D < 1 || QO < 1 || (rms_dtype != TL_F32 && rms_dtype != TL_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    RmsQkv a{x, w, ws, rms, rms_dtype == TL_BF16, out, xq, sx, bar, B, D, QO, 0};
    a.vec = D % 16 == 0 && fd::aligned16(xq) && fd::aligned16(w);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 16) return fd::coop_launch(fused_rms_qkv_kernel<16>, a, fd::gemm_smem<16>(), st);
    return fd::coop_launch(fused_rms_qkv_kernel<32>, a, fd::gemm_smem<32>(), st);
}
