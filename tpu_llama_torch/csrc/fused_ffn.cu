// K23: the tensor-parallel decode's FFN span of one layer on the local
// shard, in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:376 fused_ffn_stacked (its Pallas
// kernel _fused_ffn_kernel, fused_layer.py:332).  It is K11's phases B and
// C without the residual (fused_step2.cuh's streaming body, h2 in f32):
//
//   |  rmsnorm(x, rms_ffn[l]) -> int8 xq, sx       (blocks b < B, a row each)
//   B  g, u = local w13 gate / up columns j and Hl + j;
//      h2 = (g * (1 / (1 + exp(-g)))) * u  in f32; max |h2| per row
//   |  row quant of h2 -> int8 xq3                  (every block a slice)
//   C  out = (f32(xq3 . w2) * s3) * w2_s            the w2 PARTIAL
//
// The caller all-reduces the partial over the model axis and adds the
// residual.  Every f32 product and sum is K11's round-to-nearest intrinsic,
// the rmsnorm K3's (f64 sum of squares), the row quant K2's, so the plain
// version (ops/fused_layer.py) repeats it bit for bit.  Rows: any count in
// one launch, in groups of 32 one after another (the TPU kernel takes Bp %
// 32 == 0 rows in one block, and its TP path has no fallback).
//
// Bound on the H100: bytes.  At B <= 32 rows the layer's local weights are
// read once: w13 2 Hl x D and w2 D x Hl int8 -- at 7B, tp = 1, 135.3 MB,
// 40.4 us at 3.35 TB/s (tp = 2 / 4 / 8: 20.2 / 10.1 / 5.1 us).  Design:
// fused_step2.cuh's spans -- every block an equal share of both phases
// (whole row groups where they are as many as the blocks, else split along
// K with int32 partials and tickets) through a bulk-copy ring of 16-row x
// 2 KB units (above 8 rows, a phase's activations resident in shared
// memory where they fit, the ring weights only), counters in a workspace
// instead of grid barriers, and the entering row step in compact passes on
// the row blocks, whose rings start after it.
#include "fused_step2.cuh"

namespace {

template <int NT>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_ffn_kernel(const __grid_constant__ f2::Span s) {
    f2::span_body<NT>(s);
}

}  // namespace

// x f32 [B, D]; the layer's w13 int8 [2H, D] with f32 scales [2H], w2 int8
// [D, H] with f32 scales [D] (K-major views of the stacked local weights);
// rms [D] of dtype rms_dtype (f32 or bf16); out f32 [B, D]; scratch xq
// int8 [B, D], sx f32 [B], h2 f32 [B, H], xq3 int8 [B, H]; ws the int32
// workspace (ops/fused_layer.py span_layout words, zero between launches,
// left zero).  Any B >= 1.
extern "C" int tl_fused_ffn(const float* x, const int8_t* w13, const float* w13s,
                            const int8_t* w2, const float* w2s, const void* rms, int rms_dtype,
                            float* out, int8_t* xq, float* sx, float* h2, int8_t* xq3,
                            unsigned* ws, int B, int D, int H, void* stream) {
    if (B <= 0) return 0;
    if (rms_dtype != TL_F32 && rms_dtype != TL_BF16) return static_cast<int>(cudaErrorInvalidValue);
    f2::Span s{};
    fd::Linear& a = s.lay.lin;
    a.x = x;
    a.w13 = w13;
    a.w13s = w13s;
    a.w2 = w2;
    a.w2s = w2s;
    a.rms_ffn = rms;
    a.rms_bf16 = rms_dtype == TL_BF16;
    a.x_next = out;
    a.xq = xq;
    a.sx = sx;
    a.h2 = h2;
    a.xq3 = xq3;
    a.D = D;
    a.H = H;
    a.vec = D % 16 == 0 && H % 16 == 0 && fd::aligned16(xq) && fd::aligned16(xq3) &&
            fd::aligned16(w13) && fd::aligned16(w2);
    s.B = B;
    if (int err = f2::make_span(s, ws, f2::kW13, f2::kW2)) return err;
    return f2::span_launch(s, fused_ffn_kernel<1>, fused_ffn_kernel<4>, stream);
}

#ifdef FD_STAMPS
// The development stamps (fused_decode.cuh FD_STAMP) into host memory:
// n values of fd_stamps.
extern "C" int tl_fused_ffn_stamps(unsigned long long* out, int n) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, fd::fd_stamps, sizeof(unsigned long long) * n));
}
#endif
