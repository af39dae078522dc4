// K24: the tensor-parallel decode's next-layer qkv projection on the local
// shard, in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:488 fused_rms_qkv_stacked (its
// Pallas kernel _rms_qkv_kernel, fused_layer.py:473).  It is K11's phase D
// and the row step before it (fused_step2.cuh's streaming body):
//
//   |  rmsnorm(x, rms_att[l]) -> int8 xq, sx       (blocks b < B, a row each)
//   D  qkv = (f32(xq . wqkv[l]) * sx) * qkv_s      the local [q_i | k_i | v_i]
//
// Every f32 product is a round-to-nearest intrinsic, the rmsnorm K3's (f64
// sum of squares) and the row quant K2's, so the plain version
// (ops/fused_layer.py) repeats it bit for bit.  Rows: any count in one
// launch, in groups of 32 one after another.
//
// Bound on the H100: bytes.  At B <= 32 rows the layer's local wqkv is read
// once: QOl x D int8 -- at 7B, tp = 1, 50.3 MB, 15.0 us at 3.35 TB/s (tp =
// 8: 1.9 us).  Design: fused_step2.cuh's spans, as K23's -- every block an
// equal share of phase D through the bulk-copy ring (whole row groups where
// they are as many as the blocks, else split along K with int32 partials
// and tickets; above 8 rows the activations resident, the ring weights
// only), the row step first on the row blocks.
#include "fused_step2.cuh"

namespace {

template <int NT>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_rms_qkv_kernel(const __grid_constant__ f2::Span s) {
    f2::span_body<NT>(s);
}

}  // namespace

// x f32 [B, D]; the layer's wqkv int8 [QO, D] with f32 scales [QO] (a
// K-major view of the stacked local weights); rms [D] of dtype rms_dtype
// (f32 or bf16); out f32 [B, QO]; scratch xq int8 [B, D], sx f32 [B]; ws
// the int32 workspace (ops/fused_layer.py span_layout words, zero between
// launches, left zero).  Any B >= 1.
extern "C" int tl_fused_rms_qkv(const float* x, const int8_t* w, const float* wsc, const void* rms,
                                int rms_dtype, float* out, int8_t* xq, float* sx, unsigned* ws,
                                int B, int D, int QO, void* stream) {
    if (B <= 0) return 0;
    if (rms_dtype != TL_F32 && rms_dtype != TL_BF16) return static_cast<int>(cudaErrorInvalidValue);
    f2::Span s{};
    fd::Linear& a = s.lay.lin;
    a.x = x;
    a.wqkv = w;
    a.wqkvs = wsc;
    a.rms_att = rms;
    a.rms_bf16 = rms_dtype == TL_BF16;
    a.qkv = out;
    a.xq = xq;
    a.sx = sx;
    a.D = D;
    a.QO = QO;
    a.vec = D % 16 == 0 && fd::aligned16(xq) && fd::aligned16(w);
    s.B = B;
    if (int err = f2::make_span(s, ws, f2::kQkv, f2::kQkv)) return err;
    return f2::span_launch(s, fused_rms_qkv_kernel<1>, fused_rms_qkv_kernel<4>, stream);
}

#ifdef FD_STAMPS
// The development stamps (fused_decode.cuh FD_STAMP) into host memory:
// n values of fd_stamps.
extern "C" int tl_fused_rms_qkv_stamps(unsigned long long* out, int n) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, fd::fd_stamps, sizeof(unsigned long long) * n));
}
#endif
