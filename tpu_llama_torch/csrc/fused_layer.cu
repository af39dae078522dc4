// K11: one decode layer's linear work in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:204 fused_layer_linear (its Pallas
// kernel _fused_layer_kernel, fused_layer.py:77).  Phases A-D and their
// boundaries are fused_decode.cuh's linear_phases: wo + residual, rmsnorm
// and row quant, w13 with SiLU in f32 (g * (1 / (1 + exp(-g))) * u, the TPU
// kernel's spelling, fused_layer.py:126), row quant, w2 + residual, then
// layer l + 1's rmsnorm, row quant and qkv.  The last layer stops after
// phase C and leaves qkv untouched (the TPU kernel pins that phase and
// returns garbage, fused_layer.py:217-221).
//
// Bound on the H100: bytes.  The layer's weights are read once: 202.4 MB at
// Llama-2 7B (wo 16.8 + w13 90.2 + w2 45.1 + wqkv 50.3), 60.4 us at 3.35
// TB/s; the last layer, without wqkv, 45.4 us.  Design: fused_decode.cuh.
// Compared with the unfused decode layer it replaces four K2 + K1 pairs and
// the plain rmsnorm, SiLU and residual chain (two dozen launches) by one.
#include "fused_decode.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(fd::kThreads) fused_layer_kernel(const fd::Linear a) {
    extern __shared__ __align__(16) int8_t smem[];
    fd::linear_phases<BM, false>(a, smem);
}

}  // namespace

// x, x_next f32 [B, D]; attq int8 [B, D], satt f32 [B]; the layer's weight
// views (see fd::Linear) and rms rows of dtype rms_dtype; qkv f32 [B, QO]
// (untouched when last != 0); scratch xq int8 [B, D], sx f32 [B], h2 f32
// [B, H], xq3 int8 [B, H], sx3 f32 [B]; bar two zeroed uint32.  B <= 32.
extern "C" int tl_fused_layer_linear(const float* x, const int8_t* attq, const float* satt,
                                     const int8_t* wo, const float* wos, const int8_t* w13,
                                     const float* w13s, const int8_t* w2, const float* w2s,
                                     const int8_t* wqkv, const float* wqkvs, const void* rms_ffn,
                                     const void* rms_att, int rms_dtype, float* x_next,
                                     float* qkv, int8_t* xq, float* sx, float* h2, int8_t* xq3,
                                     float* sx3, unsigned int* bar, int B, int D, int H, int QO,
                                     int last, void* stream) {
    if (B <= 0) return 0;
    fd::Linear a{x,  attq, satt, wo,  wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn,
                 rms_att, rms_dtype, x_next, qkv, xq, sx, h2, xq3, sx3, bar, B, D, H, QO,
                 last != 0, 0};
    if (int err = fd::prepare(a)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 16) return fd::coop_launch(fused_layer_kernel<16>, a, fd::gemm_smem<16>(), st);
    return fd::coop_launch(fused_layer_kernel<32>, a, fd::gemm_smem<32>(), st);
}
