// K11: one decode layer's linear work in one persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_layer.py:204 fused_layer_linear (its Pallas
// kernel _fused_layer_kernel, fused_layer.py:77).  Phases A-D and their
// boundaries: wo + residual, rmsnorm and row quant, w13 with SiLU in f32
// (g * (1 / (1 + exp(-g))) * u, the TPU kernel's spelling, fused_layer.py:126;
// h2 not rounded, :118-126), row quant, w2 + residual, then layer l + 1's
// rmsnorm, row quant and qkv.  The last layer stops after phase C and leaves
// qkv untouched (the TPU kernel pins that phase and returns garbage,
// fused_layer.py:217-221).
//
// Bound on the H100: bytes.  The layer's weights are read once: 202.4 MB at
// Llama-2 7B (wo 16.8 + w13 90.2 + w2 45.1 + wqkv 50.3), 60.4 us at 3.35
// TB/s; the last layer, without wqkv, 45.4 us.  Design: fused_step2.cuh's
// streaming body (layer_phases with h2 in f32) -- every block an equal share
// of every phase through a bulk-copy ring, wo and w2 split along K with
// int32 partials and tickets, counters in a workspace for the grid barriers
// -- without cells: the launch is the layer's phases and the exit that sets
// the counters back to zero, on two blocks an SM (kPerSm).  K12 runs the
// same phases with h2 in bf16, so the two share one workspace per stream
// and widths.
#include "fused_step2.cuh"

namespace {

// NT batch tiles of 8 rows: 1 up to 8 rows, 4 up to 32.
template <int NT>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_layer_kernel(const __grid_constant__ f2::Layer a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ f2::LayerShared S;
    f2::ring_init();
    if (threadIdx.x == 0) f2::fill_shared(S, a);
    __syncthreads();
    int q = 0;  // the ring's use count
    f2::layer_phases<NT, false>(S, smem, &q);
    f2::launch_exit(a.ws);
}

// Blocks an SM: two (above 8 rows, all that fit; up to 8 rows, where four
// fit, no cells need them).  Two keep half the bytes in flight of four,
// which still feed device memory, and every round trip (a row step's loads,
// a ticket, a counter) waits behind fewer of them: on the H100, K11 at
// batch 8 measured faster at two than at three, and at three than at four.
constexpr int kPerSm = 2;

template <int NT>
int launch(const f2::Layer& a, cudaStream_t st) {
    return fd::coop_launch(fused_layer_kernel<NT>, a, f2::kStagesU * f2::stage_bytes(NT), st,
                           kPerSm);
}

}  // namespace

// x, x_next f32 [B, D]; attq int8 [B, D], satt f32 [B]; the layer's weight
// views (see fd::Linear) and rms rows of dtype rms_dtype; qkv f32 [B, QO]
// (untouched when last != 0); scratch xq int8 [B, D], sx f32 [B], h2 f32
// [B, H]; ws the int32 workspace (ops/fused_step2.py step2_workspace_words
// words, zero between launches, left zero but for h2 quantized).  B <= 32.
extern "C" int tl_fused_layer_linear(const float* x, const int8_t* attq, const float* satt,
                                     const int8_t* wo, const float* wos, const int8_t* w13,
                                     const float* w13s, const int8_t* w2, const float* w2s,
                                     const int8_t* wqkv, const float* wqkvs, const void* rms_ffn,
                                     const void* rms_att, int rms_dtype, float* x_next,
                                     float* qkv, int8_t* xq, float* sx, float* h2, unsigned* ws,
                                     int B, int D, int H, int QO, int last, void* stream) {
    if (B <= 0) return 0;
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    f2::Layer a{};
    a.lin = fd::Linear{x,  attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn,
                       rms_att, rms_dtype, x_next, qkv, xq, sx, h2, nullptr,
                       B, D, H, QO, last != 0, 0};
    if (int err = fd::prepare(a.lin)) return err;
    a.ws = ws;
    a.flow = reinterpret_cast<f2::Flow*>(ws);
    a.wait_a = nullptr;
    f2::make_phases(a, ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return B <= 8 ? launch<1>(a, st) : launch<4>(a, st);
}

#ifdef FD_STAMPS
// The development stamps (fused_decode.cuh FD_STAMP) into host memory:
// n values of fd_stamps.
extern "C" int tl_fused_layer_stamps(unsigned long long* out, int n) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, fd::fd_stamps, sizeof(unsigned long long) * n));
}
#endif
