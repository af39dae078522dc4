// K12 (mega2): layer l's linear work and layer l + 1's attention in one
// persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_step2.py:537 fused_step2_layer (its Pallas
// kernel _fused_step2_kernel, fused_step2.py:113, and the XLA epilogue
// :714-737).  Phases A-D (wo + residual, rmsnorm and row quant, w13 with
// SiLU and h2 rounded to bf16 before its quant, :217-224, w2 + residual,
// then layer l + 1's rmsnorm, row quant and qkv), then one split cell per
// (slot, kv head, split) of layer l + 1 and the quant of the attention
// output, inside the launch: fused_step2.cuh's step2_layer, which K26 runs
// twice per launch.  RoPE per pair is x0 c - x1 s and x0 s + x1 c; the TPU
// kernel's roll form adds only exact zeros to that (:70-88).
//
// Bound on the H100: bytes.  The layer's 202.4 MB of 7B weights plus the
// cache rows below each slot's position and their scales (batch 8 with
// every slot at position 512: 34.6 MB; 70.7 us in all at 3.35 TB/s).
// Design: fused_step2.cuh.  The TPU's DMA descriptor chain (:497-515) is
// not carried: a cell computes its cache offsets from pos, and each block
// prefetches its first cell's first key rows into L2 behind phase D, as
// the TPU kernel starts its first cache blocks behind the weight phases
// (:183-189).
#include "fused_step2.cuh"

namespace {

// NT batch tiles of 8 rows: 1 up to 8 rows, 4 up to 32.
template <int NT, int CH>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_step2_kernel(const __grid_constant__ f2::Step2 a) {
    extern __shared__ __align__(16) unsigned char smem[];
    f2::ring_init();
    int q = 0;  // the ring's use count
    f2::step2_layer<NT, CH>(a, smem, &q);
    f2::launch_exit(a.lay.ws);
}

template <int NT, int CH>
int launch(const f2::Step2& a, cudaStream_t st) {
    return fd::coop_launch(fused_step2_kernel<NT, CH>, a, f2::step2_smem(a), st);
}

template <int NT, int CH>
int residency(const f2::Step2& a, int* per_sm) {
    return static_cast<int>(
        fd::resident_blocks(fused_step2_kernel<NT, CH>, f2::step2_smem(a), per_sm));
}

}  // namespace

// Into *per_sm: the blocks of K12 that one SM keeps resident for a launch
// of B rows, G query heads per kv head, head_dim hd, key block TS and copy
// chunk ch -- the grid K26 (fused_step3.cu) runs on, per SM.
extern "C" int tl_fused_step2_residency(int B, int G, int hd, int TS, int ch, int* per_sm) {
    f2::Step2 a{};
    a.G = G;
    a.hd = hd;
    a.TS = TS;
    a.lay.lin.B = B;
    a.nt = f2::cell_tiles(TS, dec_pitch<int8_t>(hd), G);
    if (a.nt == 0 || B < 1 || B > fd::kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    const bool small = B <= 8;
    if (ch == 16) return small ? residency<1, 16>(a, per_sm) : residency<4, 16>(a, per_sm);
    if (ch == 4) return small ? residency<1, 4>(a, per_sm) : residency<4, 4>(a, per_sm);
    return static_cast<int>(cudaErrorInvalidValue);
}

// x f32 [B, D], attq int8 [B, D], satt f32 [B]; the layer's weight views
// wo, w13, w2 (layer l) and wqkv (layer l + 1) with their f32 column
// scales; rms_ffn (layer l), rms_att (layer l + 1) of dtype rms_dtype;
// x_next f32 [B, D]; scratch qkv f32 [B, QO], xq int8 [B, D], sx f32 [B],
// h2 f32 [B, H]; ws the int32 workspace (ops/fused_step2.py
// step2_workspace_words words, zero between launches, left zero); last
// (l = L - 1: phases A-C only); the cache k, v int8 [L, B, KVH, S, hd] and
// scales ks, vs f32 [L, B, KVH, S]; pos int32 [B]; cos, sin f32 [B, hd/2];
// scratch att f32 [B, D]; outputs attq_next int8 [B, D], satt_next f32
// [B], kq, vq int8 [B, KVH, hd], ksn, vsn f32 [B, KVH]; the cells' split
// partials cws and tickets cticket (ops/attention.py split_workspace; null
// at one split); layer = l + 1; TS the cells' key block; splits; ch: 16
// promises hd % 16 == 0 and 16-byte aligned k/v, 4 promises hd % 4 == 0.
extern "C" int tl_fused_step2_layer(
    const float* x, const int8_t* attq, const float* satt, const int8_t* wo, const float* wos,
    const int8_t* w13, const float* w13s, const int8_t* w2, const float* w2s, const int8_t* wqkv,
    const float* wqkvs, const void* rms_ffn, const void* rms_att, int rms_dtype, float* x_next,
    float* qkv, int8_t* xq, float* sx, float* h2, unsigned* ws, int B, int D, int H, int QO,
    int last, const int8_t* kc, const int8_t* vc, const float* kcs, const float* vcs,
    const int* pos, const float* cosr, const float* sinr, float* att, int8_t* attq_next,
    float* satt_next, int8_t* kq, float* ksn, int8_t* vq, float* vsn, float* cws, int* cticket,
    int KVH, int G, int hd, int S, int layer, int TS, int splits, float isqrt, int ch,
    void* stream) {
    if (B <= 0) return 0;
    f2::Step2 a{};
    a.lay.lin = fd::Linear{x,  attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn,
                           rms_att, rms_dtype, x_next, qkv, xq, sx, h2, nullptr,
                           B, D, H, QO, last != 0, 0};
    a.kc = kc;
    a.vc = vc;
    a.kcs = kcs;
    a.vcs = vcs;
    a.pos = pos;
    a.cosr = cosr;
    a.sinr = sinr;
    a.att = att;
    a.attq_next = attq_next;
    a.satt_next = satt_next;
    a.kq = kq;
    a.ks = ksn;
    a.vq = vq;
    a.vs = vsn;
    a.cws = cws;
    a.cticket = cticket;
    a.KVH = KVH;
    a.G = G;
    a.hd = hd;
    a.S = S;
    a.layer = layer;
    a.TS = TS;
    a.splits = splits;
    a.isqrt = isqrt;
    if (int err = f2::make_step2(a, ws, reinterpret_cast<f2::Flow*>(ws), nullptr)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 8;
    if (ch == 16) return small ? launch<1, 16>(a, st) : launch<4, 16>(a, st);
    if (ch == 4) return small ? launch<1, 4>(a, st) : launch<4, 4>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef FD_STAMPS
// The development stamps (fused_decode.cuh FD_STAMP) into host memory:
// n values of fd_stamps.
extern "C" int tl_fused_step2_stamps(unsigned long long* out, int n) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, fd::fd_stamps, sizeof(unsigned long long) * n));
}
#endif
