// K27 (mega): one decode layer in one persistent cooperative launch, its
// attention LEADING its linear work.
//
// Replaces tpu_llama/ops/fused_step.py:313 fused_step_layer (its Pallas
// kernel _fused_step_kernel, fused_step.py:52-255).  One launch, K12's two
// halves in the other order (fused_step2.cuh):
//   cells:  one split cell (decode_split.cuh, K9's) per (slot, kv head,
//           split), grid-strided as K12's trailing cells (splits by
//           ops/fused_step2.py fused_splits; a split past its slot's rows is
//           skipped): layer l's attention over the cache rows s < pos[b],
//           then the step's fresh row (kq, ks, vq, vs, quantized between
//           launches) merged as one more column;
//   then blocks b < B quantize row b of the attention output over the
//           whole D row (fused_step.py:184-198) -> attq, satt, counted on
//           the layer's rows[2], which phase A's activations wait on;
//   then K11's phases A-D on fused_step2.cuh's streaming body, h2 in f32
//           (wo plus the residual, rmsnorm and quant, w13 and SiLU * up and
//           quant, w2 plus the residual, the next layer's rmsnorm, quant and
//           qkv).
// RoPE and quantize_kv of the fresh rows stay between launches, as in JAX
// (llama.py:1040-1047).  Rounding, read from the JAX kernel: qs = f32(q) /
// sqrt(f32(hd)), a true division (fused_step.py:372); the cache score is
// dot(bf16(qs), k) in f32 times ks; p = exp(s - m) is rounded as
// bf16(p * vs) before the PV dot (:158-162); the fresh row's score uses the
// unrounded qs (:168-178); the output is acc / max(l, 1e-30); the quant is
// rint(a * (1 / s)) with s = absmax * f32(1/127) (XLA's form of absmax /
// 127 inside jit, :184-198).  Those are K9's cell and K2's quant, so K27
// equals K9 (at the same splits), K2 and K11 launched in turn, bit for bit.
// At one split the cell is the sequential walk of common.cuh's dec_attend;
// at more, p rounds against each split's running max (K9's accepted
// departure).  The key block TS is the port's own (the wrapper's, K9's
// default of 128 rows); JAX's comes from a TPU VMEM plan
// (_pick_step_tiling, :298), and only the online softmax's rounding
// depends on it.
//
// Bound on the H100: bytes -- the layer's weights (202.4 MB at Llama-2 7B)
// plus the cache rows below each slot's position and their scales.
// Design: fused_step2.cuh's; the cells use the split cell's ring in the
// blocks' shared memory, then the phases their ring.  The weights need no
// attention, but bringing each block's wo units and first w13 unit into L2
// while the cells run (bulk prefetches) measured slower at every table
// shape on the H100, so the phases start from device memory.
#include "fused_step2.cuh"

namespace {

struct Step {
    f2::Step2 s;      // s.lay: layer l's phases, phase A waiting on its own flow's
                      // rows[2]; s.kq, s.ks, s.vq, s.vs: the step's fresh rows of
                      // layer l (inputs); s.attq_next, s.satt_next = s.lay.lin.attq,
                      // satt; s.layer = l; s.att: the cells' outputs
    const float* q;   // [B, KVH, G, hd] roped, unscaled
    float sqrt_hd;    // f32 sqrt(f32(hd))
};

// Layer l's attention: items (slot b, kv head h, split) grid-stride as
// K12's (f2::cell_of), each K9's split cell on the given q rows and fresh
// row; then blocks b < B quantize row b of the output (rows[2]).
template <int CH>
__device__ __noinline__ void lead_cells(const Step& a, unsigned char* smem) {
    const f2::Step2& s = a.s;
    const int B = s.lay.lin.B, KVH = s.KVH, G = s.G, hd = s.hd;
    const int P = dec_pitch<int8_t>(hd);
    const int items = B * KVH * s.splits;
    FD_STAMP(10);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int b, h, sp, p, live;
        long long row0;
        f2::cell_of(s, item, b, h, sp, p, row0, live);
        if (sp >= live) continue;
        const long long bh = (long long)b * KVH + h;
        const float* qh = a.q + bh * G * hd;
        const bool wrote = split_cell<int8_t, CH>(
            smem, s.nt, sp,
            [&](float* qf, float* qb) { dec_load_q(qh, qf, qb, G, hd, P, a.sqrt_hd); },
            s.kc + row0 * hd, s.vc + row0 * hd, s.kcs + row0, s.vcs + row0, p, s.S, s.TS, G, hd,
            s.splits, live, s.kq + bh * hd, s.ks[bh], s.vq + bh * hd, s.vs[bh],
            s.att + bh * G * hd, s.splits > 1 ? s.cws + bh * s.splits * (G * hd + 2 * G) : nullptr,
            s.splits > 1 ? s.cticket + bh : nullptr, DecDenseRows{s.TS});
        if (wrote) {
            f2::count_up(&s.lay.flow->cells);
        } else {
            __syncthreads();  // shared memory is free for the next item
        }
    }
    FD_STAMP(11);
    f2::quant_att_rows(s);
}

// NT batch tiles of 8 rows: 1 up to 8 rows, 4 up to 32.
template <int NT, int CH>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_step_kernel(const __grid_constant__ Step a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ f2::LayerShared S;
    f2::ring_init();
    if (threadIdx.x == 0) f2::fill_shared(S, a.s.lay);
    __syncthreads();
    lead_cells<CH>(a, smem);
    int q = 0;  // the ring's use count
    f2::layer_phases<NT, false>(S, smem, &q);
    f2::launch_exit(a.s.lay.ws);
}

template <int NT, int CH>
int launch(const Step& a, cudaStream_t st) {
    return fd::coop_launch(fused_step_kernel<NT, CH>, a, f2::step2_smem(a.s), st);
}

}  // namespace

// q f32 [B, KVH, G, hd]; the fresh rows nk, nv int8 [B, KVH, hd] with
// scales nks, nvs f32 [B, KVH]; the cache k, v int8 [L, B, KVH, S, hd] with
// scales ks, vs f32 [L, B, KVH, S], read only; pos int32 [B]; scratch att
// f32 [B, D]; outputs attq int8 [B, D] and satt f32 [B] (the quantized
// attention output); the cells' split partials cws and tickets cticket
// (ops/attention.py split_workspace; null at one split); layer l; TS | S,
// TS <= 256; splits; sqrt_hd = f32 sqrt(hd); ch as K12's.  Then
// tl_fused_layer_linear's arguments without attq and satt.  B <= 32.
extern "C" int tl_fused_step_layer(
    const float* q, const int8_t* nk, const int8_t* nv, const float* nks, const float* nvs,
    const int8_t* kc, const int8_t* vc, const float* kcs, const float* vcs, const int* pos,
    float* att, int8_t* attq, float* satt, float* cws, int* cticket, int KVH, int G, int hd,
    int S, int layer, int TS, int splits, float sqrt_hd, int ch, const float* x,
    const int8_t* wo, const float* wos, const int8_t* w13, const float* w13s, const int8_t* w2,
    const float* w2s, const int8_t* wqkv, const float* wqkvs, const void* rms_ffn,
    const void* rms_att, int rms_dtype, float* x_next, float* qkv, int8_t* xq, float* sx,
    float* h2, unsigned* ws, int B, int D, int H, int QO, int last, void* stream) {
    if (B <= 0) return 0;
    if (q == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    Step a{};
    f2::Step2& s = a.s;
    s.lay.lin = fd::Linear{x,  attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn,
                           rms_att, rms_dtype, x_next, qkv, xq, sx, h2, nullptr,
                           B, D, H, QO, last != 0, 0};
    s.kc = kc;
    s.vc = vc;
    s.kcs = kcs;
    s.vcs = vcs;
    s.pos = pos;
    s.att = att;
    s.attq_next = attq;
    s.satt_next = satt;
    s.kq = const_cast<int8_t*>(nk);
    s.ks = const_cast<float*>(nks);
    s.vq = const_cast<int8_t*>(nv);
    s.vs = const_cast<float*>(nvs);
    s.cws = cws;
    s.cticket = cticket;
    s.KVH = KVH;
    s.G = G;
    s.hd = hd;
    s.S = S;
    s.layer = layer;
    s.TS = TS;
    s.splits = splits;
    a.q = q;
    a.sqrt_hd = sqrt_hd;
    f2::Flow* flow = reinterpret_cast<f2::Flow*>(ws);
    if (int err = f2::make_step2(s, ws, flow, flow)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 8;
    if (ch == 16) return small ? launch<1, 16>(a, st) : launch<4, 16>(a, st);
    if (ch == 4) return small ? launch<1, 4>(a, st) : launch<4, 4>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef FD_STAMPS
// The development stamps (fused_decode.cuh FD_STAMP) into host memory:
// n values of fd_stamps.
extern "C" int tl_fused_step_stamps(unsigned long long* out, int n) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, fd::fd_stamps, sizeof(unsigned long long) * n));
}
#endif
