// K27 (mega): one decode layer in one persistent cooperative launch, its
// attention LEADING its linear work.
//
// Replaces tpu_llama/ops/fused_step.py:313 fused_step_layer (its Pallas
// kernel _fused_step_kernel, fused_step.py:52-255).  One launch:
//   cells:  one per (slot, kv head), grid-strided: layer l's attention over
//           the cache rows s < pos[b] in blocks of TS, then the step's fresh
//           row (kq, ks, vq, vs, quantized between launches) merged as one
//           more column -- common.cuh's dec_attend, K9's cell;
//   barrier, then one block per row quantizes the attention output over the
//           whole D row (fused_step.py:184-198) -> attq, satt;
//   barrier, then K11's phases A-D (fused_decode.cuh linear_phases: wo plus
//           the residual, rmsnorm and quant, w13 and SiLU * up and quant, w2
//           plus the residual, the next layer's rmsnorm, quant and qkv).
// RoPE and quantize_kv of the fresh rows stay between launches, as in JAX
// (llama.py:1040-1047).  Rounding, read from the JAX kernel: qs = f32(q) /
// sqrt(f32(hd)), a true division (fused_step.py:372); the cache score is
// dot(bf16(qs), k) in f32 times ks; p = exp(s - m) is rounded as
// bf16(p * vs) before the PV dot (:158-162); the fresh row's score uses the
// unrounded qs (:168-178); the output is acc / max(l, 1e-30); the quant is
// rint(a * (1 / s)) with s = absmax * f32(1/127) (XLA's form of absmax /
// 127 inside jit, :184-198).  Those are K9's cell and K2's quant, so K27
// equals K9, K2 and K11 launched in turn, bit for bit, at the same key
// block.  The key block TS is the port's own (the wrapper's, K9's default
// of 128 rows); JAX's comes from a TPU VMEM plan (_pick_step_tiling,
// :298), and only the online softmax's rounding depends on it.
//
// Bound on the H100: bytes -- the layer's weights (202.4 MB at Llama-2 7B)
// plus the cache rows below each slot's position and their scales.  Design:
// the cells run in the blocks of the cooperative launch before the weight
// phases (the TPU kernel's first B grid steps); nothing overlaps the cache
// reads with the weight streams yet.
#include "fused_decode.cuh"

namespace {

struct Step {
    fd::Linear lin;        // lin.attq, lin.satt: the quantized attention output below
    const float* q;        // [B, KVH, G, hd] roped, unscaled
    const int8_t* nk;      // [B, KVH, hd] the step's fresh rows of layer l
    const int8_t* nv;
    const float* nks;      // [B, KVH]
    const float* nvs;
    const int8_t* kc;      // [L, B, KVH, S, hd] int8 cache, read only
    const int8_t* vc;
    const float* kcs;      // [L, B, KVH, S] scales
    const float* vcs;
    const int* pos;        // [B]
    float* att;            // [B, D] scratch: the cells' outputs
    int8_t* attq;          // [B, D] = lin.attq
    float* satt;           // [B] = lin.satt
    int KVH, G, hd, S, layer, TS;
    float sqrt_hd;         // f32 sqrt(f32(hd))
};

template <int BM, int CH>
__global__ void __launch_bounds__(fd::kThreads) fused_step_kernel(const Step a) {
    extern __shared__ __align__(16) unsigned char fd_smem[];
    const int B = a.lin.B, D = a.lin.D, KVH = a.KVH, G = a.G, hd = a.hd;
    const int P = dec_pitch<int8_t>(hd);
    const DecSmem<int8_t> sm(fd_smem, a.TS, P, G);
    for (int cell = blockIdx.x; cell < B * KVH; cell += gridDim.x) {
        const int b = cell / KVH, h = cell % KVH;
        const long long bh = (long long)b * KVH + h;
        dec_load_q(a.q + bh * G * hd, sm.qf, sm.qb, G, hd, P, a.sqrt_hd);
        const int p = min(max(a.pos[b], 0), a.S);
        const long long row0 = (((long long)a.layer * B + b) * KVH + h) * a.S;
        dec_attend<int8_t, CH>(sm, a.kc + row0 * hd, a.vc + row0 * hd, a.kcs + row0,
                               a.vcs + row0, p, a.TS, G, hd, a.nk + bh * hd, a.nks[bh],
                               a.nv + bh * hd, a.nvs[bh], a.att + bh * G * hd);
        __syncthreads();  // shared memory is free for the next cell
    }
    fd::grid_sync(a.lin.bar);  // every cell's output is in att
    if (blockIdx.x < B)
        fd::quant_row(a.att + (long long)blockIdx.x * D, D, a.attq + (long long)blockIdx.x * D,
                      a.satt + blockIdx.x);
    fd::grid_sync(a.lin.bar);  // attq and satt are complete
    fd::linear_phases<BM, false>(a.lin, reinterpret_cast<int8_t*>(fd_smem));
}

template <int BM, int CH>
int launch(const Step& a, cudaStream_t st) {
    const int cell = DecSmem<int8_t>::bytes(a.TS, dec_pitch<int8_t>(a.hd), a.G);
    const int smem = fd::gemm_smem<BM>() > cell ? fd::gemm_smem<BM>() : cell;
    return fd::coop_launch(fused_step_kernel<BM, CH>, a, smem, st);
}

}  // namespace

// q f32 [B, KVH, G, hd]; the fresh rows nk, nv int8 [B, KVH, hd] with
// scales nks, nvs f32 [B, KVH]; the cache k, v int8 [L, B, KVH, S, hd] with
// scales ks, vs f32 [L, B, KVH, S]; pos int32 [B]; scratch att f32 [B, D];
// outputs attq int8 [B, D] and satt f32 [B] (the quantized attention
// output); layer l; TS | S, TS <= 256; sqrt_hd = f32 sqrt(hd); ch as K12's.
// Then tl_fused_layer_linear's arguments without attq and satt.  B <= 32.
extern "C" int tl_fused_step_layer(
    const float* q, const int8_t* nk, const int8_t* nv, const float* nks, const float* nvs,
    const int8_t* kc, const int8_t* vc, const float* kcs, const float* vcs, const int* pos,
    float* att, int8_t* attq, float* satt, int KVH, int G, int hd, int S, int layer, int TS,
    float sqrt_hd, int ch, const float* x, const int8_t* wo, const float* wos,
    const int8_t* w13, const float* w13s, const int8_t* w2, const float* w2s, const int8_t* wqkv,
    const float* wqkvs, const void* rms_ffn, const void* rms_att, int rms_dtype, float* x_next,
    float* qkv, int8_t* xq, float* sx, float* h2, int8_t* xq3, float* sx3, unsigned int* bar,
    int B, int D, int H, int QO, int last, void* stream) {
    if (B <= 0) return 0;
    if (G < 1 || G > kDecMaxG || hd < 1 || hd > kDecMaxHd || TS < 1 || TS > 256 || KVH < 1 ||
        D != KVH * G * hd || QO != D + 2 * KVH * hd)
        return static_cast<int>(cudaErrorInvalidValue);
    Step a{{x, attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn, rms_att, rms_dtype,
            x_next, qkv, xq, sx, h2, xq3, sx3, bar, B, D, H, QO, last != 0, 0},
           q, nk, nv, nks, nvs, kc, vc, kcs, vcs, pos, att, attq, satt, KVH, G, hd, S, layer, TS,
           sqrt_hd};
    if (int err = fd::prepare(a.lin)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 16;
    if (ch == 16) return small ? launch<16, 16>(a, st) : launch<32, 16>(a, st);
    if (ch == 4) return small ? launch<16, 4>(a, st) : launch<32, 4>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
