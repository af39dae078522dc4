// K12 (mega2): layer l's linear work and layer l + 1's attention in one
// persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_step2.py:537 fused_step2_layer (its Pallas
// kernel _fused_step2_kernel, fused_step2.py:113, and the XLA epilogue
// :714-737).  After K11's phases (fused_decode.cuh, with h2 rounded to bf16
// before its quant, fused_step2.py:217-224), a barrier, then one cell per
// (slot, kv head) of layer l + 1 and the quant of the attention output,
// inside the launch: fused_decode.cuh's step2_layer, which K26 runs twice
// per launch.  RoPE per pair is x0 c - x1 s and x0 s + x1 c; the TPU
// kernel's roll form adds only exact zeros to that (:70-88).
//
// Bound on the H100: bytes.  The layer's 202.4 MB of 7B weights plus the
// cache rows below each slot's position and their scales (batch 8 with
// every slot at position 512: 34.6 MB; 70.7 us in all at 3.35 TB/s).
// Design: fused_decode.cuh for the phases; the cells grid-stride over the
// same blocks (B * KVH cells: 256 at 7B batch 8), each computing its own
// cache offsets from pos, with K9's two-stage cp.async ring.  The TPU's DMA
// descriptor chain and its prefetch of the first cache blocks behind the
// weight phases (fused_step2.py:183-189, :497-515) are not carried: a
// prefetch is later work.
#include "fused_decode.cuh"

namespace {

template <int BM, int CH>
int launch(const fd::Step2& a, cudaStream_t st) {
    return fd::coop_launch(fd::fused_step2_kernel<BM, CH>, a, fd::step2_smem<BM>(a), st);
}

template <int BM, int CH>
int residency(const fd::Step2& a, int* per_sm) {
    return static_cast<int>(
        fd::resident_blocks(fd::fused_step2_kernel<BM, CH>, fd::step2_smem<BM>(a), per_sm));
}

}  // namespace

// Into *per_sm: the blocks of K12 that one SM keeps resident for a launch
// of B rows, G query heads per kv head, head_dim hd, key block TS and copy
// chunk ch -- the grid K26 (fused_step3.cu) runs on, per SM.
extern "C" int tl_fused_step2_residency(int B, int G, int hd, int TS, int ch, int* per_sm) {
    fd::Step2 a{};
    a.G = G;
    a.hd = hd;
    a.TS = TS;
    const bool small = B <= 16;
    if (ch == 16) return small ? residency<16, 16>(a, per_sm) : residency<32, 16>(a, per_sm);
    if (ch == 4) return small ? residency<16, 4>(a, per_sm) : residency<32, 4>(a, per_sm);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The arguments of tl_fused_layer_linear (qkv is scratch here), then the
// cache k, v int8 [L, B, KVH, S, hd] and scales ks, vs f32 [L, B, KVH, S];
// pos int32 [B]; cos, sin f32 [B, hd/2]; scratch att f32 [B, D]; outputs
// attq_next int8 [B, D], satt_next f32 [B], kq, vq int8 [B, KVH, hd], ksn,
// vsn f32 [B, KVH]; layer = l + 1.  The wrapper checks G <= 8, hd <= 128,
// TS | S, TS <= 256, and ch: 16 promises hd % 16 == 0 and 16-byte aligned
// k/v, 4 promises hd % 4 == 0.
extern "C" int tl_fused_step2_layer(
    const float* x, const int8_t* attq, const float* satt, const int8_t* wo, const float* wos,
    const int8_t* w13, const float* w13s, const int8_t* w2, const float* w2s, const int8_t* wqkv,
    const float* wqkvs, const void* rms_ffn, const void* rms_att, int rms_dtype, float* x_next,
    float* qkv, int8_t* xq, float* sx, float* h2, int8_t* xq3, float* sx3, unsigned int* bar,
    int B, int D, int H, int QO, int last, const int8_t* kc, const int8_t* vc,
    const float* kcs, const float* vcs, const int* pos, const float* cosr, const float* sinr,
    float* att, int8_t* attq_next, float* satt_next, int8_t* kq, float* ksn, int8_t* vq,
    float* vsn, int KVH, int G, int hd, int S, int layer, int TS, float isqrt, int ch,
    void* stream) {
    if (B <= 0) return 0;
    fd::Step2 a{{x, attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn, rms_att,
                 rms_dtype, x_next, qkv, xq, sx, h2, xq3, sx3, bar, B, D, H, QO, last != 0, 0},
                kc, vc, kcs, vcs, pos, cosr, sinr, att, attq_next, satt_next, kq, ksn, vq, vsn,
                KVH, G, hd, S, layer, TS, isqrt};
    if (int err = fd::make_step2(a)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 16;
    if (ch == 16) return small ? launch<16, 16>(a, st) : launch<32, 16>(a, st);
    if (ch == 4) return small ? launch<16, 4>(a, st) : launch<32, 4>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
