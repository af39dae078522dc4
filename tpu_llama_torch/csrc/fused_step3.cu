// K26 (mega3): two consecutive decode layers in one persistent cooperative
// launch -- layers l0 and l0 + 1's linear work, layer l0 + 1's attention
// merged at a seam inside the launch, and layer l0 + 2's attention.
//
// Replaces tpu_llama/ops/fused_step3.py:475 fused_step3_pair (its Pallas
// kernel _fused_step3_kernel, fused_step3.py:75, the seam :160-192, the
// cells :323, and the XLA epilogue of the second cells).  The launch is K12's
// layer body (fused_step2.cuh step2_layer) run twice:
//   step2_layer(l0):     phases A-D of layer l0, the cells of layer l0 + 1,
//                        the quant of its attention output (the seam's
//                        attq, satt) -- x, attq, satt and the rows of layer
//                        l0 + 1 into the first half's buffers;
//   the seam:            the second half's phase A waits for the first
//                        half's final quant (its counters, a Flow of its own);
//   step2_layer(l0 + 1): phases A-D of layer l0 + 1 on the seam's x, attq
//                        and satt, the cells of layer l0 + 2 and their
//                        quant.  On the last pair (l0 + 2 == L) it stops
//                        after phase C, as K12's last layer does.
// So one launch equals two chained K12 launches bit for bit: the same code
// on the same values, and a group's or a cell's result does not depend on
// which warp or block computes it.  The TPU kernel's single DMA descriptor
// walk across both halves (fused_step3.py:116-147) and its pinned VMEM plan
// (step3_plan) are not carried: each cell computes its own cache offsets,
// as K12's do.
//
// Bound on the H100: bytes, twice K12's -- two layers' weights (404.7 MB at
// Llama-2 7B) plus the cache rows below each slot's position of layers
// l0 + 1 and l0 + 2 and their scales.  Design: K12's (fused_step2.cuh);
// the halves share the phases' tickets, partials and scratch (each use is
// done before the next starts: the second half's phase A waits for the
// first half's last step); the grid is K12's -- as many blocks per SM as
// K12 keeps resident for these shapes, which K12's library reports
// (tl_fused_step2_residency) so that this source need not build K12's
// kernels too -- and the launch is refused, never shrunk, where K26's
// registers would not keep that residency.
#include "fused_step2.cuh"

namespace {

struct Step3 {
    f2::Step2 first;   // layer l0: its outputs are the seam's scratch
    f2::Step2 second;  // layer l0 + 1, reading the seam
};

template <int NT, int CH>
__global__ void __launch_bounds__(fd::kThreads, NT == 1 ? f2::kMinBlocks : 2)
    fused_step3_kernel(const __grid_constant__ Step3 a) {
    extern __shared__ __align__(16) unsigned char smem[];
    f2::ring_init();
    int q = 0;  // the ring's use count, carried into the second layer
    f2::step2_layer<NT, CH>(a.first, smem, &q);
    f2::step2_layer<NT, CH>(a.second, smem, &q);
    f2::launch_exit(a.first.lay.ws);
}

template <int NT, int CH>
int launch(const Step3& a, int k12_per_sm, cudaStream_t st) {
    return fd::coop_launch(fused_step3_kernel<NT, CH>, a, f2::step2_smem(a.first), st,
                           k12_per_sm);
}

}  // namespace

// tl_fused_step2_layer's arguments for layer l0 (x_next, attq_next and
// satt_next are the seam's scratch [B, D], [B, D], [B]; kq, ksn, vq, vsn
// the fresh rows of layer l0 + 1; layer = l0 + 1; last must be 0), then
// layer l0 + 1's weight views wo2, w132, w22 with their scales and
// rms_ffn2, layer l0 + 2's wqkv2, wqkvs2 and rms_att2 (layer L - 1's on
// the last pair, unread there); the outputs x_out f32 [B, D], attq_out
// int8 [B, D], satt_out f32 [B] and the fresh rows kq2, ks2, vq2, vs2 of
// layer l0 + 2 (untouched on the last pair); last2 (the last pair) and
// layer2 = min(l0 + 2, L - 1); k12_per_sm, the blocks per SM of K12's grid
// for these shapes (tl_fused_step2_residency, fused_step2.cu).
extern "C" int tl_fused_step3_pair(
    const float* x, const int8_t* attq, const float* satt, const int8_t* wo, const float* wos,
    const int8_t* w13, const float* w13s, const int8_t* w2, const float* w2s, const int8_t* wqkv,
    const float* wqkvs, const void* rms_ffn, const void* rms_att, int rms_dtype, float* x_seam,
    float* qkv, int8_t* xq, float* sx, float* h2, unsigned* ws, int B, int D, int H, int QO,
    int last, const int8_t* kc, const int8_t* vc, const float* kcs, const float* vcs,
    const int* pos, const float* cosr, const float* sinr, float* att, int8_t* attq_seam,
    float* satt_seam, int8_t* kq, float* ksn, int8_t* vq, float* vsn, float* cws, int* cticket,
    int KVH, int G, int hd, int S, int layer, int TS, int splits, float isqrt, int ch,
    const int8_t* wo2, const float* wos2, const int8_t* w132, const float* w13s2,
    const int8_t* w22, const float* w2s2, const int8_t* wqkv2, const float* wqkvs2,
    const void* rms_ffn2, const void* rms_att2, float* x_out, int8_t* attq_out,
    float* satt_out, int8_t* kq2, float* ks2, int8_t* vq2, float* vs2, int last2, int layer2,
    int k12_per_sm, void* stream) {
    if (B <= 0) return 0;
    if (last != 0 || k12_per_sm < 1)  // l0 + 1 < L always; K12 fits on the card
        return static_cast<int>(cudaErrorInvalidValue);
    Step3 a{};
    f2::Step2& s1 = a.first;
    s1.lay.lin = fd::Linear{x,   attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn,
                            rms_att, rms_dtype, x_seam, qkv, xq, sx, h2, nullptr,
                            B, D, H, QO, 0, 0};
    s1.kc = kc;
    s1.vc = vc;
    s1.kcs = kcs;
    s1.vcs = vcs;
    s1.pos = pos;
    s1.cosr = cosr;
    s1.sinr = sinr;
    s1.att = att;
    s1.attq_next = attq_seam;
    s1.satt_next = satt_seam;
    s1.kq = kq;
    s1.ks = ksn;
    s1.vq = vq;
    s1.vs = vsn;
    s1.cws = cws;
    s1.cticket = cticket;
    s1.KVH = KVH;
    s1.G = G;
    s1.hd = hd;
    s1.S = S;
    s1.layer = layer;
    s1.TS = TS;
    s1.splits = splits;
    s1.isqrt = isqrt;
    f2::Step2& s2 = a.second;
    s2 = s1;
    s2.lay.lin = fd::Linear{x_seam, attq_seam, satt_seam, wo2, wos2, w132, w13s2, w22, w2s2,
                            wqkv2, wqkvs2, rms_ffn2, rms_att2, rms_dtype, x_out, qkv, xq, sx, h2,
                            nullptr, B, D, H, QO, last2 != 0, 0};
    s2.attq_next = attq_out;
    s2.satt_next = satt_out;
    s2.kq = kq2;
    s2.ks = ks2;
    s2.vq = vq2;
    s2.vs = vs2;
    s2.layer = layer2;
    f2::Flow* flows = reinterpret_cast<f2::Flow*>(ws);
    const f2::Flow* seam = reinterpret_cast<const f2::Flow*>(ws);
    if (int err = f2::make_step2(s1, ws, flows, nullptr)) return err;
    if (int err = f2::make_step2(s2, ws, reinterpret_cast<f2::Flow*>(ws + f2::kFlowWords), seam))
        return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 8;
    const int n = k12_per_sm;
    if (ch == 16) return small ? launch<1, 16>(a, n, st) : launch<4, 16>(a, n, st);
    if (ch == 4) return small ? launch<1, 4>(a, n, st) : launch<4, 4>(a, n, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
