// K12 (mega2): layer l's linear work and layer l + 1's attention in one
// persistent cooperative launch.
//
// Replaces tpu_llama/ops/fused_step2.py:537 fused_step2_layer (its Pallas
// kernel _fused_step2_kernel, fused_step2.py:113, and the XLA epilogue
// :714-737).  After K11's phases (fused_decode.cuh, with h2 rounded to bf16
// before its quant, fused_step2.py:217-224), a barrier, then one cell per
// (slot, kv head) of layer l + 1:
//   q heads: RoPE, times 1/sqrt(hd) (a reciprocal, :152), rounded to bf16
//            (:256-257) -- the cells' queries for the cache rows AND the
//            fresh column (s_raw, :290-296);
//   k head:  RoPE, then the per-head INT8 quant of quantize_kv -> kq, ks;
//   v head:  the per-head INT8 quant -> vq, vs;
//   then common.cuh's dec_attend (K9's cell): cache rows s < pos[b] in
//   blocks of TS, the fresh row as one more column.
// A last barrier, then one block per row quantizes the attention output
// (quantize_activations, :736) -> attq_next, satt_next, inside the launch.
// The last layer stops after phase C: no qkv, no cells, the attention
// outputs untouched (:556-561).  RoPE per pair is x0 c - x1 s and x0 s +
// x1 c; the TPU kernel's roll form adds only exact zeros to that (:70-88).
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

struct Step2 {
    fd::Linear lin;      // lin.qkv is scratch [B, QO]: layer l + 1's raw q/k/v
    const int8_t* kc;    // [L, B, KVH, S, hd] int8 cache
    const int8_t* vc;
    const float* kcs;    // [L, B, KVH, S] scales
    const float* vcs;
    const int* pos;      // [B]
    const float* cosr;   // [B, hd/2] at each slot's position
    const float* sinr;
    float* att;          // [B, D] scratch: the cells' outputs
    int8_t* attq_next;   // [B, D]
    float* satt_next;    // [B]
    int8_t* kq;          // [B, KVH, hd] the fresh rows of layer l + 1
    float* ks;           // [B, KVH]
    int8_t* vq;
    float* vs;
    int KVH, G, hd, S, layer, TS;  // layer: l + 1
    float isqrt;         // f32(1 / sqrt(f32(hd)))
};

template <int BM, int CH>
__global__ void __launch_bounds__(fd::kThreads) fused_step2_kernel(const Step2 a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[fd::kThreads / 32];
    const fd::Linear& lin = a.lin;
    fd::linear_phases<BM, true>(lin, reinterpret_cast<int8_t*>(smem));
    if (lin.last) return;
    fd::grid_sync(lin.bar);  // layer l + 1's qkv is complete

    const int B = lin.B, D = lin.D, QO = lin.QO, KVH = a.KVH, G = a.G, hd = a.hd;
    const int P = dec_pitch<int8_t>(hd), hp = hd / 2, tid = threadIdx.x;
    const DecSmem<int8_t> sm(smem, a.TS, P, G);
    for (int cell = blockIdx.x; cell < B * KVH; cell += gridDim.x) {
        const int b = cell / KVH, h = cell % KVH;
        const long long bh = (long long)b * KVH + h;
        const float* row = lin.qkv + (long long)b * QO;
        const float* cs = a.cosr + (long long)b * hp;
        const float* sn = a.sinr + (long long)b * hp;
        // the G query rows of kv head h: roped, scaled, rounded to bf16
        for (int e = tid; e < G * P; e += fd::kThreads) {
            const int g = e / P, d = e % P;
            float v = 0.f;
            if (d < hd) {
                const float* xh = row + (long long)(h * G + g) * hd;
                float r0, r1;
                rope_pair(__ldcg(xh + (d & ~1)), __ldcg(xh + (d | 1)), cs[d >> 1], sn[d >> 1],
                          r0, r1);
                v = round_bf16(__fmul_rn(d & 1 ? r1 : r0, a.isqrt));
            }
            sm.qf[e] = v;
            sm.qb[e] = v;
        }
        // the fresh K (roped) and V rows of head h, one element per thread
        float rk = 0.f, rv = 0.f;
        if (tid < hd) {
            const float* kh = row + D + (long long)h * hd;
            float r0, r1;
            rope_pair(__ldcg(kh + (tid & ~1)), __ldcg(kh + (tid | 1)), cs[tid >> 1],
                      sn[tid >> 1], r0, r1);
            rk = tid & 1 ? r1 : r0;
            rv = __ldcg(row + D + KVH * hd + (long long)h * hd + tid);
        }
        const float ksc = quant_scale(block_max<fd::kThreads>(fabsf(rk), red));
        const float vsc = quant_scale(block_max<fd::kThreads>(fabsf(rv), red));
        int8_t* kqr = a.kq + bh * hd;
        int8_t* vqr = a.vq + bh * hd;
        if (tid < hd) {
            kqr[tid] = quant_i8(rk, quant_inv(ksc));
            vqr[tid] = quant_i8(rv, quant_inv(vsc));
        }
        if (tid == 0) {
            a.ks[bh] = ksc;
            a.vs[bh] = vsc;
        }
        __syncthreads();  // the fresh rows are written for the whole block
        const int p = min(max(a.pos[b], 0), a.S);
        const long long row0 = (((long long)a.layer * B + b) * KVH + h) * a.S;
        dec_attend<int8_t, CH>(sm, a.kc + row0 * hd, a.vc + row0 * hd, a.kcs + row0, a.vcs + row0, p,
                       a.TS, G, hd, kqr, ksc, vqr, vsc, a.att + bh * G * hd);
        __syncthreads();  // shared memory is free for the next cell
    }
    fd::grid_sync(lin.bar);  // every cell's output is in att
    if (blockIdx.x < B)
        fd::quant_row(a.att + (long long)blockIdx.x * D, D, a.attq_next + (long long)blockIdx.x * D,
                      a.satt_next + blockIdx.x);
}

template <int BM, int CH>
int launch(const Step2& a, cudaStream_t st) {
    const int cell = DecSmem<int8_t>::bytes(a.TS, dec_pitch<int8_t>(a.hd), a.G);
    const int smem = fd::gemm_smem<BM>() > cell ? fd::gemm_smem<BM>() : cell;
    return fd::coop_launch(fused_step2_kernel<BM, CH>, a, smem, st);
}

}  // namespace

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
    if (G < 1 || G > kDecMaxG || hd < 2 || hd % 2 || hd > kDecMaxHd || TS < 1 || TS > 256 ||
        KVH < 1 || D != KVH * G * hd || QO != D + 2 * KVH * hd)
        return static_cast<int>(cudaErrorInvalidValue);
    Step2 a{{x, attq, satt, wo, wos, w13, w13s, w2, w2s, wqkv, wqkvs, rms_ffn, rms_att,
             rms_dtype, x_next, qkv, xq, sx, h2, xq3, sx3, bar, B, D, H, QO, last != 0, 0},
            kc, vc, kcs, vcs, pos, cosr, sinr, att, attq_next, satt_next, kq, ksn, vq, vsn,
            KVH, G, hd, S, layer, TS, isqrt};
    if (int err = fd::prepare(a.lin)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = B <= 16;
    if (ch == 16) return small ? launch<16, 16>(a, st) : launch<32, 16>(a, st);
    if (ch == 4) return small ? launch<16, 4>(a, st) : launch<32, 4>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
