// K5: the fused qkv epilogue of the prefill -- split, RoPE, per-head INT8.
//
// Replaces tpu_llama/ops/quant.py:476 rope_split_quantize_pallas (its
// Pallas kernel _rope_split_quant_kernel, quant.py:440; the signed rope
// tables of ops/fused_step2.py:518-534).  Row m of qkv [M, (NH + 2 KVH) hd]
// (f32 or bf16) holds NH query heads, then KVH key heads, then KVH value
// heads.  With cos, sin [M, hd/2] f32 (each row's position, gathered) and
// interleaved pairs (x0, x1) = (x[2j], x[2j+1]):
//   rope:  r0 = x0 cos_j - x1 sin_j,   r1 = x0 sin_j + x1 cos_j   (f32)
//   q     -> roped, cast to qkv's dtype                  -> qo [M, NH hd]
//   k     -> roped, then per-(row, head) INT8 over hd   -> kq, ks
//   v     -> per-(row, head) INT8 over hd               -> vq, vs
// The TPU kernel's roll identity x c + x' sa + x'' sb (sa = -sin on even
// lanes, sb = +sin on odd lanes, zero elsewhere) adds only exact zeros to
// those two products, so this is its arithmetic.  kq/ks and vq/vs land at
// row m = b T + t, head h, element d of a strided destination
// (b * kb + t * kt + h * kh + d for values, b * sb + t * st + h * sh for
// scales): the JAX layout [M, KVH hd] is b = 0, T = M, and the model passes
// the layer's block of the compact cache [B, KVH, T, hd] (head-major), so
// no transpose or copy follows.
//
// Numerics kept from the TPU kernel, and why: k and v are quantized from
// the UNROUNDED f32 values (quant.py:443-447), as the JAX package's fused
// prefill defines them; the scale is absmax * f32(1/127), XLA's form of
// the Pallas body's absmax / 127 (common.cuh), so the bytes stay the JAX
// package's.  Every product and sum of the rotation is an explicit
// round-to-nearest intrinsic (nvcc would contract x0 c - x1 s into an FMA),
// so the kernel repeats the plain version's arithmetic (ops/quant.py).
//
// Bound on the H100: bytes.  At the 7B prefill shape (M = 4096, 32 + 64
// heads of 128, bf16) the pass must read 101 MB of qkv + 2 MB of cos/sin and
// write 33.6 MB of q, 33.6 MB of int8 K/V and 1 MB of scales: 51 us at
// 3.35 TB/s.  Design: one block of eight warps per row; each warp takes one
// head at a time (a head's hd <= 128 values are <= 64 pairs, two per lane,
// read as one 4- or 8-byte load each), keeps the row's cos/sin pairs in
// registers, and reduces a head's absmax with warp shuffles -- no shared
// memory and no block barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 64;  // hd <= 128

struct KvStrides {
    long long kb, kt, kh;  // values, in elements
    long long sb, st, sh;  // scales, in elements
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_split_quantize_kernel(const T* __restrict__ qkv, const float* __restrict__ cosr,
                           const float* __restrict__ sinr, T* __restrict__ qo,
                           int8_t* __restrict__ kq, float* __restrict__ ks,
                           int8_t* __restrict__ vq, float* __restrict__ vs, int NH, int KVH,
                           int hd, long long T_, KvStrides o) {
    const long long m = blockIdx.x;
    const long long b = m / T_, t = m % T_;
    const int hp = hd / 2, heads = NH + 2 * KVH;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T* xr = qkv + m * heads * hd;

    float c[kMaxPairs / 32], sn[kMaxPairs / 32];
#pragma unroll
    for (int i = 0; i < kMaxPairs / 32; ++i) {
        const int p = lane + 32 * i;
        c[i] = p < hp ? cosr[m * hp + p] : 0.f;
        sn[i] = p < hp ? sinr[m * hp + p] : 0.f;
    }
    for (int j = warp; j < heads; j += kWarps) {
        const T* xh = xr + static_cast<long long>(j) * hd;
        const bool roped = j < NH + KVH;
        float r0[kMaxPairs / 32], r1[kMaxPairs / 32];
#pragma unroll
        for (int i = 0; i < kMaxPairs / 32; ++i) {
            const int p = lane + 32 * i;
            float x0 = 0.f, x1 = 0.f;
            if (p < hp) load_pair(xh + 2 * p, x0, x1);
            r0[i] = x0;
            r1[i] = x1;
            if (roped) rope_pair(x0, x1, c[i], sn[i], r0[i], r1[i]);
        }
        if (j < NH) {
            T* qh = qo + m * NH * hd + static_cast<long long>(j) * hd;
#pragma unroll
            for (int i = 0; i < kMaxPairs / 32; ++i) {
                const int p = lane + 32 * i;
                if (p < hp) store_pair(qh + 2 * p, r0[i], r1[i]);
            }
            continue;
        }
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPairs / 32; ++i)
            amax = fmaxf(amax, fmaxf(fabsf(r0[i]), fabsf(r1[i])));
        amax = warp_max(amax);
        const float sc = quant_scale(amax);
        const float inv = quant_inv(sc);
        const int h = roped ? j - NH : j - NH - KVH;
        int8_t* dst = (roped ? kq : vq) + b * o.kb + t * o.kt + h * o.kh;
#pragma unroll
        for (int i = 0; i < kMaxPairs / 32; ++i) {
            const int p = lane + 32 * i;
            if (p < hp) {
                dst[2 * p] = quant_i8(r0[i], inv);
                dst[2 * p + 1] = quant_i8(r1[i], inv);
            }
        }
        if (lane == 0) (roped ? ks : vs)[b * o.sb + t * o.st + h * o.sh] = sc;
    }
}

}  // namespace

// qkv and qo rows are contiguous and 2-element aligned (the wrapper
// checks); hd is even and at most 128.
extern "C" int tl_rope_split_quantize(const void* qkv, int dtype, const float* cosr,
                                      const float* sinr, void* qo, int8_t* kq, float* ks,
                                      int8_t* vq, float* vs, long long M, int NH, int KVH,
                                      int hd, long long T, long long kb, long long kt,
                                      long long kh, long long sb, long long st, long long sh,
                                      void* stream) {
    if (M <= 0) return 0;
    if (hd <= 0 || hd % 2 || hd > 2 * kMaxPairs || T <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stm = static_cast<cudaStream_t>(stream);
    const KvStrides o{kb, kt, kh, sb, st, sh};
    if (dtype == TL_F32) {
        rope_split_quantize_kernel<float><<<dim3(M), kThreads, 0, stm>>>(
            static_cast<const float*>(qkv), cosr, sinr, static_cast<float*>(qo), kq, ks, vq, vs,
            NH, KVH, hd, T, o);
    } else if (dtype == TL_BF16) {
        rope_split_quantize_kernel<__nv_bfloat16><<<dim3(M), kThreads, 0, stm>>>(
            static_cast<const __nv_bfloat16*>(qkv), cosr, sinr,
            static_cast<__nv_bfloat16*>(qo), kq, ks, vq, vs, NH, KVH, hd, T, o);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
