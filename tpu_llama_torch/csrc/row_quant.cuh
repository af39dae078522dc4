// The streamed per-row INT8 quant of K2 (quantize_rows.cu) and K3
// (rmsnorm_quantize.cu): read a row once, reduce it, write its int8 bytes
// and one f32 scale.
//
// Bound on the H100: bytes (3 a bf16 element, 5 an f32 one; at bf16
// [4096, 4096] 50.3 MB, 15.0 us at 3.35 TB/s; a bare read-reduce-write of
// those bytes reaches 3.34 TB/s, tpu_llama_torch/stream_probe.py).  What the
// design does about it:
// - A team of TW warps holds a row in registers from its single read: lane
//   t of the team loads the 16-byte vectors c = t + 32 TW j, j < kRqVecs,
//   all issued before the first use (two warps a 7B bf16 row, 8 vectors a
//   lane).  Rows past 32 TW kRqVecs vectors (more than 16384 bf16 or 8192
//   f32 values) re-read their tail from memory, as do rows that are not
//   16-byte aligned, element by element.
// - Reductions are warp shuffles; a team of more than one warp exchanges
//   its warps' partials once through shared memory behind a named barrier
//   of the team's threads (the block's barrier when the team is the block).
// - The grid (ops/quant.py rq_plan): one row a team up to 8 blocks an SM,
//   kRqBlocksPerSm of them resident; the block scheduler refills an SM as
//   its teams finish, so loads of new rows overlap the arithmetic of old
//   ones.  Past that the teams walk rows by stride.
// - A bf16 row's int8 goes out in 16-byte stores where its rows are 16-byte
//   aligned (N % 16 == 0): a lane pair holds the two neighbouring vectors of
//   a 16-byte run over two rounds and swaps one word pair.  Other rows store
//   one vector's 8 (bf16) or 4 (f32) bytes: for f32 a four-lane swap cost
//   more than it saved at a decode step's 8 rows (PERF.md section 6).
// Numerics are common.cuh's: quant_scale, quant_inv, rms_factor and the
// round-to-nearest intrinsics; quant_byte below is quant_i8's value.
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int kRqWarps = 8;  // warps a block; a team is 1, 2, 4 or 8 of them
constexpr int kRqThreads = 32 * kRqWarps;
constexpr int kRqVecs = 8;  // 16-byte vectors of its row a lane holds in registers

// Blocks an SM the launch bounds keep resident: at most 80 registers a
// thread, which K3 uses without spilling (two blocks and 128 registers were
// no faster; PERF.md section 6).
constexpr int kRqBlocksPerSm = 3;

// 16 bytes of a row that is read once: not kept in L1.
__device__ __forceinline__ uint4 rq_load16(const void* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

__device__ __forceinline__ uint32_t rq_word(const uint4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element k of a 16-byte vector of T as f32 (k a constant after unrolling).
template <typename T>
__device__ __forceinline__ float rq_elem(const uint4& v, int k);
template <>
__device__ __forceinline__ float rq_elem<float>(const uint4& v, int k) {
    return __uint_as_float(rq_word(v, k));
}
template <>
__device__ __forceinline__ float rq_elem<__nv_bfloat16>(const uint4& v, int k) {
    const uint32_t w = rq_word(v, k >> 1);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// quant_i8(x, inv) (common.cuh) as the low byte of a word, without its two
// conversions (rintf and the cast, on the SM's narrow conversion pipe):
// clamp to [-127, 127] first (rint and a clamp to integer bounds commute;
// a NaN clamps to -127 in both), then add 1.5 * 2^23, which rounds to an
// integer, half to even, for every |v| <= 127 (the sum lies in [2^23, 2^24),
// where the f32 spacing is 1); the sum's low byte is rint(v) mod 256.
__device__ __forceinline__ uint32_t quant_byte(float x, float inv) {
    const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(v, 12582912.f));
}

// The low bytes of four words as one word, a0 in the lowest byte.
__device__ __forceinline__ uint32_t rq_pack4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3) {
    return __byte_perm(__byte_perm(a0, a1, 0x0040), __byte_perm(a2, a3, 0x0040), 0x5410);
}

// The 16-byte int8 run of round j0 + (lane & 1) at a lane pair's first
// vector, from the pair's bf16 vectors' int8 words: a0 of round j0, a1 of
// round j0 + 1.  The even lane keeps a0 and takes its partner's; the odd
// one keeps a1 and takes its partner's: one shuffle of each word.
__device__ __forceinline__ uint4 rq_pair_run(uint2 a0, uint2 a1, int lane) {
    const bool odd = lane & 1;
    const uint2 send = odd ? a0 : a1;
    const uint2 got = make_uint2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                 __shfl_xor_sync(0xffffffffu, send.y, 1));
    return odd ? make_uint4(got.x, got.y, a1.x, a1.y) : make_uint4(a0.x, a0.y, got.x, got.y);
}

// The TW > 1 warps of team `team` (threads of one block): the block's
// barrier, or named barrier 1 + team.
template <int TW>
__device__ __forceinline__ void rq_team_sync(int team) {
    if constexpr (TW == kRqWarps) {
        __syncthreads();
    } else {
        asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(TW * 32) : "memory");
    }
}

// A team's sum / max: every lane gets the same value (the warps' partials
// combined in warp order).  `red` holds kRqWarps values.
template <int TW>
__device__ __forceinline__ double rq_team_sum(double v, double* red, int team) {
    v = warp_sum(v);
    if constexpr (TW > 1) {
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) red[warp] = v;
        rq_team_sync<TW>(team);
        v = red[team * TW];
#pragma unroll
        for (int i = 1; i < TW; ++i) v += red[team * TW + i];
        rq_team_sync<TW>(team);
    }
    return v;
}
template <int TW>
__device__ __forceinline__ float rq_team_max(float v, float* red, int team) {  // of values >= 0
    v = warp_max(v);
    if constexpr (TW > 1) {
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) red[warp] = v;
        rq_team_sync<TW>(team);
        v = red[team * TW];
#pragma unroll
        for (int i = 1; i < TW; ++i) v = fmaxf(v, red[team * TW + i]);
        rq_team_sync<TW>(team);
    }
    return v;
}

// The V = Vec<T>::n values of W at p (shared memory, aligned to V
// elements) as f32.
template <typename W, int V>
__device__ __forceinline__ void rq_load_w(const W* p, float (&f)[V]) {
    if constexpr (sizeof(W) == 2) {
        uint4 raw;
        if constexpr (V == 8) {
            raw = *reinterpret_cast<const uint4*>(p);
        } else {  // V == 4: 8 bytes
            const uint2 h = *reinterpret_cast<const uint2*>(p);
            raw = make_uint4(h.x, h.y, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = rq_elem<__nv_bfloat16>(raw, k);
    } else {
#pragma unroll
        for (int k = 0; k < V; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(p + k);
            f[k] = v.x;
            f[k + 1] = v.y;
            f[k + 2] = v.z;
            f[k + 3] = v.w;
        }
    }
}

// The row quant of rows [0, M) of x [M, N] into q [M, N] and s [M], by
// teams of TW warps walking rows by stride.  kNorm: K3, the values are
// xf = (x * r) * w with r = rms_factor of the row's f64 sum of squares;
// else K2, the values are x.  vec: x's rows are 16-byte aligned; q16: q's
// rows are too and x is bf16 (16-byte stores; ignored for f32).  K3 copies w to the block's dynamic
// shared memory (N * sizeof(W) bytes) first.
template <typename T, typename W, bool kNorm, int TW>
__device__ __forceinline__ void row_quant(const T* __restrict__ x, const W* __restrict__ w,
                                          int8_t* __restrict__ q, float* __restrict__ s,
                                          long long M, long long N, int vec, int q16) {
    constexpr int R = kRqVecs;
    constexpr int V = Vec<T>::n;  // elements a 16-byte vector
    constexpr int TT = 32 * TW;  // threads a team
    constexpr int QW = V / 4;  // words of a vector's int8: 2 for bf16, 1 for f32
    static_assert(R % 2 == 0, "bf16 rounds pair into 16-byte runs");
    __shared__ double dred[kRqWarps];
    __shared__ float fred[kRqWarps];
    extern __shared__ __align__(16) unsigned char rq_dyn[];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int team = warp / TW, t = (warp % TW) * 32 + lane;
    const long long stride = static_cast<long long>(gridDim.x) * (kRqWarps / TW);
    const long long first = static_cast<long long>(blockIdx.x) * (kRqWarps / TW) + team;
    const long long nv = vec ? N / V : 0;
    const long long held = min(nv, static_cast<long long>(TT) * R);  // vectors a row holds
    const long long tail0 = held * V;  // the first element read element by element

    auto has = [&](int j) { return t + static_cast<long long>(TT) * j < held; };
    auto load = [&](long long row, uint4 (&v)[R]) {
        const T* xr = x + row * N;
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (has(j)) v[j] = rq_load16(xr + (t + static_cast<long long>(TT) * j) * V);
    };

    // the first row's loads go out before K3 copies w to shared memory
    uint4 v[R];
    if (first < M) load(first, v);
    W* wp = reinterpret_cast<W*>(rq_dyn);
    if constexpr (kNorm) {
        const long long wb = N * static_cast<long long>(sizeof(W));
        if (wb % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
            for (long long i = threadIdx.x; i < wb / 16; i += kRqThreads)
                reinterpret_cast<uint4*>(wp)[i] = __ldg(reinterpret_cast<const uint4*>(w) + i);
        } else {
            for (long long i = threadIdx.x; i < N; i += kRqThreads) wp[i] = w[i];
        }
        __syncthreads();
    }

    auto finish = [&](long long row, const uint4 (&v)[R]) {
        const T* xr = x + row * N;
        int8_t* qr = q + row * N;
        float r = 1.f;
        if constexpr (kNorm) {
            double ss = 0.0;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (has(j)) {
#pragma unroll
                    for (int k = 0; k < V; ++k) {
                        const double f = rq_elem<T>(v[j], k);
                        ss += f * f;
                    }
                }
            }
            for (long long i = tail0 + t; i < N; i += TT) {
                const double f = to_f32(xr[i]);
                ss += f * f;
            }
            r = rms_factor(rq_team_sum<TW>(ss, dred, team), N);
        }
        // the value quantized: x, or K3's xf, each product rounded
        auto wvec = [&](long long c, float (&wf)[V]) {
            if constexpr (kNorm) {
                rq_load_w<W, V>(wp + c * V, wf);
            } else {
#pragma unroll
                for (int k = 0; k < V; ++k) wf[k] = 1.f;
            }
        };
        auto val = [&](float xi, float wi) {
            if constexpr (kNorm) return __fmul_rn(__fmul_rn(xi, r), wi);
            return xi;
        };
        auto wat = [&](long long i) { return kNorm ? to_f32(wp[i]) : 1.f; };

        float amax = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const long long c = t + static_cast<long long>(TT) * j;
            if (has(j)) {
                float wf[V];
                wvec(c, wf);
#pragma unroll
                for (int k = 0; k < V; ++k)
                    amax = fmaxf(amax, fabsf(val(rq_elem<T>(v[j], k), wf[k])));
            }
        }
        for (long long i = tail0 + t; i < N; i += TT)
            amax = fmaxf(amax, fabsf(val(to_f32(xr[i]), wat(i))));
        amax = rq_team_max<TW>(amax, fred, team);
        const float sc = quant_scale(amax);
        const float inv = quant_inv(sc);

        uint32_t qv[R][QW] = {};  // the int8 of each held vector, packed
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const long long c = t + static_cast<long long>(TT) * j;
            if (has(j)) {
                float wf[V];
                wvec(c, wf);
#pragma unroll
                for (int u = 0; u < QW; ++u) {
                    uint32_t b[4];
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        b[k] = quant_byte(val(rq_elem<T>(v[j], 4 * u + k), wf[4 * u + k]), inv);
                    qv[j][u] = rq_pack4(b[0], b[1], b[2], b[3]);
                }
            }
        }
        if (QW == 2 && q16) {
            // lane 2i + g stores round j0 + g's 16 bytes at the pair's first vector
#pragma unroll
            for (int j0 = 0; j0 < R; j0 += 2) {
                if (static_cast<long long>(TT) * j0 >= held) break;  // the same in the team
                const uint4 run = rq_pair_run(make_uint2(qv[j0][0], qv[j0][QW - 1]),
                                              make_uint2(qv[j0 + 1][0], qv[j0 + 1][QW - 1]), lane);
                const long long c0 = static_cast<long long>(TT) * (j0 + (lane & 1)) + (t & ~1);
                if (c0 < held) *reinterpret_cast<uint4*>(qr + c0 * V) = run;
            }
        } else {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const long long c = t + static_cast<long long>(TT) * j;
                if (has(j)) {
                    if constexpr (QW == 2)
                        *reinterpret_cast<uint2*>(qr + c * V) = make_uint2(qv[j][0], qv[j][1]);
                    else
                        *reinterpret_cast<uint32_t*>(qr + c * V) = qv[j][0];
                }
            }
        }
        for (long long i = tail0 + t; i < N; i += TT)
            qr[i] = static_cast<int8_t>(quant_byte(val(to_f32(xr[i]), wat(i)), inv) & 0xffu);
        if (t == 0) s[row] = sc;
    };

    for (long long row = first; row < M; row += stride) {
        if (row != first) load(row, v);
        finish(row, v);
    }
}

// The block layout that ops/quant.py rq_plan sizes the grid by (RQ_WARPS,
// RQ_VECS there): out = {kRqWarps, kRqVecs}.  The wrappers compare them once
// a library, so the two cannot drift apart unnoticed.
extern "C" int tl_row_quant_layout(int* out) {
    out[0] = kRqWarps;
    out[1] = kRqVecs;
    return 0;
}

// fn(TW) with the plan's warps a row as a std::integral_constant;
// cudaErrorInvalidValue for another count.
template <class F>
int rq_dispatch(int tw, F&& fn) {
    using std::integral_constant;
    switch (tw) {
        case 1: return fn(integral_constant<int, 1>());
        case 2: return fn(integral_constant<int, 2>());
        case 4: return fn(integral_constant<int, 4>());
        case 8: return fn(integral_constant<int, 8>());
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
