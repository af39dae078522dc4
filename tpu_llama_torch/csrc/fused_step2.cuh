// The streaming decode-layer body: K12's (fused_step2.cu), which K26
// (fused_step3.cu) runs twice per launch, K11's (fused_layer.cu) and K27's
// (fused_step.cu) linear phases, and the tensor-parallel decode's spans K23
// (fused_ffn.cu) and K24 (fused_rms_qkv.cu).  K12: layer l's linear work,
// then layer l + 1's attention, in one persistent cooperative launch; K27
// the two halves in the other order (layer l's attention, then its linear
// work); K11 the linear work alone; K23 phases B and C entered from the
// launch's x (the w2 partial, no residual); K24 phase D entered from it.
//
// What it replaces: fused_decode.cuh's linear_phases, which K11, K27 and
// the first K12 ran, the gemm_tile stream and grid barrier of K23 and K24,
// and the dec_attend cells of K12 and K27 (all gone).  On the H100 that
// body ran at 3.5-5.7x its bytes bound (K23 and K24 up to 17x and 29x at
// tensor-parallel width 8): each phase grid-strode 32-row weight tiles over
// the whole K, so phases A (wo) and C (w2), 128 tiles each, kept one block
// an SM busy and the rest idle; a block had three 8 KB stages in flight
// behind a block-wide barrier each; every tile re-read the activations from
// L2 as a 16-row A operand padded with zeros at batch 8; grid barriers
// stopped the weight stream, around steps that one block per row ran while
// the grid waited; and each cell walked its slot's cache alone.
//
// Design (bound: bytes -- 202.4 MB of 7B weights a layer plus the cache
// rows each slot attends):
// - Every block streams an equal share of every phase.  A phase's weights
//   are units of 16 rows (output columns; w13: 8 gate rows and the up rows
//   of the same 8 columns) by 1 KB of K, and block b takes the contiguous
//   units [b T / NB, (b + 1) T / NB) in row-group-major order -- so wo and
//   w2, whose 256 row groups are fewer than the blocks, are split along K
//   like the rest.  A block's share of a group is exact int32 (its four
//   warps each take a quarter of every unit's K and add up in shared
//   memory at the share's end); a share that is not the whole group is
//   added into an int32 buffer (red.add: integer sums in any order are the
//   same sum), and the block that brings the group's chunk count to its
//   total -- an atomic ticket it sets back to zero, with the buffer --
//   applies the epilogue.  So every output sees the same int32 whatever the
//   split, and the f32 epilogue is the old one's, step for step: the plain
//   versions do not change.
// - The bytes come through a ring of kStagesU shared-memory stages filled
//   by 1D bulk copies (cp.async.bulk, one per row: 1 KB runs) on mbarriers:
//   a unit's 16 weight rows and its batch rows' 1 KB of activations.  The
//   weight rows of the next units are copied as soon as a stage is free,
//   also across a phase boundary (the weights need no activation); the
//   activation rows once the phase's activations are ready.  On the H100
//   such a ring streams at ~3 TB/s at these shapes, where loads into
//   registers (128-byte runs a row) reached ~1.5.  Lane (g, t4) takes 16
//   bytes of weight rows g and g + 8 and of batch row g at the same k: any
//   permutation of K in both operands leaves an int32 dot unchanged, so one
//   16-byte read is the fragments of two mma.m16n8k32 with the batch rows as
//   the mma's N (8 a tile: no padded rows at batch 8).  Above 8 rows a
//   stage holds 16 weight rows and 32 activation rows, and the weights
//   stream at about half their rate at 8 rows (open work).
// - No grid barrier.  Each boundary is dataflow on counters in a workspace
//   that the launch leaves zero: a group's epilogue bumps its phase's
//   count; blocks b < B wait for the whole phase, compute row b's rmsnorm +
//   quant (K3's) with the row held in registers, and bump a row count;
//   every block waits for that count before the phase's activation rows
//   are copied.  Phase C's activations, h2 quantized, need only each row's
//   max |h2| (an order-free atomic max in phase B's epilogue): every block
//   quantizes a slice of h2 (K2's formula) once phase B is done.  The last
//   block out of the launch sets the counters back to zero.
// - The spans (K23, K24) enter from the launch's x: blocks b < B quantize
//   row b first (rms_quant_row4: compact passes of 16-byte loads -- the
//   register-held form's unrolled code, run cold at the launch's start,
//   took ~12 us a row on the H100) and start their rings after it, while
//   every other block's ring fills with weight rows and waits on the row
//   count.  (A form in which every block derived each row's rmsnorm factor
//   and quant scale from x itself, waiting for no other block, measured
//   slower at every shape: PERF.md.)  Their units are 16 rows by
//   kSpanChunk (2 KB) of K: at 1 KB the ring's rate was set by its bulk
//   copies' count, ~17 a us an SM, not their bytes.  Their int8
//   activations are chunk-major (qpos), so a unit's activation rows are one
//   bulk copy, and a phase's are one run: above 8 rows, where that run fits
//   the memory the stages' activation rows take (span_resident), the block
//   copies it once when the phase's activations are ready and the ring
//   carries only weight rows (there the activations are two thirds of a
//   unit's bytes).  A block takes whole row groups where a phase has at
//   least as many as blocks (no partials or tickets), and adds its groups to
//   the phase's count once, at its end (on K11 and K12 the same change
//   measured about 1% slower).  Rows come in groups of
//   kMaxRows, one after another in the launch, each with counters, tickets
//   and partials of its own.
// - The cells (K12's trailing, K27's leading) run decode_split.cuh's split
//   cell (K9's) over (slot, kv head, split) items taken grid-stride, the
//   last splits first (only the longest slots reach them); splits by
//   ops/fused_step2.py fused_splits (a function of the shapes alone).  A
//   split whose span starts past its slot's rows is skipped and left out of
//   the merge (its partial would merge as an exact no-op), so short slots
//   pay nothing for the splits a long one needs.  Partials merge in split
//   order in the launch (the cell's self-resetting tickets).  K12's blocks
//   prefetch their first item's first key rows into L2 while phase D
//   finishes.  At one split the cell runs the sequential block walk of
//   common.cuh's dec_attend (the old cells); at more, each p rounds against
//   its split's running max (K9's accepted departure).  At either count the
//   plain version's dots and sums run in PyTorch's order, so an f32 ulp can
//   move a rare attention output across an int8 step: the output is held to
//   it within one step, not bit for bit.
//
// Numerics are the old body's: every f32 product and sum of the epilogues
// and the SiLU an explicit round-to-nearest intrinsic, h2 rounded to bf16
// (K12 and K26: fused_step2.py:217-224) or kept in f32 (K11, K27, K23:
// fused_layer.py:118-126) -- the body's kBf16H2 --, the rmsnorm's f64 sum of
// squares (K3), the quant formula of common.cuh.
//
// Memory order: data one block writes and another reads later in the launch
// is read through L2 (ld.global.cg) or by a bulk copy issued after a proxy
// fence, after a __threadfence() and a counter on the writer's side and an
// acquire load of the counter on the reader's.
#pragma once

#include "decode_split.cuh"
#include "fused_decode.cuh"
#include "hopper.cuh"

namespace f2 {

using fd::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks an SM the launch bounds keep registers for at batch <= 8
constexpr int kRowsU = 16;               // weight rows a unit: one mma M tile
constexpr int kChunkU = 1024;            // bytes of K a unit: one bulk copy per row
constexpr int kPitchU = kChunkU + 64;    // a stage's row pitch: conflict-free fragment loads
constexpr int kStagesU = 2;              // the ring's stages (K11, K12, K26, K27)
// K23's and K24's units: kSpanChunk bytes of K (16 weight rows take 16
// bulk copies a unit whatever its size, and the copies, not their bytes,
// set the ring's rate on the H100 at 1 KB), their stage rows kSpanPitch
// apart.
constexpr int kSpanChunk = 2 * kChunkU;
constexpr int kSpanPitch = kSpanChunk + 64;
// A span's stage: 16 weight rows and 8 nt activation rows (two blocks an SM
// fit at nt 1, one at nt 4).  The ring keeps every stage's weight rows
// first, then every stage's activation rows, so that a phase whose
// activations stay resident takes the second part whole (span_resident).
__host__ __device__ constexpr int span_stage_bytes(int nt) {
    return (kRowsU + 8 * nt) * kSpanPitch;
}
// Whether a span's phase of nch chunks keeps its B rows' activations
// resident: above 8 rows (nt 4), where they are two thirds of a unit's
// bytes, and where they fit the stages' activation rows (kStagesU 8 nt of
// them).  At nt 1 the resident form measured no faster on the H100.
__host__ __device__ constexpr bool span_resident(int nch, int B, int nt) {
    return nt == 4 && nch * B <= kStagesU * 8 * nt;
}
template <bool kSpan>
__host__ __device__ constexpr int unit_chunk() {
    return kSpan ? kSpanChunk : kChunkU;
}
// a stage: the unit's 16 weight rows, then its 8 NT activation rows
__host__ __device__ constexpr int stage_bytes(int nt) { return (kRowsU + 8 * nt) * kPitchU; }
constexpr int kFlowWords = 64;     // one layer's counters (Flow) in the workspace
constexpr int kExitWord = 2 * kFlowWords;
constexpr int kTicketBase = 2 * kFlowWords + 32;  // words before the group tickets

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One layer's counters: zero when a launch starts.
struct Flow {
    unsigned done[4];   // row groups whose epilogue is applied, phases A-D
    unsigned rows[3];   // rows quantized: after A, after C, the final quant
    unsigned cells;     // (slot, kv head) outputs written
    unsigned xq3;       // blocks that quantized their slice of h2
    unsigned pad[7];
    unsigned amax3[fd::kMaxRows];  // max |h2| of each row, as float bits
};
static_assert(sizeof(Flow) <= kFlowWords * 4, "Flow fits its words");

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Block-wide: wait until *c >= target.  A count that never arrives is a
// fault of the launch; it traps after ~10 s rather than hang the card.
__device__ __forceinline__ void wait_geq(const unsigned* c, unsigned target) {
    if (threadIdx.x == 0) {
        unsigned long long spins = 0;
        while (ld_acquire(c) < target) {
            __nanosleep(64);
            if (++spins > (1ull << 27)) __trap();
        }
        __threadfence();
    }
    __syncthreads();
}

// Block-wide: publish the block's writes, then add one to *c.
__device__ __forceinline__ void count_up(unsigned* c) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(c, 1u);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// this block's shared memory, completing on bar (complete_tx).
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Expect `bytes` more on bar's current phase without arriving.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Global memory written by other blocks (generic proxy), acquired through a
// counter, read after this by the bulk copies (async proxy).
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// mbar_wait with a bound: a stage that never lands traps (~seconds) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    for (unsigned long long n = 0; !done; ++n) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
        if (n > (1ull << 26)) __trap();
    }
}

enum Kind : int { kWo = 0, kW13 = 1, kW2 = 2, kQkv = 3 };

// One linear phase of the layer.
struct Phase {
    int kind;
    int res;           // the spans: the phase's activations resident (span_resident), else 0
    const int8_t* w;   // [rows, K] K-contiguous (w13: the H gate rows, then the H up rows)
    const float* ws;   // column scales
    const int8_t* x;   // [B, K] int8 activations (attq, xq, xq3, xq)
    int N;             // output columns (w13: H)
    int K;
    int groups, nch;   // row groups of kRowsU weight rows (w13: 8 columns), chunks of kChunkU
    unsigned* tickets; // [groups] chunks added so far, zero between uses
    int* acc;          // [B, Nacc] int32 partials (Nacc: N, w13 2H), zero between uses
    int nacc;
};
// res sits in the padding after kind: LayerShared, and so the static shared
// memory of K12's blocks, which sit at the SM's limit, keeps its size.
static_assert(sizeof(Phase) == 72, "Phase keeps its size");

// Weight row r (0..15) of group gi: rows gi * 16 + r, or for w13 the gate
// (r < 8) and the up (r >= 8) row of column gi * 8 + r % 8; null past the
// edge.
__device__ __forceinline__ const int8_t* phase_row(const Phase& ph, int gi, int r) {
    if (ph.kind == kW13) {
        const int j = gi * 8 + (r & 7);
        return j < ph.N ? ph.w + ((long long)(r >> 3) * ph.N + j) * ph.K : nullptr;
    }
    const int n = gi * kRowsU + r;
    return n < ph.N ? ph.w + (long long)n * ph.K : nullptr;
}

// The block's contiguous range of units [u0, u1) of a phase; with
// `aligned` (the spans) whole row groups where the phase has at least as
// many groups as blocks, so that no group's sum goes through the partials.
__device__ __forceinline__ void block_range(const Phase& ph, int& u0, int& u1,
                                            bool aligned = false) {
    if (aligned && ph.groups >= static_cast<int>(gridDim.x)) {
        const long long G = ph.groups;
        u0 = static_cast<int>(G * blockIdx.x / gridDim.x) * ph.nch;
        u1 = static_cast<int>(G * (blockIdx.x + 1) / gridDim.x) * ph.nch;
        return;
    }
    const long long T = static_cast<long long>(ph.groups) * ph.nch;
    u0 = static_cast<int>(T * blockIdx.x / gridDim.x);
    u1 = static_cast<int>(T * (blockIdx.x + 1) / gridDim.x);
}

// Everything the phases of one layer read and write (see fd::Linear).
struct Layer {
    fd::Linear lin;      // lin.xq3: h2 quantized [B, H] (K11, K12, K26, K27: in the workspace)
    unsigned* ws;        // the launch's workspace (int32 words, zero between launches)
    Flow* flow;          // this layer's counters
    const Flow* wait_a;  // phase A's activations come from this flow's final quant (K26's
                         // second layer), or null: they are the launch's inputs
    Phase ph[4];
    int p0, p1;          // the phases run, [p0, p1]: A-D, A-C on the last layer; K23 B-C, K24 D
};

// The ring's stage barriers (static shared memory: the cells, which reuse
// the stages' memory, leave them alone); ring_init at the launch's start.
__device__ __forceinline__ uint64_t* ring_barriers() {
    __shared__ __align__(8) uint64_t full[kStagesU];
    return full;
}

__device__ __forceinline__ void ring_init() {
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStagesU; ++s) mbar_init(ring_barriers() + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// Rows of up to kThreads * kRowRegs values are held in registers by the
// row steps: every load of a row is in flight at once (the old steps, one
// L2 round trip per value a thread, took 11-19 us a row on the H100).
constexpr int kRowRegs = 32;

// Where value i of a row lands in a span's int8 activations (K23, K24; K11,
// K12, K26 and K27 keep rows K apart): chunk-major, chunk c of row b at (c
// qrows + b) kSpanPitch from the rows' start, for qrows rows -- so that a
// unit's activation rows are one run of qrows kSpanPitch bytes, which one
// bulk copy brings into a stage.  Relative to row b's start (b kSpanPitch).
__device__ __forceinline__ long long qpos(int i, int qrows) {
    return static_cast<long long>(i / kSpanChunk) * qrows * kSpanPitch + i % kSpanChunk;
}

// K3's rmsnorm + row quant of one row x [n] (scratch) with weight w [n]
// (f32, or bf16 when wbf16): q int8 [n], *s -- fd::rms_quant_row's
// arithmetic in its order (each thread's squares in f64 in ascending i).
__device__ __noinline__ void rms_quant_row(const float* x, const void* w, int wbf16, int n,
                                           int8_t* q, float* s) {
    if (n > kThreads * kRowRegs) {
        fd::rms_quant_row(x, w, wbf16, n, q, s);
        return;
    }
    __shared__ double dred[kWarps];
    __shared__ float fred[kWarps];
    float v[kRowRegs], wv[kRowRegs];
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        const int i = threadIdx.x + kThreads * j;
        v[j] = i < n ? __ldcg(x + i) : 0.f;
        wv[j] = i < n ? fd::load_w(w, i, wbf16) : 0.f;
    }
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        const double d = v[j];
        if (threadIdx.x + kThreads * j < n) ss += d * d;
    }
    FD_STAMP(20);
    const float r = rms_factor(block_sum<kThreads>(ss, dred), n);
    FD_STAMP(21);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        v[j] = __fmul_rn(__fmul_rn(v[j], r), wv[j]);
        amax = fmaxf(amax, fabsf(v[j]));
    }
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        const int i = threadIdx.x + kThreads * j;
        if (i < n) q[i] = quant_i8(v[j], inv);
    }
    if (threadIdx.x == 0) *s = sc;
    FD_STAMP(22);
}

// A span's rmsnorm + row quant of row x [n] into q (qpos layout, qrows
// rows a chunk) and *s where rms_quant_row4 does not apply (x not 16-byte
// aligned, n % 4 != 0): rms_quant_row's long-row passes.
__device__ __noinline__ void span_rms_row(const float* x, const void* w, int wbf16, int n,
                                          int8_t* q, float* s, int qrows) {
    __shared__ double dred[kWarps];
    __shared__ float fred[kWarps];
    double ss = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const double v = __ldcg(x + i);
        ss += v * v;
    }
    const float r = rms_factor(block_sum<kThreads>(ss, dred), n);
    auto xf = [&](int i) { return __fmul_rn(__fmul_rn(__ldcg(x + i), r), fd::load_w(w, i, wbf16)); };
    float amax = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) amax = fmaxf(amax, fabsf(xf(i)));
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
    for (int i = threadIdx.x; i < n; i += kThreads) q[qpos(i, qrows)] = quant_i8(xf(i), inv);
    if (threadIdx.x == 0) *s = sc;
}

// The spans' entering row step: K3's rmsnorm + row quant of row x [n] with
// weight w [n] (f32, or bf16 when wbf16) into q (qpos layout, qrows rows a
// chunk) and *s, in compact passes of 16-byte loads (x 16-byte aligned, n %
// 4 == 0): each thread's float4s in ascending order, their squares in f64
// in order, then the block's sum.  The launch's first code to run, on the
// few blocks the others wait for: its loops stay small where the
// register-held form (rms_quant_row) unrolls a row's every load and store
// (run cold, that code took ~12 us a row on the H100), and the first pass
// keeps x and w in `buf` (2 n floats of shared memory the block's ring does
// not use yet), so that the other two wait behind none of the memory
// traffic the other blocks' rings start.
__device__ __noinline__ void rms_quant_row4(const float* x, const void* w, int wbf16, int n,
                                            int8_t* q, float* s, int qrows, float* buf) {
    __shared__ double dred[kWarps];
    __shared__ float fred[kWarps];
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* xs = reinterpret_cast<float4*>(buf);
    float4* ws = xs + n / 4;
    const int n4 = n / 4;
    double ss = 0.0;
#pragma unroll 8
    for (int j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = __ldcg(x4 + j);
        xs[j] = v;
        ws[j] = make_float4(fd::load_w(w, 4 * j, wbf16), fd::load_w(w, 4 * j + 1, wbf16),
                            fd::load_w(w, 4 * j + 2, wbf16), fd::load_w(w, 4 * j + 3, wbf16));
        ss += (double)v.x * v.x;
        ss += (double)v.y * v.y;
        ss += (double)v.z * v.z;
        ss += (double)v.w * v.w;
    }
    FD_STAMP(20);
    const float r = rms_factor(block_sum<kThreads>(ss, dred), n);  // (its barrier: xs, ws written)
    FD_STAMP(21);
    auto xf = [&](float v, float wv) { return __fmul_rn(__fmul_rn(v, r), wv); };
    float amax = 0.f;
#pragma unroll 8
    for (int j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = xs[j], wv = ws[j];
        amax = fmaxf(fmaxf(fmaxf(amax, fabsf(xf(v.x, wv.x))), fabsf(xf(v.y, wv.y))),
                     fmaxf(fabsf(xf(v.z, wv.z)), fabsf(xf(v.w, wv.w))));
    }
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
#pragma unroll 8
    for (int j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = xs[j], wv = ws[j];
        char4 o;
        o.x = quant_i8(xf(v.x, wv.x), inv);
        o.y = quant_i8(xf(v.y, wv.y), inv);
        o.z = quant_i8(xf(v.z, wv.z), inv);
        o.w = quant_i8(xf(v.w, wv.w), inv);
        *reinterpret_cast<char4*>(q + qpos(4 * j, qrows)) = o;  // 4 j % 4 == 0: one chunk
    }
    if (threadIdx.x == 0) *s = sc;
    FD_STAMP(22);
    fence_proxy_async();  // buf's generic accesses before the ring's copies into it
    __syncthreads();
}

// K2's row quant of one row x [n] (scratch): q int8 [n], *s.
__device__ __noinline__ void quant_row(const float* x, int n, int8_t* q, float* s) {
    if (n > kThreads * kRowRegs) {
        fd::quant_row(x, n, q, s);
        return;
    }
    __shared__ float fred[kWarps];
    float v[kRowRegs];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        const int i = threadIdx.x + kThreads * j;
        v[j] = i < n ? __ldcg(x + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) amax = fmaxf(amax, fabsf(v[j]));
    const float sc = quant_scale(block_max<kThreads>(amax, fred));
    const float inv = quant_inv(sc);
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
        const int i = threadIdx.x + kThreads * j;
        if (i < n) q[i] = quant_i8(v[j], inv);
    }
    if (threadIdx.x == 0) *s = sc;
}

// The rmsnorm + quant of row b of x_next into xq, sx.
__device__ __forceinline__ void rms_row(const fd::Linear& a, const void* w, int b) {
    rms_quant_row(a.x_next + (long long)b * a.D, w, a.rms_bf16, a.D, a.xq + (long long)b * a.D,
                  a.sx + b);
}

// A layer's descriptors and this block's unit ranges, copied once into
// shared memory (read through a pointer to the kernel's parameters or off
// the stack, the loop's fields would be global or local memory loads).
struct LayerShared {
    Phase ph[4];
    fd::Linear lin;
    Flow* flow;
    const Flow* wait_a;
    int p0;           // Layer's
    int u0[4], u1[4];
    int start[5];     // phase p's units are positions [start[p], start[p + 1]) (none outside
                      // [p0, p1]); start[4] positions in all
};

// Thread 0 fills S from the layer (then the block syncs).
__device__ __forceinline__ void fill_shared(LayerShared& S, const Layer& L) {
    S.lin = L.lin;
    S.flow = L.flow;
    S.wait_a = L.wait_a;
    S.p0 = L.p0;
    S.start[0] = 0;
    for (int p = 0; p < 4; ++p) {
        S.ph[p] = L.ph[p];
        block_range(L.ph[p], S.u0[p], S.u1[p], L.p0 != kWo);
        S.start[p + 1] = S.start[p] + (L.p0 <= p && p <= L.p1 ? S.u1[p] - S.u0[p] : 0);
    }
}

// A layer's phases for one block: its unit ranges of the phases in order
// (A, B, C and, but on the last layer, D), streamed through a ring of kST
// stages.  Position i of the sequence is phase p(i)'s unit; the ring's use
// count q0 before the layer (K26's second layer continues the first's) sets
// each stage's barrier parity.  A unit's weight rows are copied as soon as
// its stage is free, also across a phase boundary (the weights need no
// activation); its activation rows once the phase's activations are ready
// (`ready`: the last phase whose are).  kBf16H2: phase B rounds h2 to bf16
// (K12, K26), else keeps it in f32 (K11, K27, K23).  kSpan (K23, K24, whose
// launch writes all its int8 activations itself and so lays them out):
// units of kSpanChunk bytes of K, the activation rows chunk-major (qpos,
// one bulk copy a unit) in the ring's second part, or resident there for a
// phase whose Phase::res is set.
// A lane's row of the warps' sums at a group's end (LayerRun::red): 4 NT
// words, 16 lanes' stores and loads of one word meeting in one bank at NT
// 4; the spans pad it there by a word, so none do (faster at 32 rows on the
// H100; at NT 1, four lanes a bank, the pad measured slower; K12's blocks,
// at the SM's shared-memory limit, keep the unpadded rows).
template <int NT, bool kSpan>
__host__ __device__ constexpr int red_width() {
    return 4 * NT + (kSpan && NT == 4 ? 1 : 0);
}

template <int NT, bool kBf16H2, bool kSpan = false>
struct LayerRun {
    static constexpr int kST = kStagesU;  // the ring's stages
    static constexpr int kCh = unit_chunk<kSpan>();  // bytes of K a unit
    static constexpr int kPitch = kCh + 64;   // a stage's row pitch: conflict-free fragments
    static constexpr int kWK = kCh / kWarps;  // each warp's bytes of a unit's K
    static constexpr int kPc = kWK / 64;      // ... in 64-byte pieces (16 bytes a lane)
    static constexpr int kStage = (kRowsU + 8 * NT) * kPitch;  // 16 weight rows, 8 NT batch rows
    const LayerShared& S;  // the layer's descriptors, in shared memory
    unsigned char* stage;  // [kST][kStage]
    uint64_t* full;        // [kST]
    static constexpr int kRedW = red_width<NT, kSpan>();
    int (*red)[32][kRedW];   // [kWarps][32][kRedW]: the warps' sums at a group's end
    int q0;
    int ready;
    int lane, g, t4, warp;
    uint64_t* rbar;  // kSpan: the resident activations' barrier
    int* rq;         // ... and its use count, carried from row group to row group

    __device__ __forceinline__ int phase_of(int i) const {
        int p = 0;
        while (i >= S.start[p + 1]) ++p;
        return p;
    }

    // Stage s's weight rows and its activation rows (kSpan: every stage's
    // weight rows, then every stage's activation rows -- the part a
    // resident phase's activations take whole).
    __device__ __forceinline__ unsigned char* wst(int s) const {
        return stage + s * (kSpan ? kRowsU * kPitch : kStage);
    }
    __device__ __forceinline__ unsigned char* xst(int s) const {
        return kSpan ? act() + s * 8 * NT * kPitch : wst(s) + kRowsU * kPitch;
    }
    __device__ __forceinline__ unsigned char* act() const {
        return stage + kST * kRowsU * kPitch;
    }

    // Position i's weight rows (warp 0): lanes 0-15 copy a row each, after
    // lane 0 added their bytes to the stage barrier's count without
    // arriving (issue_x arrives).  With vec false (rows not 16-byte
    // multiples or not aligned) the warp copies the bytes itself, zeros past
    // K.
    __device__ __forceinline__ void issue_w(int i) const {
        const int p = phase_of(i);
        const Phase& P = S.ph[p];
        const int u = S.u0[p] + (i - S.start[p]);
        const int gi = u / P.nch, c = u % P.nch;
        const int s = (q0 + i) % kST;
        unsigned char* st = wst(s);
        uint64_t* bar = full + s;
        const int k0 = c * kCh, bytes = min(kCh, P.K - k0);
        if (S.lin.vec) {
            unsigned total = 0;
            for (int r = 0; r < kRowsU; ++r) total += phase_row(P, gi, r) != nullptr ? bytes : 0;
            if (lane == 0) mbar_expect(bar, total);
            __syncwarp();
            if (lane < kRowsU) {
                const int8_t* row = phase_row(P, gi, lane);
                if (row != nullptr) bulk_g2s(st + lane * kPitch, row + k0, bytes, bar);
            }
        } else {
            for (int e = lane; e < kRowsU * kCh; e += 32) {
                const int r = e / kCh, k = e % kCh;
                const int8_t* row = phase_row(P, gi, r);
                st[r * kPitch + k] = row != nullptr && k < bytes ? row[k0 + k] : int8_t(0);
            }
            __syncwarp();
        }
    }

    // Position i's activation rows (warp 0, the phase's activations ready):
    // rows b < B of the unit's chunk (kSpan: one run), then lane 0 arrives
    // with their bytes.
    __device__ __forceinline__ void issue_x(int i) const {
        const int p = phase_of(i);
        const Phase& P = S.ph[p];
        const int u = S.u0[p] + (i - S.start[p]);
        const int c = u % P.nch;
        const int s = (q0 + i) % kST;
        unsigned char* st = xst(s);
        uint64_t* bar = full + s;
        const int k0 = c * kCh, bytes = min(kCh, P.K - k0);
        if (kSpan) {
            const int8_t* src = P.x + (long long)c * S.lin.B * kPitch;
            const unsigned run = static_cast<unsigned>(S.lin.B * kPitch);
            if (S.lin.vec) {
                if (lane == 0) {
                    mbar_expect_tx(bar, run);
                    bulk_g2s(st, src, run, bar);
                }
                __syncwarp();
            } else {
                for (unsigned e = lane; e < run; e += 32) st[e] = __ldcg(src + e);
                __syncwarp();
                if (lane == 0) mbar_arrive(bar);
            }
            return;
        }
        if (S.lin.vec) {
            if (lane == 0) mbar_expect_tx(bar, static_cast<unsigned>(S.lin.B * bytes));
            __syncwarp();
            if (lane < S.lin.B)
                bulk_g2s(st + lane * kPitch, P.x + (long long)lane * P.K + k0, bytes, bar);
        } else {
            for (int e = lane; e < S.lin.B * kCh; e += 32) {
                const int r = e / kCh, k = e % kCh;
                st[r * kPitch + k] = k < bytes ? __ldcg(P.x + (long long)r * P.K + k0 + k)
                                               : int8_t(0);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar);
        }
    }

    // Position i into its stage (warp 0; nothing past the end): the
    // weights, and the activations when its phase's are ready -- or, where
    // they are resident, lane 0's arrival at once.
    __device__ __forceinline__ void issue(int i) const {
        if (i >= S.start[4]) return;
        issue_w(i);
        const int p = phase_of(i);
        if (kSpan && S.ph[p].res) {
            __syncwarp();
            if (lane == 0) mbar_arrive(full + (q0 + i) % kST);
        } else if (p <= ready) {
            issue_x(i);
        }
    }

    // A resident phase's activations (warp 0, the phase's activations
    // ready): its nch chunks of B rows, one run in global memory, into the
    // ring's second part, completing on rbar.
    __device__ __forceinline__ void issue_resident(const Phase& P) const {
        const unsigned run = static_cast<unsigned>(S.lin.B * kPitch);  // one chunk's rows
        if (S.lin.vec) {
            if (lane == 0) mbar_expect_tx(rbar, run * P.nch);
            __syncwarp();
            for (int c = lane; c < P.nch; c += 32)
                bulk_g2s(act() + (long long)c * run, P.x + (long long)c * run, run, rbar);
        } else {
            const long long n = static_cast<long long>(run) * P.nch;
            for (long long e = lane; e < n; e += 32) act()[e] = __ldcg(P.x + e);
            __syncwarp();
            if (lane == 0) mbar_arrive(rbar);
        }
    }

    // Where value e of batch tile t lands: batch row b, column index n in
    // the phase's partial buffer (-1 where it is no output).
    __device__ __forceinline__ void place(const Phase& P, int t, int e, int gi, int& b,
                                          int& n) const {
        b = t * 8 + 2 * t4 + (e & 1);
        if (P.kind == kW13) {
            const int j = gi * 8 + g;
            n = j < P.N ? (e >> 1) * P.N + j : -1;
        } else {
            const int r = gi * kRowsU + g + 8 * (e >> 1);
            n = r < P.N ? r : -1;
        }
        if (b >= S.lin.B) n = -1;
    }

    // The epilogue of group gi from its whole int32 sums (warp 0).
    __device__ __forceinline__ void epilogue(const Phase& P, int gi,
                                             const int (&acc)[NT][4]) const {
        const fd::Linear& a = S.lin;
        if (P.kind == kW13) {
            float mx[NT][2];  // max |h| of the thread's two batch rows of each tile
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                mx[t][0] = mx[t][1] = 0.f;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    int b, n;
                    place(P, t, e, gi, b, n);
                    if (n < 0) continue;
                    const int j = n, H = P.N;
                    const float s = __ldcg(a.sx + b);
                    const float gv =
                        __fmul_rn(__fmul_rn(static_cast<float>(acc[t][e]), s), P.ws[j]);
                    const float uv =
                        __fmul_rn(__fmul_rn(static_cast<float>(acc[t][e + 2]), s), P.ws[H + j]);
                    float hv = __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.f, expf(-gv)))), uv);
                    if (kBf16H2) hv = round_bf16(hv);
                    a.h2[(long long)b * H + j] = hv;
                    mx[t][e] = fabsf(hv);
                }
            }
            // the lanes of one t4 hold the same batch rows: reduce over g
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    float m = mx[t][i];
#pragma unroll
                    for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
                    const int b = t * 8 + 2 * t4 + i;
                    if (g == 0 && b < a.B) atomicMax(S.flow->amax3 + b, __float_as_uint(m));
                }
            return;
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int b, n;
                place(P, t, e, gi, b, n);
                if (n < 0) continue;
                const float v = static_cast<float>(acc[t][e]);
                if (P.kind == kWo) {
                    const long long o = (long long)b * a.D + n;
                    a.x_next[o] = __fadd_rn(__ldcg(a.x + o),
                                            __fmul_rn(__fmul_rn(v, __ldcg(a.satt + b)), P.ws[n]));
                } else if (P.kind == kW2) {
                    const long long o = (long long)b * a.D + n;
                    const float s3 = quant_scale(__uint_as_float(__ldcg(S.flow->amax3 + b)));
                    const float y = __fmul_rn(__fmul_rn(v, s3), P.ws[n]);
                    a.x_next[o] = kSpan ? y : __fadd_rn(__ldcg(a.x_next + o), y);
                } else {
                    a.qkv[(long long)b * a.QO + n] =
                        __fmul_rn(__fmul_rn(v, __ldcg(a.sx + b)), P.ws[n]);
                }
            }
    }

    // The end of the block's share of group gi (chunks [c0, c1)), warp 0 on
    // the block's sums: the epilogue if the share is the whole group, else
    // the share into the partials and, by the block that completes the
    // group, the epilogue of their sum.
    // kSpan: a group whose epilogue this block applied adds one to *fin,
    // which phase() adds to the phase's count once, at its end.
    __device__ __forceinline__ void finish(const Phase& P, int gi, int c0, int c1,
                                           int (&acc)[NT][4], int* fin) const {
        if (c0 != 0 || c1 != P.nch) {
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    int b, n;
                    place(P, t, e, gi, b, n);
                    if (n >= 0 && acc[t][e] != 0)
                        atomicAdd(P.acc + (long long)b * P.nacc + n, acc[t][e]);
                }
            __threadfence();
            __syncwarp();
            unsigned old = 0;
            if (lane == 0) old = atomicAdd(P.tickets + gi, static_cast<unsigned>(c1 - c0));
            old = __shfl_sync(0xffffffffu, old, 0);
            if (old + static_cast<unsigned>(c1 - c0) != static_cast<unsigned>(P.nch)) return;
            __threadfence();
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    int b, n;
                    place(P, t, e, gi, b, n);
                    if (n < 0) continue;
                    int* ptr = P.acc + (long long)b * P.nacc + n;
                    acc[t][e] = __ldcg(ptr);
                    *ptr = 0;  // zero again for the next use
                }
            if (lane == 0) P.tickets[gi] = 0;
        }
        epilogue(P, gi, acc);
        if constexpr (kSpan) {
            ++*fin;
            return;
        }
        __threadfence();
        __syncwarp();
        if (lane == 0) atomicAdd(S.flow->done + P.kind, 1u);
    }

    // Phase p's activations are ready: the activation rows of its units
    // already in the ring (warp 0), and every later issue carries them; or,
    // if the block has units in the phase, the resident copy of them all.
    __device__ __forceinline__ void make_ready(int p, int issued) {
        ready = p;
        if (warp == 0) {
            fence_proxy_async_global();
            if (kSpan && S.ph[p].res) {
                if (S.u1[p] > S.u0[p]) issue_resident(S.ph[p]);
            } else
                for (int i = S.start[p]; i < issued && i < S.start[p + 1]; ++i) issue_x(i);
        }
    }

    // Phase p's units: for each, wait for its stage, multiply the warp's
    // part of its K (kWK bytes of the 16 weight rows and of the batch rows,
    // both from the stage) on the tensor cores; at the end of a group's
    // share the warps' sums meet in shared memory and warp 0 finishes the
    // group; after every unit the block syncs and warp 0 refills the stage
    // kST positions ahead.  `issued` is the first position not yet issued.
    __device__ __forceinline__ void phase(int p, int& issued) const {
        const Phase& P = S.ph[p];
        // the phase's fields in registers (the loop and its refills read them
        // every unit)
        const int kind = P.kind, K = P.K, N = P.N, nch = P.nch;
        const int8_t* W = P.w;
        const int8_t* X = P.x;
        const int u0p = S.u0[p], u1p = S.u1[p], st0 = S.start[p], st1 = S.start[p + 1];
        const int B = S.lin.B, vec = S.lin.vec;
        const bool res = kSpan && P.res;  // the activations resident (act())
        // weight row r (0..15) of group gi, as phase_row
        auto wrow = [&](int gi, int r) -> const int8_t* {
            if (kind == kW13) {
                const int j = gi * 8 + (r & 7);
                return j < N ? W + ((long long)(r >> 3) * N + j) * K : nullptr;
            }
            const int n = gi * kRowsU + r;
            return n < N ? W + (long long)n * K : nullptr;
        };
        // position i of this phase into its stage (warp 0), as issue
        auto refill = [&](int i) {
            if (i >= st1 || !vec) {
                issue(i);
                return;
            }
            const int u = u0p + (i - st0), gi = u / nch, c = u % nch;
            const int s = (q0 + i) % kST;
            unsigned char* st = wst(s);
            uint64_t* bar = full + s;
            const int k0 = c * kCh, bytes = min(kCh, K - k0);
            const int rows = kind == kW13 ? 2 * min(8, N - gi * 8) : min(kRowsU, N - gi * kRowsU);
            const unsigned xb = static_cast<unsigned>(kSpan ? (res ? 0 : B * kPitch) : B * bytes);
            if (lane == 0) mbar_expect_tx(bar, static_cast<unsigned>(rows * bytes) + xb);
            __syncwarp();
            if (lane < kRowsU) {
                const int8_t* row = wrow(gi, lane);
                if (row != nullptr) bulk_g2s(st + lane * kPitch, row + k0, bytes, bar);
            } else if (kSpan) {  // chunk-major activations: one run (none if resident)
                if (lane == kRowsU && !res)
                    bulk_g2s(xst(s), X + (long long)c * B * kPitch, xb, bar);
            } else if (lane - kRowsU < B) {
                const int b = lane - kRowsU;
                bulk_g2s(xst(s) + b * kPitch, X + (long long)b * K + k0, bytes, bar);
            }
            if (!kSpan && B > 16 && lane < B - 16)
                bulk_g2s(xst(s) + (16 + lane) * kPitch, X + (long long)(16 + lane) * K + k0,
                         bytes, bar);
        };
        int acc[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = 0;
        int gi = u0p / nch, c = u0p % nch, c0 = c;
        int fin = 0;  // warp 0: the groups whose epilogue this block applied
        if (res && u1p > u0p) {  // make_ready's copy of the phase's activations
            mbar_wait_bounded(rbar, *rq & 1);
            ++*rq;
        }
#pragma unroll 1
        for (int u = u0p; u < u1p; ++u) {
            const int i = st0 + (u - u0p), q = q0 + i, s = q % kST;
            const int kw = c * kCh + warp * kWK;  // the warp's first byte of K
            const bool ok0 = wrow(gi, g) != nullptr;
            const bool ok1 = wrow(gi, g + 8) != nullptr;
            mbar_wait_bounded(full + s, (q / kST) & 1);
            const unsigned char* st = wst(s) + warp * kWK + t4 * 16;
            const unsigned char* sx =
                (res ? act() + (long long)c * B * kPitch : xst(s)) + warp * kWK + t4 * 16;
#pragma unroll
            for (int h = 0; h < kPc; ++h) {
                const bool in = kw + h * 64 + t4 * 16 < K;
                const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
                const uint4 r0 =
                    ok0 && in ? *reinterpret_cast<const uint4*>(st + g * kPitch + h * 64) : zero;
                const uint4 r1 = ok1 && in
                                     ? *reinterpret_cast<const uint4*>(st + (g + 8) * kPitch + h * 64)
                                     : zero;
                const unsigned a0[4] = {r0.x, r1.x, r0.y, r1.y};
                const unsigned a1[4] = {r0.z, r1.z, r0.w, r1.w};
#pragma unroll
                for (int t = 0; t < NT; ++t) {
                    const int b = t * 8 + g;
                    const uint4 xv = b < B && in
                                         ? *reinterpret_cast<const uint4*>(sx + b * kPitch + h * 64)
                                         : zero;
                    const unsigned b0[2] = {xv.x, xv.y};
                    const unsigned b1[2] = {xv.z, xv.w};
                    mma_s8(acc[t], a0, b0);
                    mma_s8(acc[t], a1, b1);
                }
            }
            const bool end = c == nch - 1 || u + 1 == u1p;
            if (end) {
#pragma unroll
                for (int t = 0; t < NT; ++t)
#pragma unroll
                    for (int e = 0; e < 4; ++e) red[warp][lane][t * 4 + e] = acc[t][e];
                __syncthreads();
                if (warp == 0) {
                    int tot[NT][4];
#pragma unroll
                    for (int t = 0; t < NT; ++t)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            int v = 0;
#pragma unroll
                            for (int w = 0; w < kWarps; ++w) v += red[w][lane][t * 4 + e];
                            tot[t][e] = v;
                        }
                    finish(P, gi, c0, c + 1, tot, &fin);
                }
#pragma unroll
                for (int t = 0; t < NT; ++t)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[t][e] = 0;
            }
            __syncthreads();  // every warp is done with stage s (and the partials)
            if (warp == 0) refill(i + kST);
            if (i + kST + 1 > issued) issued = i + kST + 1;
            if (c == nch - 1) {
                c = c0 = 0;
                ++gi;
            } else {
                ++c;
            }
        }
        if constexpr (kSpan) {  // the groups' count at once: one fence a phase
            if (warp == 0 && fin > 0) {
                __threadfence();
                __syncwarp();
                if (lane == 0) atomicAdd(S.flow->done + kind, static_cast<unsigned>(fin));
            }
        }
        (void)fin;
    }
};

// Row slice [n * blk / NB, n * (blk + 1) / NB) of h2 [B, H] quantized
// with each row's scale (K2's quant of h2, the max known) into xq3.
__device__ __forceinline__ void quant_h2_slice(const fd::Linear& a, const Flow* fl) {
    const long long n = static_cast<long long>(a.B) * a.H;
    const long long e0 = n * blockIdx.x / gridDim.x, e1 = n * (blockIdx.x + 1) / gridDim.x;
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
        const int b = static_cast<int>(e / a.H);
        const float inv = quant_inv(quant_scale(__uint_as_float(__ldcg(fl->amax3 + b))));
        a.xq3[e] = quant_i8(__ldcg(a.h2 + e), inv);
    }
}

// A span's quant_h2_slice, into chunk-major xq3 (qpos).
__device__ __forceinline__ void quant_h2_span(const fd::Linear& a, const Flow* fl) {
    const long long n = static_cast<long long>(a.B) * a.H;
    const long long e0 = n * blockIdx.x / gridDim.x, e1 = n * (blockIdx.x + 1) / gridDim.x;
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
        const int b = static_cast<int>(e / a.H), j = static_cast<int>(e % a.H);
        const float inv = quant_inv(quant_scale(__uint_as_float(__ldcg(fl->amax3 + b))));
        a.xq3[b * kSpanPitch + qpos(j, a.B)] = quant_i8(__ldcg(a.h2 + e), inv);
    }
}

// A span's entry into phase p from the launch's x (rmsnorm weight w, the
// flow's row count cnt): blocks b < B quantize row b (K3's row step), then
// start their rings, while the rest wait on the count (their rings filling
// with weight rows); then the ring's rows of the phase's activations.
template <class Run>
__device__ __forceinline__ void enter(Run& run, const LayerShared& S, int p, const void* w,
                                      unsigned* cnt, int issued) {
    const fd::Linear& a = S.lin;
    if (blockIdx.x < static_cast<unsigned>(a.B)) {
        FD_STAMP(p == kW13 ? 14 : 16);
        const float* x = a.x + (long long)blockIdx.x * a.D;
        int8_t* q = a.xq + (long long)blockIdx.x * kSpanPitch;
        if (a.D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            2 * a.D * 4 <= Run::kST * Run::kStage)
            rms_quant_row4(x, w, a.rms_bf16, a.D, q, a.sx + blockIdx.x, a.B,
                           reinterpret_cast<float*>(run.stage));
        else
            span_rms_row(x, w, a.rms_bf16, a.D, q, a.sx + blockIdx.x, a.B);
        FD_STAMP(p == kW13 ? 15 : 17);
        count_up(cnt);
        if (run.warp == 0)  // the ring the row step went before (span_phases)
            for (int i = 0; i < issued; ++i) run.issue(i);
    }
    wait_geq(cnt, static_cast<unsigned>(a.B));
    FD_STAMP(p == kW13 ? 2 : 7);
    run.make_ready(p, issued);
    FD_STAMP(p == kW13 ? 3 : 8);
}

// Layer l's phases A-D (A-C on the last layer) with their boundaries;
// *q is the ring's use count, carried from layer to layer of a launch.
template <int NT, bool kBf16H2>
__device__ __noinline__ void layer_phases(const LayerShared& S, unsigned char* smem, int* q) {
    __shared__ int red[kWarps][32][4 * NT];
    FD_STAMP(19);
    const fd::Linear& a = S.lin;
    const unsigned B = static_cast<unsigned>(a.B);
    Flow* fl = S.flow;
    LayerRun<NT, kBf16H2> run{S, smem, ring_barriers(), red, *q, S.wait_a != nullptr ? -1 : 0,
                     static_cast<int>(threadIdx.x & 31), static_cast<int>((threadIdx.x & 31) >> 2),
                     static_cast<int>(threadIdx.x & 3), static_cast<int>(threadIdx.x >> 5)};
    fence_proxy_async();  // the cells' shared-memory writes before the ring's copies
    __syncthreads();
    int issued = kStagesU;
    if (run.warp == 0)
        for (int i = 0; i < kStagesU; ++i) run.issue(i);
    // A: x_next = x + (f32(attq . wo) * satt) * wo_s
    if (S.wait_a != nullptr) {
        wait_geq(S.wait_a->rows + 2, B);
        run.make_ready(0, issued);
    }
    FD_STAMP(0);
    run.phase(kWo, issued);
    FD_STAMP(1);
    if (blockIdx.x < B) {
        wait_geq(fl->done + kWo, S.ph[kWo].groups);
        FD_STAMP(14);
        rms_row(a, a.rms_ffn, blockIdx.x);
        FD_STAMP(15);
        count_up(fl->rows + 0);
    }
    FD_STAMP(2);
    // B: h2 = silu(gate) * up (K12: rounded to bf16), max |h2| per row
    wait_geq(fl->rows + 0, B);
    run.make_ready(1, issued);
    FD_STAMP(3);
    run.phase(kW13, issued);
    FD_STAMP(4);
    // C: x_next += (f32(xq3 . w2) * s3) * w2_s: every block quantizes a slice
    // of h2 once phase B is done
    wait_geq(fl->done + kW13, S.ph[kW13].groups);
    quant_h2_slice(a, fl);
    count_up(&fl->xq3);
    wait_geq(&fl->xq3, gridDim.x);
    run.make_ready(2, issued);
    FD_STAMP(5);
    run.phase(kW2, issued);
    FD_STAMP(6);
    if (!a.last) {
        if (blockIdx.x < B) {
            wait_geq(fl->done + kW2, S.ph[kW2].groups);
            FD_STAMP(16);
            rms_row(a, a.rms_att, blockIdx.x);
            FD_STAMP(17);
            count_up(fl->rows + 1);
        }
        FD_STAMP(7);
        // D: qkv = (f32(xq . wqkv) * sx) * qkv_s, layer l + 1
        wait_geq(fl->rows + 1, B);
        run.make_ready(3, issued);
        FD_STAMP(8);
        run.phase(kQkv, issued);
        FD_STAMP(9);
    }
    *q = run.q0 + S.start[4];
}

// A span's phases, entered from the launch's x: K23 B and C (the w2
// partial), K24 D; *q as layer_phases', *rq the resident activations' uses
// of rbar.
template <int NT>
__device__ __noinline__ void span_phases(const LayerShared& S, unsigned char* smem, int* q,
                                         uint64_t* rbar, int* rq) {
    using Run = LayerRun<NT, false, true>;
    __shared__ int red[kWarps][32][Run::kRedW];
    FD_STAMP(19);
    const fd::Linear& a = S.lin;
    Flow* fl = S.flow;
    Run run{S, smem, ring_barriers(), red, *q, 0,
                     static_cast<int>(threadIdx.x & 31), static_cast<int>((threadIdx.x & 31) >> 2),
                     static_cast<int>(threadIdx.x & 3), static_cast<int>(threadIdx.x >> 5),
                     rbar, rq};
    fence_proxy_async();  // an earlier row group's shared-memory writes before the ring's copies
    __syncthreads();
    int issued = run.kST;
    // the row blocks run the row step first, their ring after it (enter)
    const bool row_block = blockIdx.x < static_cast<unsigned>(a.B);
    if (run.warp == 0 && !row_block)
        for (int i = 0; i < issued; ++i) run.issue(i);
    if (S.p0 == kW13) {
        // B: h2 = silu(gate) * up in f32, max |h2| per row
        enter(run, S, kW13, a.rms_ffn, fl->rows + 0, issued);
        run.phase(kW13, issued);
        FD_STAMP(4);
        // C: the w2 partial (f32(xq3 . w2) * s3) * w2_s
        wait_geq(fl->done + kW13, S.ph[kW13].groups);
        quant_h2_span(a, fl);
        count_up(&fl->xq3);
        wait_geq(&fl->xq3, gridDim.x);
        run.make_ready(2, issued);
        FD_STAMP(5);
        run.phase(kW2, issued);
        FD_STAMP(6);
    } else {
        // D: qkv = (f32(xq . wqkv) * sx) * qkv_s
        enter(run, S, kQkv, a.rms_att, fl->rows + 1, issued);
        run.phase(kQkv, issued);
        FD_STAMP(9);
    }
    *q = run.q0 + S.start[4];
}

// The whole layer: a K12 launch's work, or one half of K26's.
struct Step2 {
    Layer lay;           // lay.lin.qkv is scratch [B, QO]: layer l + 1's raw q/k/v
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
    float* cws;          // the cells' split partials [B * KVH * splits * (G * hd + 2 G)]
    int* cticket;        // [B * KVH] their tickets, zero between launches
    int KVH, G, hd, S, layer, TS, splits, nt;  // layer: l + 1; nt: the cells' ring tiles
    float isqrt;         // f32(1 / sqrt(f32(hd)))
};

// Item k of a launch's cells: split sp = splits - 1 - k / (B KVH) of cell
// c = k % (B KVH), slot (c + sp) % B (or c % B) and kv head c / B -- the
// last splits first, which only the longest slots reach, and the slots
// fastest, so that the live items of a few long slots spread evenly over
// the blocks, which take items grid-stride and skip, with no memory round
// trip, a split whose span starts past its slot's rows (`live` splits of a
// cell take part).  The slot turns with the split where the grid is a
// multiple of B (batch 8 on four blocks an SM): without the turn, block j's
// items would all be slot j % B there, and a few blocks would walk every
// long slot's splits.  p: the slot's rows; row0: the cache row of s = 0 of
// (layer, b, h).
__device__ __forceinline__ void cell_of(const Step2& a, int item, int& b, int& h, int& sp,
                                        int& p, long long& row0, int& live) {
    const int B = a.lay.lin.B, cells = B * a.KVH, cell = item % cells;
    const int blocks = (a.S + a.TS - 1) / a.TS;
    sp = a.splits - 1 - item / cells;
    b = gridDim.x % B == 0 ? (cell + sp) % B : cell % B;
    h = cell / B;
    p = min(max(a.pos[b], 0), a.S);
    row0 = (((long long)a.layer * B + b) * a.KVH + h) * a.S;
    const int nb = (p + a.TS - 1) / a.TS;
    live = 1;
    while (live < a.splits &&
           static_cast<int>(static_cast<long long>(live) * blocks / a.splits) < nb)
        ++live;
}

// The end of the cells: blocks b < B wait for every (slot, kv head)
// output, quantize row b of the attention output (K2's quant) into
// attq_next, satt_next and count it on the flow's rows[2].
__device__ __forceinline__ void quant_att_rows(const Step2& a) {
    const fd::Linear& lin = a.lay.lin;
    Flow* fl = a.lay.flow;
    if (blockIdx.x < lin.B) {
        wait_geq(&fl->cells, static_cast<unsigned>(lin.B * a.KVH));
        FD_STAMP(18);
        quant_row(a.att + (long long)blockIdx.x * lin.D, lin.D,
                  a.attq_next + (long long)blockIdx.x * lin.D, a.satt_next + blockIdx.x);
        count_up(fl->rows + 2);
    }
    FD_STAMP(12);
}

// The trailing attention of layer l + 1: items (slot b, kv head h, split)
// grid-stride (cell_of), each building its q rows and the fresh K / V rows
// from qkv (every split of a cell writes the same fresh rows), then the
// split cell; then blocks b < B quantize row b of the attention output.
template <int CH>
__device__ __noinline__ void layer_cells(const Step2& a, unsigned char* smem) {
    __shared__ float red[kThreads / 32];
    const fd::Linear& lin = a.lay.lin;
    Flow* fl = a.lay.flow;
    const int B = lin.B, D = lin.D, QO = lin.QO, KVH = a.KVH, G = a.G, hd = a.hd;
    const int P = dec_pitch<int8_t>(hd), hp = hd / 2, tid = threadIdx.x;
    const int items = B * KVH * a.splits;
    const int blocks = (a.S + a.TS - 1) / a.TS;
    // the first live item's first key rows into L2 while phase D finishes
    int item = blockIdx.x;
    {
        int b, h, sp, p, live;
        long long row0;
        for (; item < items; item += gridDim.x) {
            cell_of(a, item, b, h, sp, p, row0, live);
            if (sp < live) break;
        }
        if (item < items) {
            const int j0 = static_cast<int>(static_cast<long long>(sp) * blocks / a.splits);
            const int r0 = j0 * a.TS, rows = min(a.TS, p - r0);
            for (int r = tid; r < rows; r += kThreads) {
                prefetch_l2(a.kc + (row0 + r0 + r) * hd);
                prefetch_l2(a.vc + (row0 + r0 + r) * hd);
            }
            if (tid == 0 && rows > 0) {
                prefetch_l2(a.kcs + row0 + r0);
                prefetch_l2(a.vcs + row0 + r0);
            }
        }
    }
    wait_geq(fl->done + kQkv, a.lay.ph[kQkv].groups);  // layer l + 1's qkv is complete
    FD_STAMP(10);
    for (; item < items; item += gridDim.x) {
        int b, h, sp, p, live;
        long long row0;
        cell_of(a, item, b, h, sp, p, row0, live);
        if (sp >= live) continue;
        const long long bh = (long long)b * KVH + h;
        const float* row = lin.qkv + (long long)b * QO;
        const float* cs = a.cosr + (long long)b * hp;
        const float* sn = a.sinr + (long long)b * hp;
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
        const float ksc = quant_scale(block_max<kThreads>(fabsf(rk), red));
        const float vsc = quant_scale(block_max<kThreads>(fabsf(rv), red));
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
        // the G query rows of kv head h: roped, scaled, rounded to bf16 --
        // the rows of the cache's scores AND of the fresh column's
        auto fill_q = [&](float* qf, float* qb) {
            for (int e = tid; e < G * P; e += kThreads) {
                const int gq = e / P, d = e % P;
                float v = 0.f;
                if (d < hd) {
                    const float* xh = row + (long long)(h * G + gq) * hd;
                    float r0, r1;
                    rope_pair(__ldcg(xh + (d & ~1)), __ldcg(xh + (d | 1)), cs[d >> 1],
                              sn[d >> 1], r0, r1);
                    v = round_bf16(__fmul_rn(d & 1 ? r1 : r0, a.isqrt));
                }
                qf[e] = v;
                qb[e] = v;
            }
        };
        const bool wrote = split_cell<int8_t, CH>(
            smem, a.nt, sp, fill_q, a.kc + row0 * hd, a.vc + row0 * hd, a.kcs + row0,
            a.vcs + row0, p, a.S, a.TS, G, hd, a.splits, live, kqr, ksc, vqr, vsc,
            a.att + bh * G * hd,
            a.splits > 1 ? a.cws + bh * a.splits * (G * hd + 2 * G) : nullptr,
            a.splits > 1 ? a.cticket + bh : nullptr, DecDenseRows{a.TS});
        if (wrote) {
            count_up(&fl->cells);
        } else {
            __syncthreads();  // shared memory is free for the next item
        }
    }
    FD_STAMP(11);
    quant_att_rows(a);
}

template <int NT, int CH>
__device__ __forceinline__ void step2_layer(const Step2& a, unsigned char* smem, int* q) {
    __shared__ LayerShared S;
    __syncthreads();  // S is free (K26: the first layer's use of it is over)
    if (threadIdx.x == 0) fill_shared(S, a.lay);
    __syncthreads();
    layer_phases<NT, true>(S, smem, q);
    if (!a.lay.lin.last) layer_cells<CH>(a, smem);
}

// The launch's end: the last block out sets the counters of every layer (or
// row group) -- `flows` Flows from ws on -- and the exit count after them
// back to zero for the next launch (no block waits any more).
__device__ __forceinline__ void launch_exit(unsigned* ws, int flows = 2) {
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned* exit = ws + (long long)flows * kFlowWords;
        __threadfence();
        if (atomicAdd(exit, 1u) == gridDim.x - 1) {
            for (long long i = 0; i < (long long)flows * kFlowWords; ++i) ws[i] = 0u;
            *exit = 0u;
            __threadfence();
        }
    }
    FD_STAMP(13);
}

// Shared memory of a K12 or K26 block: the cells' split cell (the linear
// phases use none).  Its ring takes the most tiles (2 to kSplitTiles) that
// keep four blocks an SM, else three, else two, else one.
inline int cell_tiles(int TS, int P, int G) {
    const int caps[4] = {56320, 75776, kSmemTwo, kSmemMax};  // 228 KB / n - 1 KB a block
    for (int cap : caps)
        for (int n = kSplitTiles; n >= 2; --n)
            if (SplitSmem<int8_t>::bytes(n, TS, P, G) <= cap) return n;
    return 0;
}

inline int step2_smem(const Step2& a) {
    const int cell = SplitSmem<int8_t>::bytes(a.nt, a.TS, dec_pitch<int8_t>(a.hd), a.G);
    const int lin = kStagesU * stage_bytes(a.lay.lin.B <= 8 ? 1 : 4);
    return cell > lin ? cell : lin;
}

// The workspace (kept in step with ops/fused_step2.py
// step2_workspace_words): two layers' Flows and the exit count, the tickets
// of every phase's row groups, the int32 partials [32, D], [32, 2H], [32, D],
// [32, QO] (room for kMaxRows rows whatever the launch's B, so the layout
// does not move between launches), then h2 quantized, [B, H] int8.  All but
// the last are zero between launches.
inline int phase_groups(int kind, int D, int H, int QO) {
    return kind == kW13 ? (H + 7) / 8 : ((kind == kQkv ? QO : D) + kRowsU - 1) / kRowsU;
}

// Lays out the tickets of phases [k0, k1] from t on, then their int32
// partials [kMaxRows, nacc] (room for kMaxRows rows whatever the launch's
// B, so the layout does not move between launches), and fills those Phases
// from the layer's Linear, in units of `chunk` bytes of K.  Returns the
// first word past the partials.
inline unsigned* lay_phases(Layer& L, unsigned* t, int k0, int k1, int chunk = kChunkU) {
    const fd::Linear& a = L.lin;
    const int8_t* w[4] = {a.wo, a.w13, a.w2, a.wqkv};
    const float* s[4] = {a.wos, a.w13s, a.w2s, a.wqkvs};
    const int N[4] = {a.D, a.H, a.D, a.QO}, K[4] = {a.D, a.D, a.H, a.D};
    const int nacc[4] = {a.D, 2 * a.H, a.D, a.QO};
    const int8_t* x[4] = {a.attq, a.xq, a.xq3, a.xq};
    int tickets = 0;
    for (int k = k0; k <= k1; ++k) tickets += phase_groups(k, a.D, a.H, a.QO);
    int* acc = reinterpret_cast<int*>(t + (tickets + 3) / 4 * 4);
    for (int k = k0; k <= k1; ++k) {
        Phase& p = L.ph[k];
        p.kind = k;
        p.res = 0;
        p.w = w[k];
        p.ws = s[k];
        p.x = x[k];
        p.N = N[k];
        p.K = K[k];
        p.groups = phase_groups(k, a.D, a.H, a.QO);
        p.nch = (K[k] + chunk - 1) / chunk;
        p.tickets = t;
        p.acc = acc;
        p.nacc = nacc[k];
        t += p.groups;
        acc += (long long)fd::kMaxRows * nacc[k];
    }
    return reinterpret_cast<unsigned*>(acc);
}

// Fills a layer's Phases (A-D, A-C on the last layer) and its xq3 from its
// Linear and the workspace ws.
inline void make_phases(Layer& L, unsigned* ws) {
    L.lin.xq3 = reinterpret_cast<int8_t*>(lay_phases(L, ws + kTicketBase, kWo, kQkv));
    L.ph[kW2].x = L.lin.xq3;
    L.p0 = kWo;
    L.p1 = L.lin.last ? kW2 : kQkv;
}

// Checks a Step2's shapes, fills lay.lin.vec, its phases and the cells'
// ring (nt); 0 or a cudaError_t.
inline int make_step2(Step2& a, unsigned* ws, Flow* flow, const Flow* wait_a) {
    if (a.G < 1 || a.G > kDecMaxG || a.hd < 2 || a.hd % 2 || a.hd > kDecMaxHd || a.TS < 1 ||
        a.TS > 256 || a.KVH < 1 || a.lay.lin.D != a.KVH * a.G * a.hd || a.splits < 1 ||
        a.lay.lin.QO != a.lay.lin.D + 2 * a.KVH * a.hd || ws == nullptr ||
        (a.splits > 1 && (a.cws == nullptr || a.cticket == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (int err = fd::prepare(a.lay.lin)) return err;
    a.nt = cell_tiles(a.TS, dec_pitch<int8_t>(a.hd), a.G);
    if (a.nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    a.lay.ws = ws;
    a.lay.flow = flow;
    a.lay.wait_a = wait_a;
    make_phases(a.lay, ws);
    return 0;
}

// ---------------------------------------------------------------------------
// K23 (fused_ffn.cu) and K24 (fused_rms_qkv.cu): a span of one layer's
// phases on the tensor-parallel decode's local shard, entered from the
// launch's x -- K23 phases B and C (lin.x_next is the w2 partial), K24
// phase D (lin.qkv) -- over any number of rows: groups of kMaxRows, one
// after another in the launch, each re-streaming the weights with its own
// Flow, tickets and partials.
// ---------------------------------------------------------------------------
struct Span {
    Layer lay;          // the first row group's layer
    int B;              // rows in all
    long long stride;   // workspace words of one row group's tickets and partials
    int smem, per_sm;   // the launch's dynamic shared memory and blocks an SM (make_span)
};

__host__ __device__ inline int span_groups(int B) { return (B + fd::kMaxRows - 1) / fd::kMaxRows; }

// A span's int8 activations of width K (xq: D, xq3: H) take this many bytes
// a row of a row group: chunk-major (qpos), kSpanPitch bytes a chunk.
__host__ __device__ inline long long span_act_width(int K) {
    return static_cast<long long>((K + kSpanChunk - 1) / kSpanChunk) * kSpanPitch;
}

// The span workspace (kept in step with ops/fused_layer.py span_layout):
// one Flow per row group, the exit count, then from this word on each row
// group's tickets of the span's phases and their partials (lay_phases); all
// zero between launches.
inline long long span_ticket_base(int groups) { return (long long)groups * kFlowWords + 32; }

// Checks a span's shapes and fills its first row group's layer (phases
// [p0, p1], counters, workspace), stride, shared memory and blocks an SM;
// 0 or a cudaError_t.  The caller sets lay.lin's pointers, widths,
// rms_bf16 and vec.
inline int make_span(Span& s, unsigned* ws, int p0, int p1) {
    fd::Linear& a = s.lay.lin;
    if (s.B < 1 || a.D < 1 || (p0 <= kW2 && a.H < 1) || (p1 == kQkv && a.QO < 1) ||
        ws == nullptr || (a.rms_bf16 != 0 && a.rms_bf16 != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const int groups = span_groups(s.B);
    a.B = s.B < fd::kMaxRows ? s.B : fd::kMaxRows;
    a.last = p1 != kQkv;
    Layer& L = s.lay;
    L.ws = ws;
    L.flow = reinterpret_cast<Flow*>(ws);
    L.wait_a = nullptr;
    L.p0 = p0;
    L.p1 = p1;
    unsigned* t = ws + span_ticket_base(groups);
    s.stride = lay_phases(L, t, p0, p1, kSpanChunk) - t;
    const int nt = a.B <= 8 ? 1 : 4;
    s.smem = kStagesU * span_stage_bytes(nt);
    s.per_sm = nt == 1 ? 2 : 1;
    return 0;
}

// Row group rg's layer: rows [rg kMaxRows, ...) of every row buffer, its
// Flow, tickets and partials; each phase's activations resident where
// span_resident says, for the launch's nt.
__device__ __forceinline__ Layer span_group(const Span& s, int rg, int nt) {
    Layer L = s.lay;
    fd::Linear& a = L.lin;
    const long long r0 = static_cast<long long>(rg) * fd::kMaxRows;
    auto off = [&](auto* p, long long width) { return p == nullptr ? p : p + r0 * width; };
    a.B = min(fd::kMaxRows, s.B - static_cast<int>(r0));
    a.x = off(a.x, a.D);
    a.x_next = off(a.x_next, a.D);
    a.qkv = off(a.qkv, a.QO);
    a.xq = off(a.xq, span_act_width(a.D));
    a.sx = off(a.sx, 1);
    a.h2 = off(a.h2, a.H);
    a.xq3 = off(a.xq3, span_act_width(a.H));
    L.flow = reinterpret_cast<Flow*>(L.ws + static_cast<long long>(rg) * kFlowWords);
    const int8_t* x[4] = {a.attq, a.xq, a.xq3, a.xq};
    for (int p = L.p0; p <= L.p1; ++p) {
        L.ph[p].x = x[p];
        L.ph[p].tickets += rg * s.stride;
        L.ph[p].acc += rg * s.stride;
        L.ph[p].res = span_resident(L.ph[p].nch, a.B, nt);
    }
    return L;
}

// A span launch's body (K23's fused_ffn_kernel, K24's fused_rms_qkv_kernel,
// each __launch_bounds__(kThreads, NT == 1 ? kMinBlocks : 2)): the row
// groups in turn, then the exit.  NT batch tiles of 8 rows: 1 up to 8 rows,
// 4 above (in the first row group).
template <int NT>
__device__ __forceinline__ void span_body(const Span& s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ LayerShared S;
    __shared__ __align__(8) uint64_t rbar;  // the resident activations' barrier
    ring_init();
    if (threadIdx.x == 0) {
        mbar_init(&rbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    int q = 0, rq = 0;  // the ring's and rbar's use counts, carried from row group to row group
    const int groups = span_groups(s.B);
    for (int rg = 0; rg < groups; ++rg) {
        __syncthreads();  // S is free (the last row group's use of it is over)
        if (threadIdx.x == 0) fill_shared(S, span_group(s, rg, NT));
        __syncthreads();
        span_phases<NT>(S, smem, &q, &rbar, &rq);
    }
    launch_exit(s.lay.ws, groups);
}

// Launches a span on the kernel of its NT (k1: NT 1, k4: NT 4), with the
// blocks an SM and shared memory make_span chose.
inline int span_launch(const Span& s, void (*k1)(Span), void (*k4)(Span), void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return fd::coop_launch(s.lay.lin.B <= 8 ? k1 : k4, s, s.smem, st, s.per_sm);
}

}  // namespace f2
