// K25: x @ W with W in the Q8_0 format (group-wise INT8 along the
// contraction), dequantized inside the kernel.
//
// Replaces tpu_llama/ops/matmul.py:142 q8_matmul (its Pallas kernel
// _q8_matmul_kernel, matmul.py:120).  Contract:
//   w[n, k]   = bf16(bf16(q[n, k]) * bf16(s[n, k / g]))
//   out[m, n] = cast(sum_k f32(bf16(x[m, k])) * f32(w[n, k]))
// -- the TPU kernel's arithmetic: q and s are each cast to bf16 and
// multiplied in bf16 (one rounding), x is cast to bf16, the products are
// exact in f32 and the sum is taken in f32, then cast once to the output
// type.  A kernel that dequantized in f32 would differ in the last bits of
// every weight.  q int8 [Np, K] is K-major (the transpose of the JAX
// package's [IN, OUT]) with K the padded in-dim (a multiple of 128 and of
// g) and Np the padded out-dim (a multiple of 128); s f32 [Np, K / g]; x
// [M, K] f32 or bf16, zero past its logical in-dim; out [M, N] f32 or bf16
// with N <= Np the logical out-dim.
//
// Two kernels, by M:
// * M <= 16 (decode), q8_gemv_kernel.  Bound on the H100: bytes -- every
//   weight byte and its share 4 / g of a scale, read once (w13 4096 x 22016
//   at g 64: 95.8 MB, 28.6 us at 3.35 TB/s).  Design: a bandwidth kernel.
//   A block owns 32 weight rows and its sixteen warps split K between them
//   (warp w takes every sixteenth 64-wide chunk, so the block reads each
//   row in whole 1 KB runs): the 4096-deep products take one round of
//   loads a warp, and the small out-dims (wo, w2: N = 4096) still launch
//   128 blocks.  The weights are the m16n8k16 mma's A (two 16-row tiles a
//   warp, which share every x fragment: x, re-read by every block from L2,
//   is read once per 32 weight rows) and x its B (8 columns: M <= 8 wastes
//   no column): each lane loads 16 contiguous int8 of each of its four rows
//   with one 16-byte streaming load (no shared memory, four chunks in flight
//   a warp) and dequantizes them in registers; the k order inside each chunk is
//   permuted, the same for both operands (lane tg's bytes 16 tg + 4 u + e
//   are step u's k = 2 tg, 2 tg + 1, 2 tg + 8, 2 tg + 9), so that x's B
//   fragment is four neighbouring elements of one row.  The warps' partial
//   sums meet in shared memory and are added in warp order.
// * M > 16 (prefill), q8_matmul_wgmma_kernel.  Bound on the H100: bf16
//   tensor-core operations (w13 at M 4096: 739 GFLOP, 0.75 ms at 989
//   TFLOP/s).  Design: a wgmma + TMA mixed-input GEMM computing out^T =
//   W x^T, so that the quantized operand is wgmma's A, which may come from
//   registers.  The wrapper casts x to bf16 once (the rounding the contract
//   applies, and half of an f32 x's traffic) and in the same copy permutes
//   its k order within each 16 (logical k 8 h + 2 t + e holds element 4 t +
//   2 h + e), which a dot does not see and which makes each lane's weight
//   fragment of a k16 step four neighbouring bytes.  A block of three
//   warpgroups owns a 128 (n) x 256 (m) output tile: one producer thread
//   (its warpgroup's registers given to the others, setmaxnreg) starts TMA
//   loads of the int8 weight tile (128 x 64, 64-byte swizzle) and the bf16
//   x tile (256 x 64, 128-byte swizzle, rows past M zero-filled) into a
//   ring of kStages stages, each completing on an mbarrier; two consumer
//   warpgroups own 64 weight rows each, dequantize their rows of a k-tile
//   from shared memory straight into wgmma A fragments (with the group
//   scale, the contract's two roundings) while the previous k-tile's four
//   wgmma m64n256k16 run, and free the stage on an "empty" mbarrier once
//   its wgmma has read it.  No bf16 copy of W exists anywhere.  Blocks are
//   ordered along M within groups of kGroupN column blocks, so a weight
//   tile is reused from L2 by the m-blocks running beside it instead of
//   streaming from HBM once per m-block.  The epilogue masks rows past M and
//   columns past N.
#include "hopper.cuh"

namespace {

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// Int8 byte i of w (w already xor 0x80808080) as an exact float: the byte
// is the low byte of 2^23 + 128 + q, from which one subtraction leaves q.
__device__ __forceinline__ float i8_at(unsigned wx, int i) {
    return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// Four int8 weights (one word, bytes in k order) dequantized with the bf16
// scale sb as two bf16 pairs: each bf16(q) * sb is exact in f32 (8 x 8
// significant bits), then rounded once.
__device__ __forceinline__ uint2 deq4(unsigned w, float sb) {
    const unsigned wx = w ^ 0x80808080u;
    return make_uint2(pack_bf16(i8_at(wx, 0) * sb, i8_at(wx, 1) * sb),
                      pack_bf16(i8_at(wx, 2) * sb, i8_at(wx, 3) * sb));
}

// ---------------------------------------------------------------------------
// The decode kernel (M <= 16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of weights, read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
}

// 16 consecutive elements of an x row (16-byte aligned) as 8 bf16 pairs
__device__ __forceinline__ void x16(const float* p, unsigned (&o)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
        o[2 * i] = pack_bf16(v.x, v.y);
        o[2 * i + 1] = pack_bf16(v.z, v.w);
    }
}
__device__ __forceinline__ void x16(const __nv_bfloat16* p, unsigned (&o)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        o[4 * i] = v.x;
        o[4 * i + 1] = v.y;
        o[4 * i + 2] = v.z;
        o[4 * i + 3] = v.w;
    }
}

namespace gemv {
constexpr int kRows = 32;    // weight rows a block owns: two mma A tiles a warp
constexpr int kWarps = 16;   // each over every sixteenth 64-wide chunk of k
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // chunks a warp has in flight
}  // namespace gemv

// MT = x row tiles of 8 (1: M <= 8, 2: M <= 16)
template <typename XT, typename OT, int MT>
__global__ void __launch_bounds__(gemv::kThreads, 1)
q8_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, OT* __restrict__ out, int M, int N, int K, int g) {
    using namespace gemv;
    __shared__ float red[kWarps][MT][2][32][4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, tg = lane & 3;
    const int n0 = blockIdx.x * kRows;
    const int KG = K / g, nch = K / 64;
    // row gr + 8 r (r = 0..3): A tile r / 2, half r % 2
    const int8_t* w = q + (long long)(n0 + gr) * K + 16 * tg;
    const float* sr = s + (long long)(n0 + gr) * KG;
    const XT* xr[MT];
    bool xin[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + gr;
        xin[mt] = m < M;
        xr[mt] = x + (long long)(xin[mt] ? m : 0) * K + 16 * tg;
    }
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][rt][e] = 0.f;

    for (int c = warp; c < nch; c += kWarps * kUnroll) {
        uint4 wv[kUnroll][4];
        float sv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // the weights' loads of the kUnroll chunks first
            const int cc = c + kWarps * u;
            if (cc < nch) {
                const int k = cc * 64, kg = (k + 16 * tg) / g;  // the lane's 16 k: one group
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    wv[u][r] = ld_stream(w + 8LL * r * K + k);
                    sv[u][r] = __ldg(sr + 8LL * r * KG + kg);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int cc = c + kWarps * u;
            if (cc < nch) {
                unsigned xf[MT][8];  // x (L1 / L2), shared by the two A tiles
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if (xin[mt]) {
                        x16(xr[mt] + cc * 64, xf[mt]);
                    } else {
#pragma unroll
                        for (int i = 0; i < 8; ++i) xf[mt][i] = 0u;
                    }
                }
#pragma unroll
                for (int rt = 0; rt < 2; ++rt) {
                    const float ra = round_bf16(sv[u][2 * rt]), rb = round_bf16(sv[u][2 * rt + 1]);
                    const uint4 a4 = wv[u][2 * rt], b4 = wv[u][2 * rt + 1];
                    const unsigned wav[4] = {a4.x, a4.y, a4.z, a4.w};
                    const unsigned wbv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        // A: rows gr (a0, a2) and gr + 8 (a1, a3) of tile rt at
                        // the step's k pairs (bytes 4 t, 4 t + 1 and 4 t + 2, 4 t + 3)
                        const uint2 da = deq4(wav[t], ra), db = deq4(wbv[t], rb);
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt)
                            mma_bf16(acc[mt][rt], da.x, db.x, da.y, db.y, xf[mt][2 * t],
                                     xf[mt][2 * t + 1]);
                    }
                }
            }
        }
    }

    // the warps' partial sums, added in warp order; c[e] of tile rt sits at
    // weight row 16 rt + gr + 8 (e / 2) and x row 8 mt + 2 tg + e % 2
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int e = 0; e < 4; ++e) red[warp][mt][rt][lane][e] = acc[mt][rt][e];
    __syncthreads();
    for (int i = tid; i < MT * 256; i += kThreads) {
        const int mt = i / 256, rt = (i / 128) % 2, ln = (i / 4) % 32, e = i % 4;
        float v = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) v += red[wi][mt][rt][ln][e];
        const int n = n0 + 16 * rt + (ln >> 2) + 8 * (e >> 1), m = mt * 8 + 2 * (ln & 3) + (e & 1);
        if (n < N && m < M) store_as(out + (long long)m * N + n, v);
    }
}

template <typename XT, typename OT, int MT>
int launch_gemv(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int K,
                int g, cudaStream_t st) {
    const int blocks = (N + gemv::kRows - 1) / gemv::kRows;
    q8_gemv_kernel<XT, OT, MT><<<blocks, gemv::kThreads, 0, st>>>(
        static_cast<const XT*>(x), q, s, static_cast<OT*>(out), M, N, K, g);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The prefill kernel (M > 16): wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BN = 128;  // weight rows (output columns) a block owns: two warpgroups of 64
constexpr int BM = 256;  // x rows (output rows) a block owns: wgmma's N
constexpr int BK = 64;   // k a stage holds (x rows of 128 bytes: one 128-byte swizzle span)
constexpr int kStages = 5;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 * 40 + 256 * 232 <= 64K
constexpr int kThreads = 3 * 128;  // the producer warpgroup, two consumers
constexpr int kXTile = BM * BK * 2;
constexpr int kWTile = BN * BK;
constexpr int kStageBytes = kXTile + kWTile;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // + alignment slack
constexpr int kGroupN = 16;  // column blocks of a raster group
}  // namespace wg

// d (64 x 256 f32) += a (64 x 16 bf16, registers) * b (16 x 256 bf16, K-major
// in shared memory)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const unsigned (&a)[4],
                                                 uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Compiler barriers around an asynchronous wgmma's registers: the
// accumulators' reads stay after the wait_group before them, and the A
// fragments stay live (their registers not reused) until the wait_group
// after the wgmma that reads them -- the compiler sees the wgmma consume
// them when it is launched, the hardware reads them later.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(unsigned (&a)[4][4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[t][i])::"memory");
}

// Byte offset of (row r, byte b) of a 64-byte-row tile in TMA's 64-byte
// swizzle: the 16-byte chunk index is xored with bits 7-8 of the offset
__device__ __forceinline__ int sw64(int r, int b) {
    return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// A consumer thread's A fragments of one k-tile: rows r and r + 8 of the
// stage's weight tile (r = the warp's 16 rows' gr), for the four k16 steps
// t (the mma.m16n8k16 A layout, warp w of the warpgroup owning rows
// 16 w .. 16 w + 15): a0 / a1 rows r / r + 8 at logical k 2 tg, + 1; a2 /
// a3 at logical k 2 tg + 8, + 9.  x's k order is permuted within each 16
// (by the wrapper), so those four logical k are the weights' bytes 4 tg ..
// 4 tg + 3 of the step: one 32-bit load a row.  sc[h][j]: the bf16-rounded
// scales of row r + 8 h for the tile's j-th group.
template <int SPT>
__device__ __forceinline__ void dequant_tile(const int8_t* wt, int r, int tg,
                                             const float (&sc)[2][SPT], unsigned (&a)[4][4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int j = t * SPT / 4;  // the 16-run's group (g = 64 / SPT >= 16)
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // row r + 8 i
            const uint2 d = deq4(*reinterpret_cast<const unsigned*>(wt + sw64(r + 8 * i, 16 * t + 4 * tg)),
                                 sc[i][j]);
            a[t][i] = d.x;
            a[t][2 + i] = d.y;
        }
    }
}

// SPT = scales per row and k-tile (64 / g)
template <typename OT, int SPT>
__global__ void __launch_bounds__(wg::kThreads, 1)
q8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ s,
                       OT* __restrict__ out, int M, int N, int K) {
    using namespace wg;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    unsigned char* xs = base;                      // [kStages][BM][BK] bf16, 128-byte swizzle
    int8_t* ws = reinterpret_cast<int8_t*>(base + kStages * kXTile);  // [kStages][BN][BK]
    uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
    uint64_t* empty = full + kStages;

    // raster: groups of kGroupN column blocks, m slower within a group
    const int num_n = (N + BN - 1) / BN, num_m = (M + BM - 1) / BM;
    const int per_group = kGroupN * num_m;
    const int grp = blockIdx.x / per_group, first_n = grp * kGroupN;
    const int gsz = min(num_n - first_n, kGroupN);
    const int in_grp = blockIdx.x % per_group;
    const int nb = first_n + in_grp % gsz, mb = in_grp / gsz;
    const int n0 = nb * BN, m0 = mb * BM;
    const int nk = K / BK;

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < kStages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 8);  // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg_id = tid / 128;
    if (wg_id == 0) {
        // the producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (tid == 0) {
            for (int kt = 0; kt < nk; ++kt) {
                const int st = kt % kStages;
                if (kt >= kStages) mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
                mbar_expect_tx(&full[st], kStageBytes);
                tma_load(xs + st * kXTile, &xmap, kt * BK, m0, &full[st]);
                tma_load(ws + st * kWTile, &wmap, kt * BK, n0, &full[st]);
            }
        }
        return;
    }

    // a consumer: weight rows c * 64 + 16 w + gr (+ 8) of the block's 128
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg_id - 1, lane = tid & 31, w = (tid >> 5) & 3;
    const int gr = lane >> 2, tg = lane & 3;
    const int r = c * 64 + w * 16 + gr;
    const int KG = K / (BK / SPT);
    const float* srow = s + (long long)(n0 + r) * KG;  // row r's scales; row r + 8's 8 KG on

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float sc[2][SPT];
    auto load_scales = [&](int kt) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < SPT; ++j)
                sc[i][j] = round_bf16(__ldg(srow + 8LL * i * KG + kt * SPT + j));
    };
    unsigned a_cur[4][4], a_nxt[4][4];
    load_scales(0);
    mbar_wait(&full[0], 0);
    dequant_tile<SPT>(ws, r, tg, sc, a_cur);
    if (nk > 1) load_scales(1);
    for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        fence_acc(acc);
        fence_frag(a_cur);
        wgmma_fence();
        const uint64_t db = desc_sw128(xs + st * kXTile);
#pragma unroll
        for (int t = 0; t < 4; ++t) wgmma_m64n256k16(acc, a_cur[t], db + 2 * t);  // + 32 bytes
        wgmma_commit();
        if (kt + 1 < nk) {  // the next tile's fragments while the wgmma runs
            const int sn = (kt + 1) % kStages;
            mbar_wait(&full[sn], ((kt + 1) / kStages) & 1);
            dequant_tile<SPT>(ws + sn * kWTile, r, tg, sc, a_nxt);
            if (kt + 2 < nk) load_scales(kt + 2);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        fence_frag(a_cur);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) a_cur[t][i] = a_nxt[t][i];
    }

    // acc[4 j + e] = D(row r + 8 (e / 2), column 8 j + 2 tg + e % 2): out[m, n]
    // with n the weight row and m the x row
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = n0 + r + 8 * (e >> 1), m = m0 + 8 * j + 2 * tg + (e & 1);
            if (n < N && m < M) store_as(out + (long long)m * N + n, acc[4 * j + e]);
        }
}

template <typename OT, int SPT>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const float* s, void* out, int M,
                 int N, int K, cudaStream_t st) {
    auto kern = q8_matmul_wgmma_kernel<OT, SPT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = ((N + wg::BN - 1) / wg::BN) * ((M + wg::BM - 1) / wg::BM);
    kern<<<blocks, wg::kThreads, wg::kSmem, st>>>(xm, wm, s, static_cast<OT*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
}

template <typename OT>
int dispatch_wgmma(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                   int Np, int K, int g, cudaStream_t st) {
    CUtensorMap xm, wm;
    if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, wg::BM, wg::BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, Np, K, wg::BN, wg::BK,
                  CU_TENSOR_MAP_SWIZZLE_64B))
        return static_cast<int>(cudaErrorInvalidValue);
    if (g == 64) return launch_wgmma<OT, 1>(xm, wm, s, out, M, N, K, st);
    if (g == 32) return launch_wgmma<OT, 2>(xm, wm, s, out, M, N, K, st);
    return launch_wgmma<OT, 4>(xm, wm, s, out, M, N, K, st);
}

template <typename XT, typename OT>
int dispatch_gemv(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                  int K, int g, cudaStream_t st) {
    if (M <= 8) return launch_gemv<XT, OT, 1>(x, q, s, out, M, N, K, g, st);
    return launch_gemv<XT, OT, 2>(x, q, s, out, M, N, K, g, st);
}

}  // namespace

// x [M, K] (contiguous, 16-byte aligned; f32 or bf16 for M <= 16, bf16 for
// M > 16), q int8 [Np, K] (16-byte aligned), s f32 [Np, K / g], out [M, N]
// (f32 or bf16); the wrapper checks g in {16, 32, 64}, K % 128 == 0,
// K % g == 0 and N <= Np.
extern "C" int tl_q8_matmul(const void* x, int x_dtype, const int8_t* q, const float* s,
                            void* out, int out_dtype, int M, int N, int Np, int K, int g,
                            void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (K <= 0 || K % 128 || (g != 16 && g != 32 && g != 64) || N > Np || Np % 128)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M > 16) {
        if (x_dtype != TL_BF16) return static_cast<int>(cudaErrorInvalidValue);
        if (out_dtype == TL_F32) return dispatch_wgmma<float>(x, q, s, out, M, N, Np, K, g, st);
        if (out_dtype == TL_BF16)
            return dispatch_wgmma<__nv_bfloat16>(x, q, s, out, M, N, Np, K, g, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (x_dtype == TL_F32 && out_dtype == TL_F32)
        return dispatch_gemv<float, float>(x, q, s, out, M, N, K, g, st);
    if (x_dtype == TL_F32 && out_dtype == TL_BF16)
        return dispatch_gemv<float, __nv_bfloat16>(x, q, s, out, M, N, K, g, st);
    if (x_dtype == TL_BF16 && out_dtype == TL_F32)
        return dispatch_gemv<__nv_bfloat16, float>(x, q, s, out, M, N, K, g, st);
    if (x_dtype == TL_BF16 && out_dtype == TL_BF16)
        return dispatch_gemv<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, M, N, K, g, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
