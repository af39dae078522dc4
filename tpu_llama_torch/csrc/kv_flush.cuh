// The decode step's KV row flush, shared by K10 (kv_flush_rows.cu, the
// dense cache) and K14 (kv_pool_flush_rows.cu, the page pool): every
// layer's fresh K and V row of every slot (and for an INT8 cache their f32
// scales) stored at the slot's position, in place, in one launch.
//
// What bounds it on the H100.  At Llama-2 7B batch 8 the INT8 flush reads
// 2.2 MB of rows, warm in the L2 (the step's own kernels just wrote them),
// and writes 16K rows of 128 bytes, each in its own 256 KB region of the
// cache (one per layer, slot and head), plus 16K scale words: every byte
// once at 3.35 TB/s is 1.1 us.  The stamps (k12_phases.py --kernel k10 /
// k14) put pos and the rows in hand ~0.45 us after the first block starts
// and the last store done at ~2.0 us: the drain of the scattered stores
// (~1.4 TB/s) sets the time, not the loads.  An L2 trip costs ~0.1-0.15 us
// here, so the TPU kernel's order carried over (pos, then the page entry,
// then the rows, then the scales in a second pass) lost ~0.3 us, not the
// ~2 us the trace's 3 us once suggested.
//
// Design: one thread a copy unit of K and the same unit of V (16-byte
// vectors where a row's bytes allow, else elements) on the grid (units of
// a (layer, slot) / kThreads, B, L): at 7B every thread moves one vector of
// each, and the thread of a row's unit 0 its scale pair.  Every load is
// issued before any returns (volatile PTX, so none is sunk below the test
// of pos): pos[b] and -- paged, up to 32 pages a slot -- the slot's table
// row (lane j of each warp holds entry j; the page is a shuffle once pos is
// in hand) first, as they are few and would wait behind the rows' vectors,
// then the rows and their scales.  One trip lies between the launch and
// the stores.
//
// -DKV_STAMPS (k12_phases.py --kernel k10 / k14; no committed build passes
// it) records %globaltimer per block at four events: 0 the block's start,
// 1 pos (and the page) in hand, 2 the rows in registers, 3 the stores done
// (after a fence).
#pragma once

#include "common.cuh"

namespace kvf {

constexpr int kThreads = 256;

constexpr int kStampEvents = 4;
constexpr int kStampBlocks = 2048;
#ifdef KV_STAMPS
__device__ unsigned long long kv_stamps[kStampBlocks * kStampEvents];
// every thread of the block reaches each stamp (no early return in the kernel)
#define KV_STAMP(i)                                                                        \
    do {                                                                                   \
        __syncthreads();                                                                   \
        const unsigned blk_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \
        if (threadIdx.x == 0 && blk_ < kvf::kStampBlocks) {                                \
            unsigned long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                         \
            kvf::kv_stamps[blk_ * kvf::kStampEvents + (i)] = t_;                           \
        }                                                                                  \
    } while (0)
// an instruction that reads x: waits for the load that writes it
#define KV_TOUCH(x) asm volatile("mov.b32 %0, %0;" : "+r"(x))
#else
#define KV_STAMP(i) \
    do {            \
    } while (0)
#define KV_TOUCH(x) \
    do {            \
    } while (0)
#endif

// Loads that stay where they are written (volatile: not sunk past a branch).
__device__ __forceinline__ uint4 load_unit(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}
__device__ __forceinline__ float load_unit(const float* p) {
    float v;
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ int8_t load_unit(const int8_t* p) {
    int v;
    asm volatile("ld.global.nc.s8 %0, [%1];\n" : "=r"(v) : "l"(p));
    return static_cast<int8_t>(v);
}
__device__ __forceinline__ __nv_bfloat16 load_unit(const __nv_bfloat16* p) {
    unsigned short v;
    asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
    return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ int load_int(const int* p) {
    int v;
    asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
}

#ifdef KV_STAMPS
__device__ __forceinline__ void touch(uint4& v) {
    KV_TOUCH(v.x);
    KV_TOUCH(v.w);
}
__device__ __forceinline__ void touch(float& v) { asm volatile("mov.f32 %0, %0;" : "+f"(v)); }
__device__ __forceinline__ void touch(int8_t& v) {
    int w = v;
    KV_TOUCH(w);
    v = static_cast<int8_t>(w);
}
__device__ __forceinline__ void touch(__nv_bfloat16& v) {
    unsigned short w = __bfloat16_as_ushort(v);
    asm volatile("mov.b16 %0, %0;" : "+h"(w));
    v = __ushort_as_bfloat16(w);
}
#endif

// Where a flush writes.  Dense (K10): cache [L, B, KVH, S(, hd)], the row
// (l, b, h, pos) at row index r * S + pos for the source row r = (l * B + b)
// * KVH + h; a pos outside [0, S) is skipped.  Paged (K14): pool
// [L, P, KVH, ps(, hd)], page = pos / ps < MP ? table[b, pos / ps] : 0 (past
// the slot's table: the trash page 0), row ((l * P + page) * KVH + h) * ps +
// pos % ps; a negative pos or a page outside [0, P) is skipped.
struct Flush {
    const void* rk;
    const void* rv;
    const float* rks;  // null for an fp cache
    const float* rvs;
    const int* pos;
    const int* table;  // paged only
    void* ck;
    void* cv;
    float* cks;
    float* cvs;
    int B, KVH, units;  // units: copy units (vectors or elements) a row
    int S;              // dense: the cache's S; paged: ps
    int P, MP;          // paged only
};

// One thread's unit of the flush; every thread of the block calls (the
// stamps' barriers), with U the copy unit: uint4, or the element type.
template <typename U, bool kPaged>
__device__ __forceinline__ void flush_rows(const Flush& a) {
    KV_STAMP(0);
    const int b = blockIdx.y, l = blockIdx.z, lane = threadIdx.x & 31;
    const int e = blockIdx.x * kThreads + threadIdx.x;  // (head, unit) within (l, b)
    const int h = e / a.units, u = e - h * a.units;
    const bool live = h < a.KVH;
    const bool scales = a.rks != nullptr && u == 0;
    const long long r = (static_cast<long long>(l) * a.B + b) * a.KVH + h;  // source row
    const U* rk = static_cast<const U*>(a.rk) + r * a.units + u;
    const U* rv = static_cast<const U*>(a.rv) + r * a.units + u;
    // pos and (paged) the slot's table row first: they are few, and the
    // rows' 16-byte loads queued ahead of them would delay them
    int p = load_int(a.pos + b);
    const int* row = kPaged ? a.table + static_cast<long long>(b) * a.MP : nullptr;
    int t = 0;  // lane j < MP of every warp holds table[b, j]
    if (kPaged && a.MP <= 32 && lane < a.MP) t = load_int(row + lane);
    U k{}, v{};
    float ks = 0.f, vs = 0.f;
    if (live) {
        k = load_unit(rk);
        v = load_unit(rv);
        if (scales) {
            ks = load_unit(a.rks + r);
            vs = load_unit(a.rvs + r);
        }
    }
    int page = 0;
    if constexpr (kPaged) {
        const int col = p >= 0 ? p / a.S : 0;  // p is one value across the block
        if (a.MP <= 32) {
            page = __shfl_sync(0xffffffffu, t, col < a.MP ? col : 0);
            if (col >= a.MP) page = 0;  // past the table: the trash page
        } else if (col < a.MP) {  // a longer table: its entry once pos is in hand
            page = load_int(row + col);
        }
    }
#ifdef KV_STAMPS
    KV_TOUCH(p);
    KV_TOUCH(page);
#endif
    KV_STAMP(1);
#ifdef KV_STAMPS
    touch(k);
    touch(v);
    if (scales) {
        touch(ks);
        touch(vs);
    }
#endif
    KV_STAMP(2);
    long long d;  // destination row index
    bool act;
    if constexpr (kPaged) {
        act = live && p >= 0 && page >= 0 && page < a.P;
        d = ((static_cast<long long>(l) * a.P + page) * a.KVH + h) * a.S + p % a.S;
    } else {
        act = live && p >= 0 && p < a.S;
        d = r * a.S + p;
    }
    if (act) {
        static_cast<U*>(a.ck)[d * a.units + u] = k;
        static_cast<U*>(a.cv)[d * a.units + u] = v;
        if (scales) {
            a.cks[d] = ks;
            a.cvs[d] = vs;
        }
    }
#ifdef KV_STAMPS
    __threadfence();
#endif
    KV_STAMP(3);
}

// The grid of a flush of L layers with rows of hd elements of elem bytes:
// 16-byte units when vec (rows a multiple of 16 bytes, 16-byte aligned
// pointers), else one element a unit; sets a.units.
inline dim3 flush_grid(Flush& a, int L, int hd, int elem, int vec) {
    a.units = vec ? hd * elem / 16 : hd;
    return dim3((a.KVH * a.units + kThreads - 1) / kThreads, a.B, L);
}

}  // namespace kvf

#ifdef KV_STAMPS
// The development stamps into host memory: n values of kv_stamps.
#define KV_STAMPS_READER(name)                                                          \
    extern "C" int name(unsigned long long* out, int n) {                               \
        return static_cast<int>(                                                        \
            cudaMemcpyFromSymbol(out, kvf::kv_stamps, sizeof(unsigned long long) * n)); \
    }
#else
#define KV_STAMPS_READER(name)
#endif
