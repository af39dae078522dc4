// Bare streams of a row quant's bytes, for tpu_llama_torch/stream_probe.py:
// no kernel of the port, a yardstick of what the card's memory gives a pass
// that reads `in_bytes` and writes half as many (K2 on bf16: 2 bytes in, 1
// out an element).  Built by the probe alone (not one of ops/_kernels.py's
// SOURCES).
//
// - stream_rrw: read-reduce-write.  Each thread of a persistent grid walks
//   units of 32 input bytes (two 16-byte loads, L1 not allocated) and writes
//   16 (the high byte of each bf16: one 16-byte store), `unroll` units' loads
//   issued before the first is used.
// - stream_ring: a 1D bulk-copy ring.  Each block walks pieces of `piece`
//   input bytes (one bf16 row of 4096 = 8 KB), `stages` of them in flight in
//   shared memory, each a cp.async.bulk completing on an mbarrier; the
//   block's threads read a piece from shared memory and write its half-size
//   output in 16-byte stores.
#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint4 ld16(const void* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

// the high bytes of the eight bf16 of a and the eight of b
__device__ __forceinline__ uint4 high_bytes(uint4 a, uint4 b) {
    return make_uint4(__byte_perm(a.x, a.y, 0x7531), __byte_perm(a.z, a.w, 0x7531),
                      __byte_perm(b.x, b.y, 0x7531), __byte_perm(b.z, b.w, 0x7531));
}

template <int U>
__global__ void __launch_bounds__(256) stream_rrw(const uint4* __restrict__ in,
                                                  uint4* __restrict__ out, long long units) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long u0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         u0 < units; u0 += stride * U) {
        uint4 a[U], b[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long u = u0 + stride * k;
            if (u < units) {
                a[k] = ld16(in + 2 * u);
                b[k] = ld16(in + 2 * u + 1);
            }
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long u = u0 + stride * k;
            if (u < units) out[u] = high_bytes(a[k], b[k]);
        }
    }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

constexpr int kMaxStages = 16;

__global__ void __launch_bounds__(256) stream_ring(const unsigned char* __restrict__ in,
                                                   unsigned char* __restrict__ out,
                                                   long long pieces, int piece, int stages) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t full[kMaxStages];
    const long long first = blockIdx.x, stride = gridDim.x;
    const long long mine = first < pieces ? (pieces - first + stride - 1) / stride : 0;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages && s < mine; ++s) {
            mbar_expect_tx(&full[s], piece);
            bulk_copy(ring + s * piece, in + (first + s * stride) * piece, piece, &full[s]);
        }
    }
    for (long long k = 0; k < mine; ++k) {
        const int s = static_cast<int>(k % stages);
        mbar_wait(&full[s], static_cast<unsigned>((k / stages) & 1));
        const unsigned char* st = ring + s * piece;
        unsigned char* o = out + (first + k * stride) * (piece / 2);
        for (int i = threadIdx.x; i < piece / 32; i += blockDim.x) {
            const uint4 a = reinterpret_cast<const uint4*>(st)[2 * i];
            const uint4 b = reinterpret_cast<const uint4*>(st)[2 * i + 1];
            reinterpret_cast<uint4*>(o)[i] = high_bytes(a, b);
        }
        __syncthreads();  // the stage is read: refill it
        if (threadIdx.x == 0 && k + stages < mine) {
            fence_proxy_async();
            mbar_expect_tx(&full[s], piece);
            bulk_copy(ring + s * piece, in + (first + (k + stages) * stride) * piece, piece,
                      &full[s]);
        }
    }
}

}  // namespace

// in: in_bytes (a multiple of 32, 16-byte aligned); out: in_bytes / 2.
extern "C" int probe_stream_rrw(const void* in, void* out, long long in_bytes, int unroll,
                                int grid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long units = in_bytes / 32;
    auto* i4 = static_cast<const uint4*>(in);
    auto* o4 = static_cast<uint4*>(out);
    switch (unroll) {
        case 1: stream_rrw<1><<<grid, 256, 0, st>>>(i4, o4, units); break;
        case 2: stream_rrw<2><<<grid, 256, 0, st>>>(i4, o4, units); break;
        case 4: stream_rrw<4><<<grid, 256, 0, st>>>(i4, o4, units); break;
        case 8: stream_rrw<8><<<grid, 256, 0, st>>>(i4, o4, units); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// in: in_bytes, a whole number of pieces of `piece` bytes (a multiple of
// 8 KB: 256 threads x 32 bytes); `stages` <= 16 pieces of shared memory a block.
extern "C" int probe_stream_ring(const void* in, void* out, long long in_bytes, int piece,
                                 int stages, int grid, void* stream) {
    if (stages < 1 || stages > kMaxStages || piece % 8192 || in_bytes % piece)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = stages * piece;
    cudaError_t e = cudaFuncSetAttribute(stream_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stream_ring<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(in), static_cast<unsigned char*>(out), in_bytes / piece,
        piece, stages);
    return static_cast<int>(cudaGetLastError());
}

// blocks of `kernel` (0 stream_rrw<unroll>, 1 stream_ring at `smem` bytes)
// one SM keeps resident
extern "C" int probe_residency(int kernel, int unroll, int smem, int* n) {
    if (kernel == 1)
        return static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, stream_ring, 256, smem));
    auto occ = [&](auto kern) {
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, 256, 0));
    };
    switch (unroll) {
        case 1: return occ(stream_rrw<1>);
        case 2: return occ(stream_rrw<2>);
        case 4: return occ(stream_rrw<4>);
        case 8: return occ(stream_rrw<8>);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
