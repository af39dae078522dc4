// K10: write every layer's fresh K/V row (INT8 with its f32 scales, or f32
// or bf16) into the dense cache at each slot's position, in place, in one
// launch per decode step.
//
// Replaces tpu_llama/ops/attention.py:2470 kv_cache_flush_rows (its Pallas
// kernels _flush_kernel :2438 and _flush_scale_kernel :2456, two calls for
// an INT8 cache, the first alone for an fp one).
//   ck[l, b, h, pos[b], :] = rk[l, b, h, :]   (and v)
//   cks[l, b, h, pos[b]]   = rks[l, b, h]     (and vs; INT8 only)
// rk/rv [L, B, KVH, hd] and ck/cv [L, B, KVH, S, hd] of one element type T
// (int8, f32 or bf16), rks/rvs f32 [L, B, KVH] and cks/cvs f32
// [L, B, KVH, S] for an INT8 cache (null for an fp one), pos int32 [B] on
// the device.  A slot whose pos[b] lies outside [0, S) is SKIPPED, never
// written: in CUDA it would be a silent out-of-bounds write (the xla path's
// indexed write drops such a row too).
//
// Bound on the H100: at Llama-2 7B, 32 layers x 8 slots x 32 heads x
// (2 * 128 + 8) B = 2.2 MB read and as much written for INT8 (4x and 2x the
// row bytes, no scales, for f32 and bf16), 1.1-1.3 us at 3.35 TB/s; the
// time is the drain of those scattered row stores (kv_flush.cuh).  Design:
// kv_flush.cuh -- values and scales in one launch (the TPU needed two), pos
// read on the device (no host sync), every load issued before any returns,
// so one memory trip lies between the launch and the stores.  One kernel
// templated on T serves the three cache types.
#include "kv_flush.cuh"

namespace {

template <typename U>
__global__ void __launch_bounds__(kvf::kThreads) kv_flush_rows_kernel(const kvf::Flush a) {
    kvf::flush_rows<U, false>(a);
}

template <typename T>
int launch(kvf::Flush a, int L, int hd, int vec, cudaStream_t st) {
    const dim3 grid = kvf::flush_grid(a, L, hd, sizeof(T), vec);
    if (vec)
        kv_flush_rows_kernel<uint4><<<grid, kvf::kThreads, 0, st>>>(a);
    else
        kv_flush_rows_kernel<T><<<grid, kvf::kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// args: rk, rv, rks, rvs, pos, ck, cv, cks, cvs (pointers), then kv_dtype
// (TL_I8, TL_F32 or TL_BF16: the element type of rk/rv/ck/cv), L, B, KVH,
// S, hd, vec.  The scale pointers are non-zero exactly for int8.  vec != 0
// promises rows of a multiple of 16 bytes and 16-byte aligned row and
// cache pointers.  One packed array, so that a caller holding a launch's
// arguments passes them in one pointer.
extern "C" int tl_kv_flush_rows(const long long* args, void* stream) {
    const int kv_dtype = static_cast<int>(args[9]), L = static_cast<int>(args[10]);
    const int B = static_cast<int>(args[11]), hd = static_cast<int>(args[14]);
    if (L <= 0 || B <= 0) return 0;
    auto ptr = [&](int i) { return reinterpret_cast<void*>(args[i]); };
    kvf::Flush a{};
    a.rk = ptr(0);
    a.rv = ptr(1);
    a.rks = static_cast<const float*>(ptr(2));
    a.rvs = static_cast<const float*>(ptr(3));
    a.pos = static_cast<const int*>(ptr(4));
    a.ck = ptr(5);
    a.cv = ptr(6);
    a.cks = static_cast<float*>(ptr(7));
    a.cvs = static_cast<float*>(ptr(8));
    a.B = B;
    a.KVH = static_cast<int>(args[12]);
    a.S = static_cast<int>(args[13]);
    const int vec = static_cast<int>(args[15]);
    if ((kv_dtype == TL_I8) != (a.rks != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kv_dtype == TL_I8) return launch<int8_t>(a, L, hd, vec, st);
    if (kv_dtype == TL_F32) return launch<float>(a, L, hd, vec, st);
    if (kv_dtype == TL_BF16) return launch<__nv_bfloat16>(a, L, hd, vec, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

KV_STAMPS_READER(tl_kv_flush_rows_stamps)
