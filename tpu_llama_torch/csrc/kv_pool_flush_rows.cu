// K14: write every layer's fresh INT8 K/V row and its scales into each
// slot's page of the pool, in place, in one launch per decode step.
//
// Replaces tpu_llama/ops/attention.py:1301 kv_pool_flush_rows (its two
// Pallas calls, values and scales, on the grid (L, B)).
//   page = pos[b] / ps < MP ? page_table[b, pos[b] / ps] : 0,  row = pos[b] % ps
//   ck[l, page, h, row, :] = rk[l, b, h, :]   (and v)
//   cks[l, page, h, row]   = rks[l, b, h]     (and vs)
// rk/rv int8 [L, B, KVH, hd], rks/rvs f32 [L, B, KVH], pos int32 [B] and
// page_table int32 [B, MP] on the device; the pools ck/cv int8
// [L, P, KVH, ps, hd] and cks/cvs f32 [L, P, KVH, ps].  A position past the
// slot's table (pos >= MP * ps) goes to the trash page 0, as in the JAX
// package (attention.py:1324-1330): a parked slot (table row all 0) lands
// there too.  Two cases the JAX package leaves undefined are defined here,
// because in CUDA either would be a silent out-of-bounds write into the
// pool: a negative pos, and a page id outside [0, P), are SKIPPED (never
// written).
//
// Bound on the H100: at Llama-2 7B, 32 layers x 8 slots x 32 heads x
// (2 * 128 + 8) B = 2.2 MB read and as much written, 1.3 us at 3.35 TB/s;
// the time is the drain of the scattered row stores (kv_flush.cuh).
// Design: K10's (kv_flush.cuh) with the destination looked up in the page
// table: values and scales in one launch (the TPU needed two), pos and the
// table read on the device (no host sync), and pos, the slot's table row
// (up to 32 pages; a longer table's entry is read once pos is in hand),
// the rows and the scales all loaded at once, so one memory trip lies
// between the launch and the stores (three before: pos, the page entry,
// the rows).  Row offsets in 64-bit arithmetic (one pool array at 7B is
// past 2^31 bytes).
#include "kv_flush.cuh"

namespace {

template <typename U>
__global__ void __launch_bounds__(kvf::kThreads) kv_pool_flush_rows_kernel(const kvf::Flush a) {
    kvf::flush_rows<U, true>(a);
}

}  // namespace

// args: rk, rv, rks, rvs, pos, page_table, ck, cv, cks, cvs (pointers),
// then L, B, KVH, P, ps, MP, hd, vec.  vec != 0 promises rows of a multiple
// of 16 bytes and 16-byte aligned row and pool pointers.  One packed array,
// so that a caller holding a launch's arguments passes them in one pointer.
extern "C" int tl_kv_pool_flush_rows(const long long* args, void* stream) {
    const int L = static_cast<int>(args[10]), B = static_cast<int>(args[11]);
    const int P = static_cast<int>(args[13]), ps = static_cast<int>(args[14]);
    const int MP = static_cast<int>(args[15]), hd = static_cast<int>(args[16]);
    if (L <= 0 || B <= 0) return 0;
    if (ps < 1 || MP < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
    auto ptr = [&](int i) { return reinterpret_cast<void*>(args[i]); };
    kvf::Flush a{};
    a.rk = ptr(0);
    a.rv = ptr(1);
    a.rks = static_cast<const float*>(ptr(2));
    a.rvs = static_cast<const float*>(ptr(3));
    a.pos = static_cast<const int*>(ptr(4));
    a.table = static_cast<const int*>(ptr(5));
    a.ck = ptr(6);
    a.cv = ptr(7);
    a.cks = static_cast<float*>(ptr(8));
    a.cvs = static_cast<float*>(ptr(9));
    a.B = B;
    a.KVH = static_cast<int>(args[12]);
    a.S = ps;
    a.P = P;
    a.MP = MP;
    const int vec = static_cast<int>(args[17]);
    const dim3 grid = kvf::flush_grid(a, L, hd, 1, vec);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        kv_pool_flush_rows_kernel<uint4><<<grid, kvf::kThreads, 0, st>>>(a);
    else
        kv_pool_flush_rows_kernel<int8_t><<<grid, kvf::kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

KV_STAMPS_READER(tl_kv_pool_flush_rows_stamps)
