"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface -- no PyTorch headers, so a build takes seconds -- and loads
through ``ctypes``.  The first launch builds every library at once (one
``nvcc`` per source, all running together) into ``build/kernels/`` at the
repo root.  A library's file name carries a hash of its source, every
header it includes and the flags, so an edited source or header rebuilds.  Nothing here is built
or loaded at import time: the CPU tests import every module.

Launch and plain-version counts: every wrapper in ``tpu_llama_torch.ops``
adds one to ``LAUNCHES[kernel]`` right after it launched its kernel, and one
to ``PLAIN_CALLS[kernel]`` when it ran the plain PyTorch version for a CPU
tensor.  They are process-wide counters, read by ``chip_smoke.py`` to show
that a run went through the kernels.  The fp-cache forms of K6, K7, K9, K10,
K19, K21 and K28 count under their own ids (``form``: ``"K6:f32"``, ``"K6:bf16"``),
one templated kernel each with its INT8 form; so does K1's int32 form
(``"K1:i32"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: it would change 1/s, expf and rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source name -> (C entry point, its argument types)
SOURCES = {
    # x, x dtype, q, s, M, N, vec, q16, warps a row, grid, stream
    "quantize_rows": ("tl_quantize_rows", [_P, _I, _P, _P, _L, _L, *[_I] * 4, _P]),
    "w8a8_matmul": ("tl_w8a8_matmul", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # x, x dtype, w, w dtype, q, s, M, N, vec, q16, warps a row, grid, stream
    "rmsnorm_quantize": ("tl_rmsnorm_quantize", [_P, _I, _P, _I, _P, _P, _L, _L, *[_I] * 4, _P]),
    "silu_mul_quantize": ("tl_silu_mul_quantize", [_P, _P, _I, _L, _P, _P, _L, _L, _I, _P]),
    "rope_split_quantize": ("tl_rope_split_quantize",
                            [_P, _I, *[_P] * 7, _L, _I, _I, _I, *[_L] * 7, _P]),
    # q, q dtype, cache dtype, k, v, ks, vs, start, out, out dtype, B, T, NH, KVH, S, hd,
    # sqrt(hd), stream
    "flash_prefill": ("tl_flash_prefill",
                      [_P, _I, _I, *[_P] * 6, _I, *[_I] * 6, ctypes.c_float, _P]),
    # sk, sv, sks, svs, slots, ck, cv, cks, cvs, cache dtype, L, n, KVH, T, hd, B, S, vec,
    # stream
    "kv_scatter": ("tl_kv_scatter_slots", [*[_P] * 9, _I, *[_I] * 8, _P]),
    # q, q dtype, cache dtype, k, v, ks, vs, pos, nk, nv, nks, nvs, out, layer, B, KVH, G,
    # S, hd, TS (K9: key block, K19: ring tile rows), splits, sqrt(hd), copy chunk, [split
    # workspace, tickets (K9),] stream
    "flash_decode_dma": ("tl_flash_decode_dma",
                         [_P, _I, _I, *[_P] * 10, *[_I] * 8, ctypes.c_float, _I, _P, _P, _P]),
    "flash_decode_fresh": ("tl_flash_decode_fresh",
                           [_P, _I, _I, *[_P] * 10, *[_I] * 8, ctypes.c_float, _I, _P]),
    # int64 [16]: rk, rv, rks, rvs, pos, ck, cv, cks, cvs, cache dtype, L, B, KVH, S, hd, vec;
    # stream
    "kv_flush_rows": ("tl_kv_flush_rows", [_P, _P]),
    # x, x dtype, q, s, out, out dtype, M, N, Np, K, g, stream
    "q8_matmul": ("tl_q8_matmul", [_P, _I, _P, _P, _P, _I, *[_I] * 5, _P]),
    # rk, rv, rks, rvs, ck, cv, cks, cvs, B, KVH, Tc, S, hd, start, layer, vec, stream
    "kv_write_chunk": ("tl_kv_write_chunk", [*[_P] * 8, *[_I] * 8, _P]),
    # x, attq, satt, 4 x (weights, scales), rms_ffn, rms_att, rms dtype, x_next, qkv,
    # xq, sx, h2, workspace, B, D, H, QO, last, stream
    "fused_layer": ("tl_fused_layer_linear", [*[_P] * 13, _I, *[_P] * 6, *[_I] * 5, _P]),
    # q, q dtype, k, v, ks, vs, page_table, pos, nk, nv, nks, nvs, out, layer, B, KVH, G, P,
    # ps, MP, hd, TS (K20: ring tile rows), splits, sqrt(hd), copy chunk, split workspace,
    # tickets, stream
    "paged_flash_decode_dma": ("tl_paged_flash_decode_dma",
                               [_P, _I, *[_P] * 11, *[_I] * 10, ctypes.c_float, _I, _P, _P, _P]),
    "paged_flash_decode_fresh": ("tl_paged_flash_decode_fresh",
                                 [_P, _I, *[_P] * 11, *[_I] * 10, ctypes.c_float, _I, _P, _P, _P]),
    # int64 [18]: rk, rv, rks, rvs, pos, page_table, ck, cv, cks, cvs, L, B, KVH, P, ps, MP, hd,
    # vec; stream
    "kv_pool_flush_rows": ("tl_kv_pool_flush_rows", [_P, _P]),
    # sk, sv, sks, svs, slots, page_table, ck, cv, cks, cvs, L, n, KVH, T, hd, P, ps, MP, vec,
    # stream
    "kv_pool_scatter": ("tl_kv_pool_scatter", [*[_P] * 10, *[_I] * 9, _P]),
    # q, q dtype, k, v, ks, vs, page_table, pos, out, layer, B, KVH, G, P, ps, MP, hd,
    # ring tile rows, splits, sqrt(hd), copy chunk, split workspace, tickets, stream
    "paged_flash_decode": ("tl_paged_flash_decode",
                           [_P, _I, *[_P] * 7, *[_I] * 10, ctypes.c_float, _I, _P, _P, _P]),
    # rk, rv, rks, rvs, start, page_table, ck, cv, cks, cvs, B, KVH, Tc, hd, P, ps, MP, layer,
    # vec, stream
    "kv_pool_write_chunk": ("tl_kv_pool_write_chunk", [*[_P] * 10, *[_I] * 9, _P]),
    # q, q dtype, k, v, ks, vs, page_table, start, fk, fv, fks, fvs, out, out dtype, layer, B,
    # Tc, NH, KVH, P, ps, MP, past pages, hd, sqrt(hd), stream
    "paged_flash_prefill": ("tl_paged_flash_prefill",
                            [_P, _I, *[_P] * 11, *[_I] * 11, ctypes.c_float, _P]),
    # x, attq, satt, 4 x (weights, scales), rms_ffn, rms_att, rms dtype, x_next, qkv, xq,
    # sx, h2, workspace, B, D, H, QO, last, k, v, ks, vs, pos, cos, sin, att, attq_next,
    # satt_next, kq, ks_new, vq, vs_new, split partials, split tickets, KVH, G, hd, S,
    # layer_next, TS, splits, 1/sqrt(hd), copy chunk, stream
    "fused_step2": ("tl_fused_step2_layer",
                    [*[_P] * 13, _I, *[_P] * 6, *[_I] * 5, *[_P] * 16, *[_I] * 7,
                     ctypes.c_float, _I, _P]),
    # fused_step2's arguments for layer l0 (without the stream), then layer l0 + 1's wo,
    # wo_s, w13, w13_s, w2, w2_s, layer l0 + 2's wqkv, wqkv_s, rms_ffn2, rms_att2, x_out,
    # attq_out, satt_out, kq2, ks2, vq2, vs2, last2, layer2, K12's blocks per SM, stream
    "fused_step3": ("tl_fused_step3_pair",
                    [*[_P] * 13, _I, *[_P] * 6, *[_I] * 5, *[_P] * 16, *[_I] * 7,
                     ctypes.c_float, _I, *[_P] * 17, _I, _I, _I, _P]),
    # q, nk, nv, nks, nvs, k, v, ks, vs, pos, att, attq, satt, split partials, split
    # tickets, KVH, G, hd, S, layer, TS, splits, sqrt(hd), copy chunk, then x, 4 x (weights,
    # scales), rms_ffn, rms_att, rms dtype, x_next, qkv, xq, sx, h2, workspace, B, D, H, QO,
    # last, stream
    "fused_step": ("tl_fused_step_layer",
                   [*[_P] * 15, *[_I] * 7, ctypes.c_float, _I, *[_P] * 11, _I, *[_P] * 6,
                    *[_I] * 5, _P]),
    # k, v, pos, ck, cv, cks, cvs, cache dtype, layer, B, KVH, S, hd, stream
    "kv_write_decode": ("tl_kv_write_decode", [*[_P] * 7, *[_I] * 6, _P]),
    # x, sx, w, sw, residual, out, out dtype, M, N, K, rows per block, cluster blocks, stream
    "w8a8_rows_resident": ("tl_w8a8_rows_resident", [*[_P] * 6, *[_I] * 6, _P]),
    # q, q dtype, cache dtype, k, v, ks, vs, pos, out, layer, B, KVH, G, S, hd, TS (ring tile
    # rows, or the blocked form's key block), splits (0: the blocked form), sqrt(hd), copy
    # chunk, stream
    "flash_decode": ("tl_flash_decode", [_P, _I, _I, *[_P] * 6, *[_I] * 8, ctypes.c_float, _I,
                                         _P]),
    # x, w13, w13 scales, w2, w2 scales, rms, rms dtype, out, xq, sx, h2, xq3, workspace,
    # B, D, H, stream
    "fused_ffn": ("tl_fused_ffn", [*[_P] * 6, _I, *[_P] * 6, *[_I] * 3, _P]),
    # x, wqkv, wqkv scales, rms, rms dtype, out, xq, sx, workspace, B, D, QO, stream
    "fused_rms_qkv": ("tl_fused_rms_qkv", [*[_P] * 4, _I, *[_P] * 4, *[_I] * 3, _P]),
}

# kernel id -> source; the ids follow ROADMAP.md queue 2.  K8 is K1's kernel
# launched on one layer of stacked weights (a pointer offset on the card).
KERNELS = {"K1": "w8a8_matmul", "K2": "quantize_rows", "K3": "rmsnorm_quantize",
           "K4": "silu_mul_quantize", "K5": "rope_split_quantize", "K6": "flash_prefill",
           "K7": "kv_scatter", "K8": "w8a8_matmul", "K9": "flash_decode_dma",
           "K10": "kv_flush_rows", "K11": "fused_layer", "K12": "fused_step2",
           "K13": "paged_flash_decode_dma", "K14": "kv_pool_flush_rows", "K15": "kv_pool_scatter",
           "K16": "paged_flash_prefill", "K17": "kv_pool_write_chunk", "K18": "kv_write_chunk",
           "K19": "flash_decode_fresh", "K20": "paged_flash_decode_fresh",
           "K21": "flash_decode", "K22": "paged_flash_decode", "K23": "fused_ffn",
           "K24": "fused_rms_qkv", "K25": "q8_matmul", "K26": "fused_step3",
           "K27": "fused_step", "K28": "kv_write_decode", "K29": "w8a8_rows_resident"}
# K1's int32 form (the exact sums, no epilogue: the sharded engine's
# row-sharded products) counts under an id of its own
KERNELS["K1:i32"] = "w8a8_matmul"
FP_FORMS = ("K6", "K7", "K9", "K10", "K19", "K21", "K28")  # kernels with an fp-cache form
_FORM_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNELS.update({f"{k}:{sfx}": KERNELS[k] for k in FP_FORMS for sfx in _FORM_SUFFIX.values()})
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh TlDtype
I32_CODE = 3  # TL_I32: K1's int32 form's output
_CACHE_CODES = {**_DTYPE_CODES, torch.int8: 2}

_libs: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def cache_code(dtype: torch.dtype) -> int:
    """The TlDtype of a KV cache's elements: int8, float32 or bfloat16."""
    if dtype not in _CACHE_CODES:
        raise TypeError(f"KV caches are int8, float32 or bfloat16, not {dtype}")
    return _CACHE_CODES[dtype]


def form(kernel: str, cache_dtype: torch.dtype) -> str:
    """The id a kernel of FP_FORMS counts under for a cache of
    ``cache_dtype``: its own for int8, ``"<id>:f32"`` or ``"<id>:bf16"``."""
    return kernel if cache_dtype == torch.int8 else f"{kernel}:{_FORM_SUFFIX[cache_dtype]}"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _headers(src: Path) -> list[Path]:
    """The csrc headers ``src`` includes, directly or through another."""
    found: list[Path] = []
    todo = [src]
    while todo:
        for name in re.findall(r'^#include "([^"]+)"', todo.pop().read_text(), re.M):
            p = _CSRC / name
            if p not in found:
                found.append(p)
                todo.append(p)
    return sorted(found)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    src = _CSRC / f"{name}.cu"
    for p in (src, *_headers(src)):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".log")


# seconds each source's nvcc took in this process's last build, by source
BUILD_SECONDS: dict[str, float] = {}


def build(names=None) -> dict[str, str]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together; each one's
    seconds go to ``BUILD_SECONDS``.  Returns the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) for every named
    source: each log is kept beside its library, so a source built earlier
    returns the log of that build.  Raises with the log if any build
    failed."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not (_lib_path(n).exists() and _log_path(n).exists())]
    procs = {}
    if todo:
        _BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    t0 = time.monotonic()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        with open(log, "w") as f:  # a file, not a pipe: no process blocks on a full pipe
            procs[n] = (subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT), tmp, log,
                        out)
    pending = set(procs)
    while pending:
        for n in [n for n in pending if procs[n][0].poll() is not None]:
            BUILD_SECONDS[n] = time.monotonic() - t0
            pending.discard(n)
        time.sleep(0.05)
    failed = []
    for n, (proc, tmp, log, out) in procs.items():
        if proc.returncode == 0:
            os.replace(log, _log_path(n))
            os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log.read_text()}")
            log.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: _log_path(n).read_text() for n in names}


def build_extra(src: Path, flags=()) -> Path:
    """Compile ``src`` (a source outside SOURCES, or one of them with extra
    ``flags``: a probe or an instrumented build) with NVCC_FLAGS plus
    ``flags`` into the build directory, once: the library is named by a
    hash of the flags and the sources.  Prints ptxas's register and spill
    lines of a new build; raises with the compiler's output if it fails."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for p in (src, *_headers(src)):
        h.update(p.read_bytes())
    out = _BUILD / f"{src.stem}-x{h.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"build of {src.name} {' '.join(flags)} failed:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        for ln in (res.stdout + res.stderr).splitlines():
            if any(k in ln for k in ("Compiling entry", "registers", "spill")):
                print(f"  {src.name} {' '.join(flags)}: {ln.strip()[:200]}", flush=True)
    return out


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
        _libs[name] = open_lib(name, _lib_path(name))
    return _libs[name]


def open_lib(name: str, path: Path) -> ctypes.CDLL:
    """Load the library at ``path`` built from source ``name`` with its entry
    point's argument types (a development build of it too)."""
    lib = ctypes.CDLL(str(path))
    fn_name, argtypes = SOURCES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.tl_error_string.argtypes = [ctypes.c_int]
    lib.tl_error_string.restype = ctypes.c_char_p
    return lib


def load(names) -> None:
    """Build and load the named sources only (a script that needs a few
    kernels need not build them all)."""
    build(names)
    for n in names:
        if n not in _libs:
            _libs[n] = open_lib(n, _lib_path(n))


def entry(kernel: str):
    """The C entry point of ``kernel`` (an id of KERNELS), its library built
    and loaded at first use: for a wrapper that keeps it beside a launch's
    arguments."""
    return getattr(_lib(KERNELS[kernel]), SOURCES[KERNELS[kernel]][0])


def call(kernel: str, fn, *args) -> None:
    """Launch ``kernel`` through its entry point ``fn`` (``entry``); raise
    if the launch was refused, count it otherwise."""
    code = fn(*args)
    if code != 0:
        msg = _lib(KERNELS[kernel]).tl_error_string(code).decode()
        raise RuntimeError(f"{kernel} ({SOURCES[KERNELS[kernel]][0]}) launch failed: {msg} "
                           f"({code})")
    LAUNCHES[kernel] += 1


def launch(kernel: str, *args) -> None:
    """Launch ``kernel`` (an id of KERNELS) on the current stream; raise if
    the launch was refused, count it otherwise."""
    call(kernel, entry(kernel), *args)


_K12_RESIDENCY: dict[tuple, int] = {}


def k12_residency(B: int, G: int, hd: int, ts: int, ch: int) -> int:
    """The blocks of K12 that one SM keeps resident for a launch of these
    shapes (``tl_fused_step2_residency``): K26 runs on K12's grid."""
    key = (B <= 8, G, hd, ts, ch)
    if key not in _K12_RESIDENCY:
        fn = _lib(KERNELS["K12"]).tl_fused_step2_residency
        fn.argtypes = [_I] * 5 + [_P]
        fn.restype = _I
        n = ctypes.c_int(0)
        code = fn(B, G, hd, ts, ch, ctypes.byref(n))
        if code != 0:
            raise RuntimeError(f"K12 residency query failed: "
                               f"{_lib('fused_step2').tl_error_string(code).decode()} ({code})")
        _K12_RESIDENCY[key] = n.value
    return _K12_RESIDENCY[key]


def row_quant_layout(kernel: str) -> tuple:
    """(warps a block, 16-byte vectors a lane holds) that K2's or K3's
    library was built with (``tl_row_quant_layout``, csrc/row_quant.cuh)."""
    lib = _lib(KERNELS[kernel])
    fn = lib.tl_row_quant_layout
    fn.argtypes = [_P]
    fn.restype = _I
    res = (ctypes.c_int * 2)()
    code = fn(ctypes.byref(res))
    if code != 0:
        raise RuntimeError(f"{kernel} layout query failed: {lib.tl_error_string(code).decode()} "
                           f"({code})")
    return tuple(res)


def k29_max_clusters(K: int, csize: int) -> int:
    """The clusters of ``csize`` K29 blocks the card keeps resident at once
    for an inner size ``K`` (``tl_w8a8_rows_resident_clusters``: CUDA's
    occupancy query at the launch's shape)."""
    fn = _lib(KERNELS["K29"]).tl_w8a8_rows_resident_clusters
    fn.argtypes = [_I, _I, _P]
    fn.restype = _I
    n = ctypes.c_int(0)
    code = fn(K, csize, ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"K29 cluster query failed: "
                           f"{_lib(KERNELS['K29']).tl_error_string(code).decode()} ({code})")
    return n.value


def decode_split_residency(kv_dtype: torch.dtype, G: int, hd: int, ts: int) -> tuple:
    """(blocks one SM keeps resident, ring tiles, shared memory bytes) of
    K9's split cell (csrc/decode_split.cuh, K13's too for an int8 cache) at
    these shapes: ``tl_flash_decode_dma_residency``, CUDA's occupancy
    query."""
    lib = _lib(KERNELS["K9"])
    fn = lib.tl_flash_decode_dma_residency
    fn.argtypes = [_I] * 4 + [_P]
    fn.restype = _I
    res = (ctypes.c_int * 3)()
    code = fn(cache_code(kv_dtype), G, hd, ts, ctypes.byref(res))
    if code != 0:
        raise RuntimeError(f"K9 residency query failed: {lib.tl_error_string(code).decode()} "
                           f"({code})")
    return tuple(res)


def norm_split_residency(kernel: str, kv_dtype: torch.dtype, G: int, hd: int, S: int, ts: int,
                         splits: int) -> tuple:
    """(blocks one SM keeps resident, ring tiles, shared memory bytes,
    clusters of ``splits`` blocks the card keeps resident at once) of the
    normalized split cell of K19 or K21's single-pass form
    (csrc/decode_split_norm.cuh) at these shapes: CUDA's occupancy
    queries."""
    lib = _lib(KERNELS[kernel])
    fn = getattr(lib, f"tl_{KERNELS[kernel]}_residency")
    fn.argtypes = [_I] * 6 + [_P]
    fn.restype = _I
    res = (ctypes.c_int * 4)()
    code = fn(cache_code(kv_dtype), G, hd, S, ts, splits, ctypes.byref(res))
    if code != 0:
        raise RuntimeError(f"{kernel} residency query failed: "
                           f"{lib.tl_error_string(code).decode()} ({code})")
    return tuple(res)


def page_split_residency(kernel: str, G: int, hd: int, ts: int, ps: int) -> tuple:
    """(blocks one SM keeps resident, ring tiles, shared memory bytes) of
    the page-block split cell of K20 or K22 (csrc/decode_split_page.cuh)
    with ring tiles of ``ts`` rows over pages of ``ps``: CUDA's occupancy
    query."""
    lib = _lib(KERNELS[kernel])
    fn = getattr(lib, f"tl_{KERNELS[kernel]}_residency")
    fn.argtypes = [_I] * 4 + [_P]
    fn.restype = _I
    res = (ctypes.c_int * 3)()
    code = fn(G, hd, ts, ps, ctypes.byref(res))
    if code != 0:
        raise RuntimeError(f"{kernel} residency query failed: "
                           f"{lib.tl_error_string(code).decode()} ({code})")
    return tuple(res)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the current stream's pointer without a Stream object (a CUDA build of torch has it)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def device_stream(index: int) -> int:
    """The current stream of card ``index``, as ``stream`` gives it."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when the wrapper must run the plain version (all tensors on the
    CPU, counted); False for CUDA tensors; raises for anything else."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        PLAIN_CALLS[kernel] += 1
        return True
    if devs == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{kernel}: tensors on different cards")
        return False
    raise ValueError(f"{kernel}: tensors must all be on the CPU or all on one card, "
                     f"got {sorted(devs)}")
