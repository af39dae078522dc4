"""INT8 KV quantization, causal prefill attention (K6), the slot scatter
that admits a prefilled block into the cache (K7), the chunk write of
chunked prefill (K18), the JAX package's f32 ``attn="xla"`` prefill attention
(``attention_prefill``), the deferred-flush decode attention (K9, K19) with
its per-step row flush (K10), and their paged counterparts over a page pool
(K15 page scatter, K13 and K20 decode attention, K14 row flush, K16 chunk
attention and K17 chunk write of the pool-direct prefill, K22
write-then-attend decode attention).

Port of tpu_llama/ops/attention.py: ``quantize_kv`` (:2551),
``flash_prefill_attention`` (:1654), ``kv_cache_scatter_slots`` (:1212),
``kv_cache_write_chunk`` (:2102), ``flash_decode_attention_dma`` (:335),
``flash_decode_attention_fresh`` (:807) and ``kv_cache_flush_rows``
(:2470); ``kv_pool_scatter_pages`` (:1095), ``paged_flash_decode_attention_dma``
(:466), ``paged_flash_decode_attention_fresh`` (:1012),
``kv_pool_flush_rows`` (:1301), ``paged_flash_prefill_attention`` (:1990),
``kv_pool_write_chunk`` (:2189) and ``paged_flash_decode_attention``
(:933), INT8 only, as in JAX; ``flash_decode_attention`` (:616, K21), the
write-then-attend decode attention of the tensor-parallel decode, in both
its forms; and ``kv_cache_write_decode`` (:2345, K28),
the per-layer decode row write that no decode path calls.  K6, K7, K9, K19 and
K10 (and K21, K28) take an INT8 cache (int8 values with f32
per-row scales) or an fp one (float32 or bfloat16, no scales), as the JAX
functions do; each CUDA kernel is templated on the cache type, and the fp
forms count their launches under their own ids (``K6:f32``, ``K6:bf16``,
... in ``_kernels``).  K18 takes INT8 caches only, as in JAX.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_llama_torch.device import upload
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.quant import _absmax_quant, sqrt_f32

_NEG_INF = -1e30


def quantize_kv(x: torch.Tensor, out=None):
    """Per-(..., row) symmetric INT8 over the last (hd) axis:
    x [..., hd] -> (int8 [..., hd], f32 scales [...]), written into
    ``out`` = (q, s) where given."""
    return _absmax_quant(x.float(), dim=-1, out=out)


CACHE_DTYPES = (torch.int8, torch.float32, torch.bfloat16)


def check_scales(name, cache, *scales) -> bool:
    """Whether ``cache`` is INT8; raises unless it is INT8 with every one of
    ``scales`` given or fp (float32, bfloat16) with none of them."""
    if cache.dtype not in CACHE_DTYPES:
        raise TypeError(f"{name}: caches are int8, float32 or bfloat16, not {cache.dtype}")
    int8 = cache.dtype == torch.int8
    if int8 and any(s is None for s in scales):
        raise ValueError(f"{name}: INT8 caches need their scales")
    if not int8 and any(s is not None for s in scales):
        raise ValueError(f"{name}: an fp cache has no scales")
    return int8


def _check_prefill(q, k_cache, v_cache, start_pos, k_scale, v_scale):
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("flash_prefill_attention: K and V caches of one dtype")
    if not check_scales("flash_prefill_attention", k_cache, k_scale, v_scale):
        if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
            raise ValueError("want q [B, T, NH, hd] and k_cache, v_cache [B, KVH, S, hd]")
        if (k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[3]
                or start_pos.shape != (q.shape[0],) or q.shape[2] % k_cache.shape[1]):
            raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                             f"start {tuple(start_pos.shape)}")
        return
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("want q [B, T, NH, hd] and k_cache [B, KVH, S, hd]")
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, KVH, S, hd) or v_cache.shape != k_cache.shape
            or k_scale.shape != (B, KVH, S) or v_scale.shape != k_scale.shape
            or start_pos.shape != (B,) or NH % KVH):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, ks {tuple(k_scale.shape)}, "
                         f"vs {tuple(v_scale.shape)}, start {tuple(start_pos.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("K/V scales must be float32")


PREFILL_TILE = 64  # keys per tile of the prefill cells (csrc/prefill_mma.cuh, prefill_split.cuh)


def attention_prefill(q, k_cache, v_cache, start_pos, k_scale=None, v_scale=None,
                      out_dtype=None):
    """Port of ``_attention_prefill`` (tpu_llama/models/llama.py:582-603),
    the JAX package's ``attn="xla"`` prefill attention: f32 scores on the
    dequantized (INT8, values times their scales) or upcast (fp) cache
    [B, KVH, S, hd], divided by sqrt(hd), key s attending query t iff
    s <= start_pos[b] + t, softmax, f32 values; [B, T, NH * hd] in
    ``out_dtype`` (default f32; JAX: q's dtype).  Nothing is rounded to
    bf16: K6 and K16 are the ``"flash"`` function.  It is also K6's plain
    version for an fp cache."""
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = NH // KVH
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    qg = q.reshape(B, T, KVH, G, hd).float()
    scores = torch.einsum("btkgh,bksh->bkgts", qg, kf) / math.sqrt(hd)
    q_pos = start_pos.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, None, None, :] <= \
        q_pos[:, None, None, :, None]
    att = torch.softmax(scores.masked_fill(~mask, _NEG_INF), dim=-1)
    out = torch.einsum("bkgts,bksh->btkgh", att, vf)
    return out.reshape(B, T, NH * hd).to(out_dtype or torch.float32)



def _prefill_plain(q, k, v, ks, vs, mask, out_dtype, round_out=False):
    """The INT8 prefill kernels' function in their own order
    (csrc/prefill_mma.cuh's contract, the TPU kernels' own): q [B, T, NH,
    hd] raw, int8 K/V [B, KVH, S, hd] with f32 scales ks/vs [B, KVH, S],
    mask [B, T, S] (key s attends query t).  q pre-scaled in f32 and
    rounded to bf16, QK^T in f32 times the K scale, the mask; then an online
    softmax over tiles of PREFILL_TILE keys from key 0, as the cell walks
    them: m_new = max(m, the tile's max), corr = exp(m - m_new),
    p = exp(s - m_new), l = l * corr + sum(p), and bf16(p * vs) @ V added to
    acc * corr, all in f32; out = acc / max(l, 1e-30).  Where every key lies
    in one tile that is one pass with the full row max,
    ``_flash_prefill_fresh_kernel``'s arithmetic; over more tiles it rounds
    p * vs at the running max, as the card does, so card and CPU agree to
    f32 noise.  ``round_out`` rounds the output to bf16 before the cast to
    ``out_dtype``."""
    B, T, NH, hd = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = NH // KVH
    qg = _bf16(_scaled_q(q)).reshape(B, T, KVH, G, hd)
    s = torch.einsum("btkgh,bksh->bkgts", qg, k.float()) * ks[:, :, None, None, :]
    s = s.masked_fill(~mask[:, None, None], -math.inf)
    m = torch.full(s.shape[:-1], -math.inf, device=s.device)  # [B, KVH, G, T]
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, T, hd), device=s.device)
    for c0 in range(0, S, PREFILL_TILE):
        st = s[..., c0:c0 + PREFILL_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)  # no key yet: corr = p = 0
        corr = torch.exp(m - base)
        p = torch.exp(st - base[..., None])
        l = l * corr + p.sum(dim=-1)
        p = _bf16(p * vs[:, :, None, None, c0:c0 + PREFILL_TILE])
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bksh->bkgth", p, v[:, :, c0:c0 + PREFILL_TILE].float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]  # [B, KVH, G, T, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, NH * hd)
    if round_out:
        out = _bf16(out)
    return out.to(out_dtype or torch.float32)


def flash_prefill_attention_plain(q, k_cache, v_cache, start_pos, k_scale=None, v_scale=None,
                                  out_dtype=None):
    """Plain version of K6: for an INT8 cache its function in the kernel's
    order of key tiles (``_prefill_plain``: the TPU kernels' bf16 roundings
    of q and p * vs); for an fp cache f32 throughout, which is
    ``attention_prefill`` (attention.py:1613-1640 runs f32 dots)."""
    if k_scale is None:
        return attention_prefill(q, k_cache, v_cache, start_pos, out_dtype=out_dtype)
    T, S = q.shape[1], k_cache.shape[2]
    dev = q.device
    q_pos = start_pos.to(dev).long()[:, None] + torch.arange(T, device=dev)[None, :]
    mask = torch.arange(S, device=dev)[None, None, :] <= q_pos[:, :, None]  # [B, T, S]
    return _prefill_plain(q, k_cache, v_cache, k_scale, v_scale, mask, out_dtype)


def flash_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            start_pos: torch.Tensor, k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """Causal prefill attention: q [B, T, NH, hd] (raw queries), K/V
    [B, KVH, S, hd] already holding this chunk -- INT8 with f32 scales
    [B, KVH, S], or float32 / bfloat16 without -- start_pos [B] (absolute
    position of q[:, 0]).  Key s attends iff s <= start_pos[b] + t.
    Returns [B, T, NH * hd] in ``out_dtype`` (default f32).  An INT8 cache
    takes the TPU kernels' rounding (q and p * vs to bf16 before the dots;
    csrc/prefill_mma.cuh), an fp cache f32 throughout.  K6 on CUDA tensors
    (``K6:f32`` / ``K6:bf16`` for an fp cache), the plain version on CPU
    ones."""
    _check_prefill(q, k_cache, v_cache, start_pos, k_scale, v_scale)
    kernel = _kernels.form("K6", k_cache.dtype)
    scales = () if k_scale is None else (k_scale, v_scale)
    if _kernels.on_cpu(kernel, q, k_cache, v_cache, start_pos, *scales):
        return flash_prefill_attention_plain(q, k_cache, v_cache, start_pos, k_scale,
                                             v_scale, out_dtype)
    out_dtype = out_dtype or torch.float32
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if hd > 128:
        raise NotImplementedError(f"K6 takes head_dim <= 128, got {hd}")
    qc = q.contiguous()
    kc, vc = k_cache.contiguous(), v_cache.contiguous()
    ks, vs = (None, None) if k_scale is None else (k_scale.contiguous(), v_scale.contiguous())
    st = start_pos.to(torch.int32).contiguous()
    out = torch.empty((B, T, NH * hd), dtype=out_dtype, device=q.device)
    sqrt_hd = float(sqrt_f32(hd))  # jnp.sqrt(f32(hd))
    _kernels.launch(kernel, qc.data_ptr(), _kernels.dtype_code(qc.dtype),
                    _kernels.cache_code(kc.dtype), kc.data_ptr(), vc.data_ptr(), _ptr(ks),
                    _ptr(vs), st.data_ptr(), out.data_ptr(), _kernels.dtype_code(out_dtype), B, T,
                    NH, KVH, S, hd, sqrt_hd, _kernels.stream(qc))
    return out


def _ptr(t):
    """A tensor's device pointer, or None (NULL) for an absent one."""
    return None if t is None else t.data_ptr()


def _check_scatter(small_k, small_v, slots, ck, cv, small_ks, small_vs, cks, cvs):
    int8 = check_scales("kv_cache_scatter_slots", ck, small_ks, small_vs, cks, cvs)
    if small_k.dim() != 5 or ck.dim() != 5:
        raise ValueError("want small_k [L, n, KVH, T, hd] and ck [L, B, KVH, S, hd]")
    L, n, KVH, T, hd = small_k.shape
    B, S = ck.shape[1], ck.shape[3]
    if (small_v.shape != small_k.shape or ck.shape != (L, B, KVH, S, hd)
            or cv.shape != ck.shape):
        raise ValueError("kv_cache_scatter_slots: shape mismatch")
    if int8 and (small_ks.shape != (L, n, KVH, T) or small_vs.shape != small_ks.shape
                 or cks.shape != (L, B, KVH, S) or cvs.shape != cks.shape):
        raise ValueError("kv_cache_scatter_slots: scale shape mismatch")
    if int8 and (any(t.dtype != torch.int8 for t in (small_k, small_v, cv)) or any(
            t.dtype != torch.float32 for t in (small_ks, small_vs, cks, cvs))):
        raise TypeError("kv_cache_scatter_slots takes int8 K/V and float32 scales")
    if not int8 and cv.dtype != ck.dtype:
        raise TypeError("kv_cache_scatter_slots: K and V caches of one dtype")
    if T > S:
        raise ValueError(f"block of {T} rows does not fit a cache of {S}")
    idx = [int(s) for s in (slots.tolist() if isinstance(slots, torch.Tensor) else slots)]
    if len(idx) != n:
        raise ValueError(f"{len(idx)} slots for a block of {n}")
    if any(not 0 <= s < B for s in idx) or len(set(idx)) != len(idx):
        raise ValueError(f"slots {idx} must be distinct and in [0, {B})")
    return idx


def kv_cache_scatter_slots_plain(small_k, small_v, slots, ck, cv, small_ks=None,
                                 small_vs=None, cks=None, cvs=None):
    """Plain version of K7: one slot at a time, in place."""
    T = small_k.shape[3]
    pairs = [(ck, small_k), (cv, small_v)]
    if small_ks is not None:
        pairs += [(cks, small_ks), (cvs, small_vs)]
    for i, s in enumerate(slots):
        for dst, src in pairs:
            dst[:, s, :, :T].copy_(src[:, i])
    return tuple(dst for dst, _ in pairs)


def _vec16(row_elems: int, *tensors) -> bool:
    """Rows of ``row_elems`` elements of these tensors copy as 16-byte
    vectors."""
    return (row_elems * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def kv_cache_scatter_slots(small_k, small_v, slots, ck, cv, small_ks=None, small_vs=None,
                           cks=None, cvs=None):
    """Write rows [0, T) of each chosen slot of the cache IN PLACE:
    ``ck[:, slots[i], :, :T] = small_k[:, i]`` for K and V, and for an INT8
    cache both scale arrays.  small_k [L, n, KVH, T, hd], slots: n host ints
    (distinct, < B; a tensor is read back to the host for the check, which
    waits for its stream), ck [L, B, KVH, S, hd] (int8 with scales
    [L, ., KVH, .], or float32 / bfloat16 without: the block is cast to the
    cache's dtype, as the JAX fp kernel's input is).  Returns the (updated)
    cache arrays: (ck, cv, cks, cvs), or (ck, cv) for an fp cache.  K7 on
    CUDA tensors (``K7:f32`` / ``K7:bf16`` for an fp cache), the plain
    version on CPU ones."""
    idx = _check_scatter(small_k, small_v, slots, ck, cv, small_ks, small_vs, cks, cvs)
    int8 = ck.dtype == torch.int8
    if not int8:
        small_k, small_v = small_k.to(ck.dtype), small_v.to(ck.dtype)
    scales = (small_ks, small_vs, cks, cvs) if int8 else ()
    kernel = _kernels.form("K7", ck.dtype)
    if _kernels.on_cpu(kernel, small_k, small_v, ck, cv, *scales):
        return kv_cache_scatter_slots_plain(small_k, small_v, idx, ck, cv, small_ks,
                                            small_vs, cks, cvs)
    if not all(t.is_contiguous() for t in (ck, cv, *scales[2:])):
        raise ValueError("K7 writes the cache in place: it must be contiguous")
    L, n, KVH, T, hd = small_k.shape
    B, S = ck.shape[1], ck.shape[3]
    sk, sv = small_k.contiguous(), small_v.contiguous()
    sks, svs = (small_ks.contiguous(), small_vs.contiguous()) if int8 else (None, None)
    sl = upload(idx, ck.device, torch.int32)
    vec = _vec16(hd, sk, sv, ck, cv)
    _kernels.launch(kernel, sk.data_ptr(), sv.data_ptr(), _ptr(sks), _ptr(svs), sl.data_ptr(),
                    ck.data_ptr(), cv.data_ptr(), _ptr(cks), _ptr(cvs),
                    _kernels.cache_code(ck.dtype), L, n, KVH, T, hd, B, S, int(vec),
                    _kernels.stream(ck))
    return (ck, cv, cks, cvs) if int8 else (ck, cv)


def _check_write_chunk(rows_k, rows_v, rows_ks, rows_vs, start, layer, ck, cv, cks, cvs):
    """Validate a chunk write on a 5-D cache; returns (start, layer) as host
    ints."""
    if rows_k.dim() != 4 or ck.dim() != 5:
        raise ValueError("want rows_k [B, KVH, Tc, hd] and ck [[L,] B, KVH, S, hd]")
    B, KVH, Tc, hd = rows_k.shape
    L, S = ck.shape[0], ck.shape[3]
    if (rows_v.shape != rows_k.shape or rows_ks.shape != (B, KVH, Tc)
            or rows_vs.shape != rows_ks.shape or ck.shape != (L, B, KVH, S, hd)
            or cv.shape != ck.shape or cks.shape != (L, B, KVH, S) or cvs.shape != cks.shape):
        raise ValueError(f"kv_cache_write_chunk: shape mismatch: rows {tuple(rows_k.shape)}, "
                         f"scales {tuple(rows_ks.shape)}, cache {tuple(ck.shape)}, "
                         f"cache scales {tuple(cks.shape)}")
    if any(t.dtype != torch.int8 for t in (rows_k, rows_v, ck, cv)) or any(
            t.dtype != torch.float32 for t in (rows_ks, rows_vs, cks, cvs)):
        raise TypeError("kv_cache_write_chunk takes int8 K/V and float32 scales")
    start, layer = int(start), int(layer)
    if start < 0 or start + Tc > S:
        raise ValueError(f"rows [{start}, {start + Tc}) do not fit a cache of {S}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    return start, layer


def kv_cache_write_chunk_plain(rows_k, rows_v, rows_ks, rows_vs, start: int, layer: int, ck,
                               cv, cks, cvs):
    """Plain version of K18: four sliced copies, in place (5-D cache)."""
    Tc = rows_k.shape[2]
    ck[layer, :, :, start:start + Tc].copy_(rows_k)
    cv[layer, :, :, start:start + Tc].copy_(rows_v)
    cks[layer, :, :, start:start + Tc].copy_(rows_ks)
    cvs[layer, :, :, start:start + Tc].copy_(rows_vs)


def kv_cache_write_chunk(rows_k, rows_v, rows_ks, rows_vs, start, layer, ck, cv, cks, cvs):
    """Write one prefill chunk's rows IN PLACE at rows [start, start + Tc)
    of layer ``layer``: ``ck[layer, :, :, start:start + Tc] = rows_k`` for K,
    V and both scale arrays.  rows_k/rows_v int8 [B, KVH, Tc, hd],
    rows_ks/rows_vs f32 [B, KVH, Tc]; ck/cv int8 [L, B, KVH, S, hd] and
    cks/cvs f32 [L, B, KVH, S], or a 4-D cache without the layer axis
    (``layer`` then ignored); ``start`` and ``layer`` host ints.  Raises
    where the rows do not fit.  Returns the (updated) cache arrays.  K18 on
    CUDA tensors, the plain version on CPU ones."""
    four = ck.dim() == 4
    if four:
        layer = 0
    arrays = [a[None] if four else a for a in (ck, cv, cks, cvs)]
    start, layer = _check_write_chunk(rows_k, rows_v, rows_ks, rows_vs, start, layer, *arrays)
    if _kernels.on_cpu("K18", rows_k, rows_v, rows_ks, rows_vs, *arrays):
        kv_cache_write_chunk_plain(rows_k, rows_v, rows_ks, rows_vs, start, layer, *arrays)
        return ck, cv, cks, cvs
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError("K18 writes the cache in place: it must be contiguous")
    B, KVH, Tc, hd = rows_k.shape
    S = ck.shape[-2]
    rk, rv, rks, rvs = (t.contiguous() for t in (rows_k, rows_v, rows_ks, rows_vs))
    vec = _vec16(hd, rk, rv, ck, cv)
    _kernels.launch("K18", rk.data_ptr(), rv.data_ptr(), rks.data_ptr(), rvs.data_ptr(),
                    ck.data_ptr(), cv.data_ptr(), cks.data_ptr(), cvs.data_ptr(), B, KVH, Tc,
                    S, hd, start, layer, int(vec), _kernels.stream(ck))
    return ck, cv, cks, cvs


# ---------------------------------------------------------------------------
# Deferred-flush decode attention (K9, K19) and the step's row flush (K10).
# During a decode step the cache is read-only: each layer attends over its
# cache rows s < pos[b] plus the step's fresh K/V row (already quantized for
# an INT8 cache, already cast to the cache's dtype for an fp one) as one
# extra softmax column, and one K10 call writes every layer's fresh row at
# pos[b] after the layer loop (llama.py:1277-1327).
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (ties to even) and back, as the TPU
    kernels' ``astype(bfloat16)`` before their MXU dots."""
    return x.to(torch.bfloat16).float()


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """qs = f32(q) / sqrt(f32(hd)) (attention.py:378, :848)."""
    hd = q.shape[-1]
    return q.float() / sqrt_f32(hd).to(q.device)


def _dma_block(S: int, block_s: int | None, itemsize: int = 1) -> int:
    """K9's key block: ``block_s`` (default 128 rows for int8, 64 for f32
    and bf16), halved until it divides S (attention.py:372-376)."""
    ts = min(block_s or max(64, 128 // itemsize), S)
    while S % ts:
        ts //= 2
    return ts


DECODE_SMS = 132  # the H100's SMs
DECODE_RESIDENT = 2 * DECODE_SMS  # split-cell blocks the card keeps at once (two an SM)
SPLIT_MIN_ROWS = 512  # caches of at most this many rows are never split


def decode_splits(B: int, KVH: int, ts: int, rows_max: int) -> int:
    """How many key-row splits K9 and K13 (csrc/decode_split.cuh) run for B
    slots of KVH kv heads over caches of ``rows_max`` rows (a dense cache's
    S, a pool's MP * ps) in key blocks of ``ts`` rows.  One wherever the
    (slot, kv head) blocks alone cover the card's SMs (B * KVH >= 132) or
    the cache is short (rows_max <= 512); else as many as fill the blocks
    the card keeps resident (two an SM, as the cell's ring is sized for),
    each split at least two key blocks.  A function of the shapes alone, so
    the plain versions, the tests and both kernels split alike, and nothing
    reads the card."""
    cells = B * KVH
    if cells >= DECODE_SMS or rows_max <= SPLIT_MIN_ROWS:
        return 1
    blocks = -(-rows_max // ts)
    return max(1, min(DECODE_RESIDENT // cells, blocks // 2))


def split_spans(rows_max: int, ts: int, splits: int) -> list[tuple[int, int]]:
    """The row range [r0, r1) of each split, in order: split i takes the key
    blocks [i * blocks // splits, (i + 1) * blocks // splits) of ``ts`` rows
    (csrc/decode_split.cuh), so spans differ by at most one block and none
    is empty while splits <= blocks."""
    blocks = -(-rows_max // ts)
    return [(min(i * blocks // splits * ts, rows_max),
             min((i + 1) * blocks // splits * ts, rows_max)) for i in range(splits)]


def _check_splits(name: str, splits) -> int | None:
    if splits is not None and (int(splits) != splits or splits < 1):
        raise ValueError(f"{name}: splits must be a positive int, got {splits}")
    return None if splits is None else int(splits)


NORM_SPLITS_MAX = 8  # the portable thread-block cluster size (csrc/decode_split_norm.cuh)


def _norm_block(S: int, itemsize: int) -> int:
    """The ring tile rows of K19's and K21's single-pass cell
    (csrc/decode_split_norm.cuh): K9's default key block (128 rows for
    int8, 64 for f32 and bf16), or S when shorter.  It need not divide S
    (the last tile is partial), and it moves no rounding point: it only
    sets the splits' spans."""
    return min(max(64, 128 // itemsize), S)


def norm_splits(B: int, KVH: int, ts: int, S: int) -> int:
    """How many key-row splits K19 and K21's single-pass form run: the
    split rule of K9 (``decode_splits``) capped at one thread-block
    cluster's NORM_SPLITS_MAX blocks, since the splits of a (slot, kv head)
    agree on the softmax's max and denominator through their cluster's
    shared memory.  A function of the shapes alone, as ``decode_splits``."""
    return min(decode_splits(B, KVH, ts, S), NORM_SPLITS_MAX)


def _check_norm_splits(name: str, splits) -> int | None:
    """``_check_splits``, and at most NORM_SPLITS_MAX (one cluster)."""
    splits = _check_splits(name, splits)
    if splits is not None and splits > NORM_SPLITS_MAX:
        raise ValueError(f"{name}: splits must be at most {NORM_SPLITS_MAX} (the blocks of one "
                         f"thread-block cluster), got {splits}")
    return splits


def _norm_plan(k_cache, B: int, KVH: int, splits) -> tuple[int, int]:
    """(ring tile rows, splits) of the single-pass cell over this cache for
    B slots of KVH kv heads (``splits`` None: ``norm_splits``)."""
    S = k_cache.shape[3]
    ts = _norm_block(S, k_cache.element_size())
    return ts, norm_splits(B, KVH, ts, S) if splits is None else splits


def _span_sum(x, spans):
    """The sum over the last axis, taken span by span and the spans' sums
    added in order (one span: the whole sum)."""
    out = None
    for r0, r1 in spans:
        part = x[..., r0:r1].sum(-1)
        out = part if out is None else out + part
    return out


def _span_pv(pr, vc, spans):
    """sum_s pr[.., s] * f32(v[s, :]) (f32, [B, KVH, G, hd]) taken span by
    span, the spans' partials added in order: the merge of the single-pass
    cell's splits."""
    out = None
    for r0, r1 in spans:
        part = torch.einsum("bkgs,bksd->bkgd", pr[..., r0:r1], vc[:, :, r0:r1].float())
        out = part if out is None else out + part
    return out


def check_cache(name, k_cache, v_cache, k_scale, v_scale, pos, fp_ok: bool = False):
    """Validate a decode step's cache [L, B, KVH, S, hd] -- INT8 with f32
    scales [L, B, KVH, S], or with ``fp_ok`` float32 / bfloat16 without --
    and pos [B]; returns the cache's shape."""
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name}: K and V caches of one dtype")
    if k_cache.dtype != torch.int8 and not fp_ok:
        raise NotImplementedError(f"{name} takes INT8 caches only, as in the JAX package")
    int8 = check_scales(name, k_cache, k_scale, v_scale)
    if k_cache.dim() != 5:
        raise ValueError(f"{name}: want k_cache [L, B, KVH, S, hd]")
    L, B, KVH, S, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or pos.shape != (B,) or (int8 and (
            k_scale.shape != (L, B, KVH, S) or v_scale.shape != k_scale.shape)):
        raise ValueError(f"{name}: shape mismatch: k {tuple(k_cache.shape)}, v "
                         f"{tuple(v_cache.shape)}, ks {None if k_scale is None else tuple(k_scale.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: K/V scales must be float32")
    return L, B, KVH, S, hd


def _check_decode(name, q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale, new_ks,
                  new_vs, layer):
    """Validate a decode-attention call; returns the layer index as a host
    int."""
    L, B, KVH, S, hd = check_cache(name, k_cache, v_cache, k_scale, v_scale, pos, fp_ok=True)
    int8 = k_cache.dtype == torch.int8
    if int8 and (new_ks is None or new_vs is None):
        raise ValueError(f"{name}: INT8 caches need new_ks and new_vs")
    if not int8 and (new_ks is not None or new_vs is not None):
        raise ValueError(f"{name}: the fresh rows of an fp cache have no scales")
    if (q.dim() != 4 or q.shape[:2] != (B, KVH) or q.shape[3] != hd
            or new_k.shape != (B, KVH, hd) or new_v.shape != new_k.shape
            or (int8 and (new_ks.shape != (B, KVH) or new_vs.shape != new_ks.shape))):
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"new_k {tuple(new_k.shape)}")
    if new_k.dtype != k_cache.dtype or new_v.dtype != k_cache.dtype:
        raise TypeError(f"{name}: the fresh rows must be of the cache's dtype {k_cache.dtype}")
    if int8 and (new_ks.dtype != torch.float32 or new_vs.dtype != torch.float32):
        raise TypeError(f"{name}: K/V scales must be float32")
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    return layer


def _fresh_tail_merge(acc, m, l, qs, new_k, new_v, new_ks, new_vs):
    """Merge the fresh K/V column into K9's online-softmax state
    (attention.py:307-332): acc [B, KVH, G, hd] unnormalized, m and l
    [B, KVH, G] the running max and denominator; new_ks / new_vs None for
    an fp cache."""
    s_new = torch.einsum("bhgd,bhd->bhg", qs, new_k.float())
    nv = new_v.float()
    if new_ks is not None:
        s_new = s_new * new_ks[:, :, None]
        nv = nv * new_vs[..., None]
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    e_new = torch.exp(s_new - m_fin)
    l_fin = l * corr + e_new
    return ((acc * corr[..., None] + e_new[..., None] * nv[:, :, None, :])
            / torch.clamp_min(l_fin, 1e-30)[..., None])


def flash_decode_attention_dma_plain(q, k_cache, v_cache, pos, new_k, new_v, k_scale=None,
                                     v_scale=None, new_ks=None, new_vs=None, layer=0,
                                     block_s=None, splits=None):
    """Plain version of K9: the TPU kernel's online softmax over blocks of
    ``block_s`` rows with, for an INT8 cache, the same bf16 roundings (q for
    the score dot, the unnormalized p * vs for the PV dot) -- an fp cache's
    kernel rounds nothing -- run on each of ``splits`` spans of the rows
    (None: ``decode_splits``) and merged in order, then the fresh-column
    merge with the unrounded q.  At one split: the sequential block walk."""
    qs = _scaled_q(q)
    int8 = k_cache.dtype == torch.int8
    S = k_cache.shape[3]
    ts = _dma_block(S, block_s, k_cache.element_size())
    if splits is None:
        splits = decode_splits(q.shape[0], q.shape[1], ts, S)
    acc, m, l = decode_split_softmax(_bf16(qs) if int8 else qs, k_cache, v_cache, k_scale,
                                     v_scale, pos, layer, ts, splits)
    return _fresh_tail_merge(acc, m, l, qs, new_k, new_v, new_ks, new_vs)


def decode_split_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos, layer: int, ts: int,
                         splits: int):
    """The split cell's state (csrc/decode_split.cuh): ``decode_online_
    softmax`` on each span of ``split_spans`` from a fresh state, the
    partials merged in split order (m = max(m, m_i); l and acc rescaled by
    exp(m - m_new) and exp(m_i - m_new)) from m = -1e30, l = 0.  One split
    is ``decode_online_softmax`` itself."""
    if splits == 1:
        return decode_online_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos, layer, ts)
    B, KVH, G, hd = qb.shape
    m = torch.full((B, KVH, G), _NEG_INF, dtype=torch.float32, device=qb.device)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=qb.device)
    acc = torch.zeros((B, KVH, G, hd), dtype=torch.float32, device=qb.device)
    for r0, r1 in split_spans(k_cache.shape[3], ts, splits):
        acc_i, m_i, l_i = decode_online_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos,
                                                layer, ts, span=(r0, r1))
        m_new = torch.maximum(m, m_i)
        ca, cb = torch.exp(m - m_new), torch.exp(m_i - m_new)
        l = l * ca + l_i * cb
        acc = acc * ca[..., None] + acc_i * cb[..., None]
        m = m_new
    return acc, m, l


def decode_online_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos, layer: int, ts: int,
                          span=None):
    """K9's online softmax over blocks of ``ts`` cache rows of ``layer``,
    rows s < pos[b] (of ``span`` = (r0, r1) only, r0 a multiple of ts, when
    given): qb [B, KVH, G, hd] the queries as the score dot takes them (bf16
    values for an INT8 cache, f32 for an fp one, whose scales are None and
    whose p is not rounded).  Returns (acc [B, KVH, G, hd] unnormalized, m,
    l [B, KVH, G]), the state ``_fresh_tail_merge`` finishes.  Every block
    is visited; one past a slot's pos is fully masked, which leaves the
    state unchanged exactly as the kernel's skipped block does."""
    B, KVH, G, hd = qb.shape
    S = k_cache.shape[3]
    r0, r1 = span or (0, S)
    kc, vc = k_cache[layer], v_cache[layer]
    int8 = k_scale is not None
    if int8:
        ks, vs = k_scale[layer], v_scale[layer]
    p = pos.long()[:, None, None, None]
    m = torch.full((B, KVH, G), _NEG_INF, dtype=torch.float32, device=qb.device)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=qb.device)
    acc = torch.zeros((B, KVH, G, hd), dtype=torch.float32, device=qb.device)
    for base in range(r0, r1, ts):
        rows = slice(base, base + ts)
        s = torch.einsum("bkgd,bksd->bkgs", qb, kc[:, :, rows].float())
        if int8:
            s = s * ks[:, :, None, rows]
        valid = torch.arange(base, base + ts, device=qb.device)[None, None, None, :] < p
        m_new = torch.maximum(m, torch.where(valid, s, _NEG_INF).amax(-1))
        corr = torch.exp(m - m_new)
        pr = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + pr.sum(-1)
        if int8:
            pr = _bf16(pr * vs[:, :, None, rows])
        acc = acc * corr[..., None] + torch.einsum("bkgs,bksd->bkgd", pr, vc[:, :, rows].float())
        m = m_new
    return acc, m, l


def flash_decode_attention_fresh_plain(q, k_cache, v_cache, pos, new_k, new_v, k_scale=None,
                                       v_scale=None, new_ks=None, new_vs=None, layer=0,
                                       splits=None):
    """Plain version of K19: one pass over all S rows masked to s < pos, the
    softmax normalized before (INT8 cache) p * vs is rounded to bf16
    (attention.py:150-185); an fp cache's kernel rounds nothing and has no
    scales.  As the kernel's ``splits`` spans of the rows
    (csrc/decode_split_norm.cuh; None: ``norm_splits``) take it: m over
    every score and the fresh one; l the spans' sums of exp(s - m) added in
    span order, exp(s_new - m) last; the PV partials of the spans added in
    order.  At one split the single-pass sums themselves."""
    S = k_cache.shape[3]
    kc, vc = k_cache[layer], v_cache[layer]
    int8 = k_scale is not None
    spans = split_spans(S, *_norm_plan(k_cache, q.shape[0], q.shape[1], splits))
    qs = _scaled_q(q)
    s = torch.einsum("bkgd,bksd->bkgs", _bf16(qs) if int8 else qs, kc.float())
    s_new = (qs * new_k.float()[:, :, None, :]).sum(-1)
    if int8:
        s = s * k_scale[layer][:, :, None, :]
        s_new = s_new * new_ks[:, :, None]
    valid = torch.arange(S, device=q.device)[None, None, None, :] < pos.long()[:, None, None, None]
    s = torch.where(valid, s, _NEG_INF)
    m = torch.maximum(s.amax(-1), s_new)
    e = torch.exp(s - m[..., None])
    e_new = torch.exp(s_new - m)
    l = _span_sum(e, spans) + e_new
    pr = e / l[..., None]
    p_new = e_new / l
    if int8:
        pr = _bf16(pr * v_scale[layer][:, :, None, :])
        p_new = p_new * new_vs[:, :, None]
    return _span_pv(pr, vc, spans) + p_new[..., None] * new_v.float()[:, :, None, :]


def launch_chunk(kernel, k_cache, v_cache, hd, *scales) -> int:
    """The bytes a decode cell copies per cp.async (common.cuh
    dec_issue_tile): 16 when a cache row's bytes and the cache allow, else
    4; raises for a cache the kernels cannot read in place."""
    if not all(t.is_contiguous() for t in (k_cache, v_cache, *scales) if t is not None):
        raise ValueError(f"{kernel} reads the cache where it lies: it must be contiguous")
    row = hd * k_cache.element_size()
    ptrs = (k_cache.data_ptr(), v_cache.data_ptr())
    if row % 16 == 0 and all(a % 16 == 0 for a in ptrs):
        return 16
    if row % 4 == 0 and all(a % 4 == 0 for a in ptrs):
        return 4
    raise NotImplementedError(f"{kernel} copies cache rows in 4-byte chunks: a row of "
                              f"{hd} {k_cache.dtype} must be a multiple of 4 bytes")


def _launch_decode(kernel, q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale, new_ks,
                   new_vs, layer, ts: int, splits: int, workspace: bool):
    """Launch K9 (``ts`` its key block rows; with ``workspace`` its split
    partials and tickets follow) or K19 (``ts`` its ring tile rows), or an
    fp form of either, on CUDA tensors."""
    B, KVH, G, hd = q.shape
    S = k_cache.shape[3]
    if G > 8 or hd > 128:
        raise NotImplementedError(f"{kernel} takes up to 8 query heads per kv head and "
                                  f"head_dim <= 128, got G={G}, hd={hd}")
    ch = launch_chunk(kernel, k_cache, v_cache, hd, k_scale, v_scale)
    qc = q.contiguous()
    nk, nv = new_k.contiguous(), new_v.contiguous()
    nks, nvs = (None, None) if new_ks is None else (new_ks.contiguous(), new_vs.contiguous())
    p32 = pos.to(torch.int32).contiguous()  # no copy for the model's int32 positions
    out = torch.empty((B, KVH, G, hd), dtype=torch.float32, device=q.device)
    sqrt_hd = float(sqrt_f32(hd))  # jnp.sqrt(f32(hd))
    st = _kernels.stream(qc)
    ws = split_workspace(B, KVH, G, hd, splits, q.device, st) if workspace else ()
    _kernels.launch(kernel, qc.data_ptr(), _kernels.dtype_code(qc.dtype),
                    _kernels.cache_code(k_cache.dtype), k_cache.data_ptr(), v_cache.data_ptr(),
                    _ptr(k_scale), _ptr(v_scale), p32.data_ptr(), nk.data_ptr(), nv.data_ptr(),
                    _ptr(nks), _ptr(nvs), out.data_ptr(), layer, B, KVH, G, S, hd, ts, splits,
                    sqrt_hd, ch, *(_ptr(t) for t in ws), st)
    return out


def _decode_tensors(*arrays):
    return tuple(t for t in arrays if t is not None)


_TICKETS: dict[tuple, torch.Tensor] = {}
_PARTIALS: dict[tuple, torch.Tensor] = {}


def split_workspace(B: int, KVH: int, G: int, hd: int, splits: int, device, stream: int):
    """(ws, ticket) for a launch of the split cell on ``stream`` of
    ``device``: the partials ws f32 [>= B * KVH * splits * (G * hd + 2 * G)]
    (any contents) and the counters ticket int32 [>= B * KVH], zero, which
    every launch leaves zero again.  One pair per (card, stream), grown as
    needed: launches on one stream run in order, so none overlaps another's
    use; (None, None) at one split."""
    if splits == 1:
        return None, None
    key = (device, stream)
    n = B * KVH * splits * (G * hd + 2 * G)
    ws = _PARTIALS.get(key)
    if ws is None or ws.numel() < n:
        ws = _PARTIALS[key] = torch.empty(n, dtype=torch.float32, device=device)
    t = _TICKETS.get(key)
    if t is None or t.numel() < B * KVH:
        t = _TICKETS[key] = torch.zeros(max(B * KVH, 256), dtype=torch.int32, device=device)
    return ws, t


def flash_decode_attention_dma(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               pos: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
                               k_scale=None, v_scale=None, new_ks=None, new_vs=None, layer=None,
                               block_s: int | None = None,
                               splits: int | None = None) -> torch.Tensor:
    """Deferred-flush decode attention that reads only each slot's rows below
    pos (K9).  q [B, KVH, G, hd] raw queries (f32 or bf16); caches
    [L, B, KVH, S, hd], INT8 with f32 scales [L, B, KVH, S] or float32 /
    bfloat16 without; pos [B]; the step's fresh rows new_k/new_v [B, KVH, hd]
    of the cache's dtype (int8 with scales new_ks/new_vs [B, KVH]);
    ``layer`` a host int (a tensor is read back to the host).  Cache row s
    attends iff s < pos[b]; the fresh row is one more column.  ``block_s``
    is the online softmax's key block (default 128 rows for int8, 64 for
    fp); ``splits`` how many spans of the rows run in parallel, merged
    after (None: ``decode_splits``; at more than one, within 2^-8 of max
    |out| of the sequential walk).  Returns f32 [B, KVH, G, hd].  K9 on
    CUDA tensors (``K9:f32`` / ``K9:bf16`` for an fp cache), the plain
    version on CPU ones."""
    layer = _check_decode("flash_decode_attention_dma", q, k_cache, v_cache, pos, new_k, new_v,
                          k_scale, v_scale, new_ks, new_vs, layer)
    splits = _check_splits("flash_decode_attention_dma", splits)
    args = (q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale, new_ks, new_vs)
    kernel = _kernels.form("K9", k_cache.dtype)
    if _kernels.on_cpu(kernel, *_decode_tensors(*args)):
        return flash_decode_attention_dma_plain(*args, layer=layer, block_s=block_s,
                                                splits=splits)
    S = k_cache.shape[3]
    ts = _dma_block(S, block_s, k_cache.element_size())
    if ts > 256:
        raise NotImplementedError(f"K9 takes key blocks of at most 256 rows, got {ts}")
    n = decode_splits(q.shape[0], q.shape[1], ts, S) if splits is None else splits
    return _launch_decode(kernel, *args, layer, ts, n, workspace=True)


def flash_decode_attention_fresh(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor,
                                 new_k: torch.Tensor, new_v: torch.Tensor, k_scale=None,
                                 v_scale=None, new_ks=None, new_vs=None, layer=None,
                                 splits: int | None = None) -> torch.Tensor:
    """Deferred-flush decode attention, single pass (K19): the contract of
    :func:`flash_decode_attention_dma` with, for an INT8 cache, the softmax
    normalized before the bf16 rounding of p.  ``splits`` (1 to 8; None:
    ``norm_splits``) spans of each slot's rows run in one thread-block
    cluster, which agrees on the softmax's max and denominator before any
    p is rounded: only the f32 order of the sums moves with it.  Returns
    f32 [B, KVH, G, hd].  K19 on CUDA tensors (every score of a split's
    span in shared memory, so G x span is bounded; ``K19:f32`` /
    ``K19:bf16`` for an fp cache), the plain version on CPU ones."""
    layer = _check_decode("flash_decode_attention_fresh", q, k_cache, v_cache, pos, new_k,
                          new_v, k_scale, v_scale, new_ks, new_vs, layer)
    splits = _check_norm_splits("flash_decode_attention_fresh", splits)
    args = (q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale, new_ks, new_vs)
    kernel = _kernels.form("K19", k_cache.dtype)
    if _kernels.on_cpu(kernel, *_decode_tensors(*args)):
        return flash_decode_attention_fresh_plain(*args, layer=layer, splits=splits)
    ts, n = _norm_plan(k_cache, q.shape[0], q.shape[1], splits)
    return _launch_decode(kernel, *args, layer, ts, n, workspace=False)


# ---------------------------------------------------------------------------
# K21: write-then-attend decode attention, the unfused tensor-parallel
# decode's (llama.py:636-654 through parallel/tp.py:149-150): the step's row
# is in the cache before the call, and rows s <= pos attend.
# ---------------------------------------------------------------------------


def _k21_block(S: int, block_s: int | None) -> int:
    """K21's key block (attention.py:658-661): ``block_s`` (default S, one
    block: the single-pass form), halved until it divides S."""
    ts = min(block_s or S, S)
    while S % ts:
        ts //= 2
    return ts


def _check_k21(q, k_cache, v_cache, pos, k_scale, v_scale, layer) -> int:
    """Validate a K21 call; returns the layer as a host int."""
    L, B, KVH, S, hd = check_cache("flash_decode_attention", k_cache, v_cache, k_scale, v_scale,
                                   pos, fp_ok=True)
    if q.dim() != 4 or q.shape[:2] != (B, KVH) or q.shape[3] != hd:
        raise ValueError(f"flash_decode_attention: q {tuple(q.shape)} against a cache "
                         f"{tuple(k_cache.shape)}")
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"flash_decode_attention: layer {layer} outside [0, {L})")
    return layer


def flash_decode_attention_plain(q, k_cache, v_cache, pos, k_scale=None, v_scale=None,
                                 block_s=None, layer=0, splits=None):
    """Plain version of K21.  One key block (the default): the single-pass
    softmax over rows s <= pos, normalized before, for an INT8 cache, p * vs
    is rounded to bf16 (attention.py:569-603), with l and the PV dot taken
    as the kernel's ``splits`` spans of the rows take them (None:
    ``norm_splits``; see :func:`flash_decode_attention_fresh_plain`).
    Smaller blocks: K9's online softmax (unnormalized p rounded per block)
    over rows s <= pos, then acc / max(l, 1e-30) (:38-124 without the fresh
    refs).  The scores take bf16(qs) for an INT8 cache and f32 qs for an fp
    one, which rounds nothing.  A negative pos attends nothing (zeros)."""
    qs = _scaled_q(q)
    int8 = k_cache.dtype == torch.int8
    qb = _bf16(qs) if int8 else qs
    S = k_cache.shape[3]
    ts = _k21_block(S, block_s)
    if ts < S:
        acc, _, l = decode_online_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos.long() + 1,
                                          layer, ts)
        return acc / torch.clamp_min(l, 1e-30)[..., None]
    spans = split_spans(S, *_norm_plan(k_cache, q.shape[0], q.shape[1], splits))
    kc, vc = k_cache[layer], v_cache[layer]
    s = torch.einsum("bkgd,bksd->bkgs", qb, kc.float())
    if int8:
        s = s * k_scale[layer][:, :, None, :]
    valid = torch.arange(S, device=q.device)[None, None, None, :] <= pos.long()[:, None, None, None]
    s = torch.where(valid, s, _NEG_INF)
    e = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    pr = e / torch.clamp_min(_span_sum(e, spans)[..., None], 1e-30)
    if int8:
        pr = _bf16(pr * v_scale[layer][:, :, None, :])
    return _span_pv(pr, vc, spans)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor, k_scale=None, v_scale=None,
                           block_s: int | None = None, layer=None,
                           splits: int | None = None) -> torch.Tensor:
    """Write-then-attend decode attention (K21): q [B, KVH, G, hd] raw
    queries (f32 or bf16) over the cache [L, B, KVH, S, hd] (or one layer
    [B, KVH, S, hd]), INT8 with f32 scales [L, B, KVH, S] or float32 /
    bfloat16 without; pos [B]; ``layer`` a host int (a tensor is read back).
    Cache row s attends iff s <= pos[b]: the step's row must already be
    written.  ``block_s`` None (the default) reads each slot's rows in one
    block, the single-pass form, whose ``splits`` (1 to 8; None:
    ``norm_splits``) spans of the rows run in one thread-block cluster; a
    smaller block runs the blocked online softmax, which rounds at other
    points (see :func:`flash_decode_attention_plain`) and takes no splits.
    Returns f32 [B, KVH, G, hd].  K21 on CUDA tensors (``K21:f32`` /
    ``K21:bf16`` for an fp cache), the plain version on CPU ones."""
    if k_cache.dim() == 4:  # one layer (attention.py:642-646)
        k_cache, v_cache = k_cache[None], v_cache[None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
        layer = 0
    layer = _check_k21(q, k_cache, v_cache, pos, k_scale, v_scale, layer)
    splits = _check_norm_splits("flash_decode_attention", splits)
    S = k_cache.shape[3]
    blocked = _k21_block(S, block_s) < S
    if blocked and splits not in (None, 1):
        raise ValueError(f"flash_decode_attention: splits are the single-pass form's; the "
                         f"blocked form (block_s {block_s} < S {S}) takes none, got {splits}")
    kernel = _kernels.form("K21", k_cache.dtype)
    if _kernels.on_cpu(kernel, *_decode_tensors(q, k_cache, v_cache, pos, k_scale, v_scale)):
        return flash_decode_attention_plain(q, k_cache, v_cache, pos, k_scale, v_scale, block_s,
                                            layer, splits)
    B, KVH, G, hd = q.shape
    # splits 0 launches the blocked form (csrc/flash_decode.cu)
    ts, n = (_k21_block(S, block_s), 0) if blocked else _norm_plan(k_cache, B, KVH, splits)
    if G > 8 or hd > 128 or (blocked and ts > 256):
        raise NotImplementedError(f"K21 takes up to 8 query heads per kv head, head_dim <= 128 "
                                  f"and key blocks of S or of at most 256 rows, got G={G}, "
                                  f"hd={hd}, block {ts}")
    ch = launch_chunk(kernel, k_cache, v_cache, hd, k_scale, v_scale)
    qc = q.contiguous()
    p32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, KVH, G, hd), dtype=torch.float32, device=q.device)
    _kernels.launch(kernel, qc.data_ptr(), _kernels.dtype_code(qc.dtype),
                    _kernels.cache_code(k_cache.dtype), k_cache.data_ptr(), v_cache.data_ptr(),
                    _ptr(k_scale), _ptr(v_scale), p32.data_ptr(), out.data_ptr(), layer, B, KVH,
                    G, S, hd, ts, n, float(sqrt_f32(hd)), ch, _kernels.stream(qc))
    return out


def _check_flush(rows_k, rows_v, pos, ck, cv, rows_ks, rows_vs, cks, cvs):
    int8 = check_scales("kv_cache_flush_rows", ck, rows_ks, rows_vs, cks, cvs)
    if rows_k.dim() != 4 or ck.dim() != 5:
        raise ValueError("want rows_k [L, B, KVH, hd] and ck [L, B, KVH, S, hd]")
    L, B, KVH, hd = rows_k.shape
    S = ck.shape[3]
    if (rows_v.shape != rows_k.shape or ck.shape != (L, B, KVH, S, hd) or cv.shape != ck.shape
            or pos.shape != (B,) or (int8 and (
                rows_ks.shape != (L, B, KVH) or rows_vs.shape != rows_ks.shape
                or cks.shape != (L, B, KVH, S) or cvs.shape != cks.shape))):
        raise ValueError("kv_cache_flush_rows: shape mismatch")
    if any(t.dtype != ck.dtype for t in (rows_k, rows_v, cv)) or (int8 and any(
            t.dtype != torch.float32 for t in (rows_ks, rows_vs, cks, cvs))):
        raise TypeError("kv_cache_flush_rows takes rows of the cache's dtype and float32 scales")


def kv_cache_flush_rows_plain(rows_k, rows_v, pos, ck, cv, rows_ks=None, rows_vs=None,
                              cks=None, cvs=None):
    """Plain version of K10: one indexed write per array, in place, of the
    slots whose pos lies in [0, S); the others are skipped."""
    L, B, KVH, _ = rows_k.shape
    p = pos.long()
    ok = ((p >= 0) & (p < ck.shape[3])).nonzero().flatten()
    l_ix = torch.arange(L, device=ck.device)[:, None, None]
    h_ix = torch.arange(KVH, device=ck.device)[None, None, :]
    b_ix, p_ix = ok[None, :, None], p[ok][None, :, None]
    pairs = [(ck, rows_k), (cv, rows_v)]
    if rows_ks is not None:
        pairs += [(cks, rows_ks), (cvs, rows_vs)]
    for dst, src in pairs:
        dst[l_ix, b_ix, h_ix, p_ix] = src[:, ok]
    return tuple(dst for dst, _ in pairs)


def kv_cache_flush_rows(rows_k, rows_v, pos, ck, cv, rows_ks=None, rows_vs=None, cks=None,
                        cvs=None):
    """Write every layer's fresh row IN PLACE at its slot's position:
    ``ck[l, b, :, pos[b]] = rows_k[l, b]`` for K and V, and for an INT8
    cache both scale arrays.  rows_k/rows_v [L, B, KVH, hd] of the cache's
    dtype, pos [B] (read on the device), ck/cv [L, B, KVH, S, hd]; for an
    INT8 cache rows_ks/rows_vs f32 [L, B, KVH] and cks/cvs f32
    [L, B, KVH, S].  A slot whose pos lies outside [0, S) is skipped.
    Returns the (updated) cache arrays: (ck, cv, cks, cvs), or (ck, cv) for
    an fp cache.  K10 on CUDA tensors (``K10:f32`` / ``K10:bf16`` for an fp
    cache), the plain version on CPU ones; a launch's checks are made once
    per ``_flush_key``."""
    arrays = (rows_k, rows_v, pos, ck, cv, rows_ks, rows_vs, cks, cvs)
    key = _flush_key(arrays)
    plan = _FLUSH_PLANS.get(key)
    if plan is None:
        _check_flush(*arrays)
        kernel = _kernels.form("K10", ck.dtype)
        if _kernels.on_cpu(kernel, *_decode_tensors(*arrays)):
            return kv_cache_flush_rows_plain(*arrays)
        if not all(t.is_contiguous() for t in _decode_tensors(ck, cv, cks, cvs)):
            raise ValueError("K10 writes the cache in place: it must be contiguous")
        if not _flush_ready(pos, rows_k, rows_v, rows_ks, rows_vs):
            rk, rv, rks, rvs = _contiguous(rows_k, rows_v, rows_ks, rows_vs)
            return kv_cache_flush_rows(rk, rv, pos.to(torch.int32).contiguous(), ck, cv, rks,
                                       rvs, cks, cvs)
        L, B, KVH, hd = rows_k.shape
        ptrs = (_ptr(t) or 0 for t in (rows_k, rows_v, rows_ks, rows_vs, pos, ck, cv, cks, cvs))
        plan = _flush_plan(key, kernel, ck.get_device(), [
            *ptrs, _kernels.cache_code(ck.dtype), L, B, KVH, ck.shape[3], hd,
            int(_vec16(hd, rows_k, rows_v, ck, cv))])
    kernel, fn, args, dev = plan
    _kernels.call(kernel, fn, args, _kernels.device_stream(dev))
    return (ck, cv) if cks is None else (ck, cv, cks, cvs)


# K10's and K14's launches by ``_flush_key``: a decode step flushes rows of
# one geometry into one cache every step (mega2's flush buffers and pos come
# back from the allocator at the same addresses), so a key's checks, its
# tests of what needs converting and its packed C arguments are made once.
# A key holds every tensor's data pointer, shape, dtype and contiguity: a
# changed one is a new key, checked anew.  Only card launches are kept.
_FLUSH_PLANS: dict[tuple, tuple] = {}
_FLUSH_PLANS_MAX = 64


def _flush_key(arrays) -> tuple:
    """The fingerprint of a flush's tensors (None for an absent one)."""
    return tuple([None if t is None else (t.data_ptr(), t.shape, t.dtype, t.is_contiguous())
                  for t in arrays])


def _flush_ready(pos, *inputs) -> bool:
    """Whether pos is int32 and it and the other inputs are contiguous, as
    the kernel reads them."""
    return (pos.dtype == torch.int32 and pos.is_contiguous()
            and all(t is None or t.is_contiguous() for t in inputs))


def _contiguous(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def _flush_plan(key: tuple, kernel: str, device: int, args: list) -> tuple:
    """Keep a checked launch of ``kernel`` on card ``device`` under ``key``:
    (kernel id, C entry point, packed int64 arguments, card index)."""
    if len(_FLUSH_PLANS) >= _FLUSH_PLANS_MAX:
        _FLUSH_PLANS.clear()
    plan = (kernel, _kernels.entry(kernel), (ctypes.c_longlong * len(args))(*args), device)
    _FLUSH_PLANS[key] = plan
    return plan


def _check_write_decode(k, v, pos, layer, ck, cv, cks, cvs) -> int:
    """Validate a K28 call; returns the layer as a host int."""
    check_scales("kv_cache_write_decode", ck, cks, cvs)
    if ck.dim() != 5 or k.dim() != 3:
        raise ValueError("want k [B, KVH, hd] and ck [L, B, KVH, S, hd]")
    L, B, KVH, S, hd = ck.shape
    if (k.shape != (B, KVH, hd) or v.shape != k.shape or cv.shape != ck.shape
            or pos.shape != (B,) or (cks is not None and (
                cks.shape != (L, B, KVH, S) or cvs.shape != cks.shape))):
        raise ValueError(f"kv_cache_write_decode: shape mismatch: k {tuple(k.shape)}, ck "
                         f"{tuple(ck.shape)}, pos {tuple(pos.shape)}")
    if cv.dtype != ck.dtype or (cks is not None and (
            cks.dtype != torch.float32 or cvs.dtype != torch.float32)):
        raise TypeError("kv_cache_write_decode: K and V caches of one dtype, f32 scales")
    if not k.dtype.is_floating_point or not v.dtype.is_floating_point:
        raise TypeError("kv_cache_write_decode: k and v are floating point")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"kv_cache_write_decode: layer {layer} outside [0, {L})")
    return layer


def kv_cache_write_decode_plain(k, v, pos, layer: int, ck, cv, cks=None, cvs=None):
    """Plain version of K28: f32 rows, quantized per (slot, head) for an
    INT8 cache (``quantize_kv``'s jitted formula) or cast to the cache's
    dtype, written by one indexed write per array at (layer, b, pos[b]) of
    the slots whose pos lies in [0, S)."""
    B, KVH, hd = k.shape
    p = pos.long()
    ok = ((p >= 0) & (p < ck.shape[3])).nonzero().flatten()
    h_ix = torch.arange(KVH, device=ck.device)[None, :]
    b_ix, p_ix = ok[:, None], p[ok][:, None]
    pairs = []
    for x, dst, dst_s in ((k, ck, cks), (v, cv, cvs)):
        xf = x.float()
        if dst_s is None:
            pairs.append((dst, xf.to(dst.dtype)))
        else:
            q, s = quantize_kv(xf)
            pairs += [(dst, q), (dst_s, s)]
    for dst, src in pairs:
        dst[layer, b_ix, h_ix, p_ix] = src[ok]
    return (ck, cv) if cks is None else (ck, cv, cks, cvs)


def kv_cache_write_decode(k, v, pos, layer, ck, cv, cks=None, cvs=None):
    """Write one layer's decode rows IN PLACE: ``ck[layer, b, :, pos[b]]``
    and ``cv``'s from k, v [B, KVH, hd] (any float dtype, taken as f32, as
    the JAX function casts them); an INT8 cache quantizes each row in the
    kernel (absmax over hd, s = absmax * f32(1/127), rint, clip to +-127, a
    zero row gives scale 0) and writes its scale into cks / cvs f32
    [L, B, KVH, S]; an fp cache (float32, bfloat16; no scales) takes the
    values cast to its dtype.  pos [B] is read on the device; a slot whose
    pos lies outside [0, S) is skipped (the JAX kernel leaves it
    undefined).  ``layer`` a host int.  Returns the updated cache arrays
    ((ck, cv, cks, cvs), or (ck, cv) for an fp cache).  No decode path
    calls it: the JAX package's only caller is a benchmark tool.  K28 on
    CUDA tensors (``K28:f32`` / ``K28:bf16`` for an fp cache), the plain
    version on CPU ones."""
    layer = _check_write_decode(k, v, pos, layer, ck, cv, cks, cvs)
    kernel = _kernels.form("K28", ck.dtype)
    if _kernels.on_cpu(kernel, *_decode_tensors(k, v, pos, ck, cv, cks, cvs)):
        return kv_cache_write_decode_plain(k, v, pos, layer, ck, cv, cks, cvs)
    if not all(t.is_contiguous() for t in _decode_tensors(ck, cv, cks, cvs)):
        raise ValueError("K28 writes the cache in place: it must be contiguous")
    _, B, KVH, S, hd = ck.shape
    kf, vf = k.float().contiguous(), v.float().contiguous()
    p32 = pos.to(torch.int32).contiguous()
    _kernels.launch(kernel, kf.data_ptr(), vf.data_ptr(), p32.data_ptr(), ck.data_ptr(),
                    cv.data_ptr(), _ptr(cks), _ptr(cvs), _kernels.cache_code(ck.dtype), layer,
                    B, KVH, S, hd, _kernels.stream(ck))
    return (ck, cv) if cks is None else (ck, cv, cks, cvs)


# ---------------------------------------------------------------------------
# The paged INT8 cache (models.llama.PagedKVCache): pools k, v int8
# [L, P, KVH, ps, hd] and scales ks, vs f32 [L, P, KVH, ps]; slot b's
# position s lives in page page_table[b, s // ps], row s % ps; page 0 is the
# trash page.  K15 lands a compact prefilled block in the pool, K13 / K20
# attend over the pages below each slot's pos plus the step's fresh row, and
# K14 writes the step's rows (attention.py:466, :1012, :1095, :1301).
# ---------------------------------------------------------------------------


def _check_pool(name, ck, cv, cks, cvs, page_table):
    """Validate a pool [L, P, KVH, ps, hd] with scales [L, P, KVH, ps] and
    a page table int32 [B, MP]; returns (L, P, KVH, ps, hd, B, MP)."""
    if ck.dim() != 5 or page_table.dim() != 2:
        raise ValueError(f"{name}: want pools [L, P, KVH, ps, hd] and page_table [B, MP]")
    L, P, KVH, ps, hd = ck.shape
    if cv.shape != ck.shape or cks.shape != (L, P, KVH, ps) or cvs.shape != cks.shape:
        raise ValueError(f"{name}: pool shape mismatch: k {tuple(ck.shape)}, v {tuple(cv.shape)}, "
                         f"ks {tuple(cks.shape)}, vs {tuple(cvs.shape)}")
    if ck.dtype != torch.int8 or cv.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (cks, cvs)):
        raise TypeError(f"{name}: a paged cache is int8 with float32 scales")
    if page_table.dtype != torch.int32:
        raise TypeError(f"{name}: the page table is int32")
    return (L, P, KVH, ps, hd, *page_table.shape)


def _pool_in_place(name, *pools) -> None:
    if not all(t.is_contiguous() for t in pools):
        raise ValueError(f"{name} writes the pool in place: it must be contiguous")


def kv_pool_scatter_pages_plain(small_k, small_v, small_ks, small_vs, slots, page_table, ck, cv,
                                cks, cvs):
    """Plain version of K15: T padded with zeros to whole pages, then one
    indexed copy of whole pages per array, in place (several slots' pages
    past their reservation all land on page 0, in no set order)."""
    L, n, KVH, T, hd = small_k.shape
    ps = ck.shape[3]
    npg = -(-T // ps)
    sl = torch.as_tensor(slots, dtype=torch.long, device=page_table.device)
    pages = page_table[sl][:, :npg].long().to(ck.device)  # [n, npg]
    pairs = ((ck, small_k), (cv, small_v), (cks, small_ks), (cvs, small_vs))
    for dst, src in pairs:
        pad = (0, 0, 0, npg * ps - T) if src.dim() == 5 else (0, npg * ps - T)
        blk = torch.nn.functional.pad(src, pad)  # [L, n, KVH, npg * ps(, hd)]
        blk = blk.reshape(L, n, KVH, npg, ps, *src.shape[4:]).transpose(2, 3)
        dst[:, pages] = blk.to(dst.dtype)
    return ck, cv, cks, cvs


def kv_pool_scatter_pages(small_k, small_v, small_ks, small_vs, slots, page_table, ck, cv, cks,
                          cvs):
    """Land a compact prefilled INT8 block in the page pool, whole pages at a
    time, IN PLACE: page j of block slot i (rows [j * ps, (j + 1) * ps) of
    small_k[:, i], zero past T) over pool page ``page_table[slots[i], j]``,
    for K, V and both scale arrays.  small_k/small_v int8 [L, n, KVH, T, hd],
    small_ks/small_vs f32 [L, n, KVH, T]; slots n host ints (distinct, < B;
    a tensor is read back to the host for the check); page_table int32
    [B, MP] on the pool's device; pools as ``PagedKVCache``.  A page past a
    slot's reservation is 0 in the table: those rows land on the trash
    page.  Returns the (updated) pools.  K15 on CUDA tensors, the plain
    version on CPU ones."""
    L, P, KVH, ps, hd, B, MP = _check_pool("kv_pool_scatter_pages", ck, cv, cks, cvs, page_table)
    if small_k.dim() != 5:
        raise ValueError("kv_pool_scatter_pages: want small_k [L, n, KVH, T, hd]")
    n, T = small_k.shape[1], small_k.shape[3]
    if (small_k.shape != (L, n, KVH, T, hd) or small_v.shape != small_k.shape
            or small_ks.shape != (L, n, KVH, T) or small_vs.shape != small_ks.shape):
        raise ValueError(f"kv_pool_scatter_pages: block {tuple(small_k.shape)}, scales "
                         f"{tuple(small_ks.shape)}, pool {tuple(ck.shape)}")
    if any(t.dtype != torch.int8 for t in (small_k, small_v)) or any(
            t.dtype != torch.float32 for t in (small_ks, small_vs)):
        raise TypeError("kv_pool_scatter_pages takes int8 K/V and float32 scales")
    if T > MP * ps:
        raise ValueError(f"a block of {T} rows does not fit {MP} pages of {ps}")
    idx = [int(s) for s in (slots.tolist() if isinstance(slots, torch.Tensor) else slots)]
    if len(idx) != n or any(not 0 <= s < B for s in idx) or len(set(idx)) != n:
        raise ValueError(f"slots {idx}: want {n} distinct slots in [0, {B})")
    if _kernels.on_cpu("K15", small_k, small_v, small_ks, small_vs, page_table, ck, cv, cks, cvs):
        return kv_pool_scatter_pages_plain(small_k, small_v, small_ks, small_vs, idx, page_table,
                                           ck, cv, cks, cvs)
    _pool_in_place("K15", ck, cv, cks, cvs)
    sk, sv, sks, svs = (t.contiguous() for t in (small_k, small_v, small_ks, small_vs))
    pt = page_table.contiguous()
    sl = upload(idx, ck.device, torch.int32)
    vec = _vec16(hd, sk, sv, ck, cv)
    _kernels.launch("K15", sk.data_ptr(), sv.data_ptr(), sks.data_ptr(), svs.data_ptr(),
                    sl.data_ptr(), pt.data_ptr(), ck.data_ptr(), cv.data_ptr(), cks.data_ptr(),
                    cvs.data_ptr(), L, n, KVH, T, hd, P, ps, MP, int(vec), _kernels.stream(ck))
    return ck, cv, cks, cvs


def _flush_targets(pos, page_table, P: int, ps: int):
    """The slots K14 writes and where: (slots, pages, rows).  A negative pos
    or a page id outside [0, P) is skipped; a position past the table goes
    to page 0."""
    MP = page_table.shape[1]
    p = pos.long()
    col = torch.div(p, ps, rounding_mode="floor")
    page = torch.where(col < MP, page_table.long().gather(1, col.clamp(0, MP - 1)[:, None])[:, 0],
                       0)
    ok = ((p >= 0) & (page >= 0) & (page < P)).nonzero().flatten()
    return ok, page[ok], p[ok] % ps


def kv_pool_flush_rows_plain(rows_k, rows_v, rows_ks, rows_vs, pos, page_table, ck, cv, cks,
                             cvs):
    """Plain version of K14: one indexed write per array, in place."""
    L, B, KVH, _ = rows_k.shape
    ok, page, row = _flush_targets(pos, page_table, ck.shape[1], ck.shape[3])
    l_ix = torch.arange(L, device=ck.device)[:, None, None]
    h_ix = torch.arange(KVH, device=ck.device)[None, None, :]
    pg, r = page[None, :, None], row[None, :, None]
    for dst, src in ((ck, rows_k), (cv, rows_v), (cks, rows_ks), (cvs, rows_vs)):
        dst[l_ix, pg, h_ix, r] = src[:, ok]
    return ck, cv, cks, cvs


def _check_pool_flush(rows_k, rows_v, rows_ks, rows_vs, pos, page_table, ck, cv, cks, cvs):
    L, P, KVH, ps, hd, B, MP = _check_pool("kv_pool_flush_rows", ck, cv, cks, cvs, page_table)
    if (rows_k.shape != (L, B, KVH, hd) or rows_v.shape != rows_k.shape
            or rows_ks.shape != (L, B, KVH) or rows_vs.shape != rows_ks.shape
            or pos.shape != (B,)):
        raise ValueError(f"kv_pool_flush_rows: rows {tuple(rows_k.shape)}, scales "
                         f"{tuple(rows_ks.shape)}, pos {tuple(pos.shape)}, pool {tuple(ck.shape)}")
    if any(t.dtype != torch.int8 for t in (rows_k, rows_v)) or any(
            t.dtype != torch.float32 for t in (rows_ks, rows_vs)):
        raise TypeError("kv_pool_flush_rows takes int8 rows and float32 scales")
    return L, P, KVH, ps, hd, B, MP


def kv_pool_flush_rows(rows_k, rows_v, rows_ks, rows_vs, pos, page_table, ck, cv, cks, cvs):
    """Write every layer's fresh INT8 row IN PLACE at each slot's position:
    ``ck[l, page, :, pos[b] % ps] = rows_k[l, b]`` with ``page =
    page_table[b, pos[b] // ps]`` for K, V and both scale arrays.  rows_k /
    rows_v int8 [L, B, KVH, hd], rows_ks / rows_vs f32 [L, B, KVH], pos [B]
    and page_table int32 [B, MP] (read on the device); pools as
    ``PagedKVCache``.  A position past the table goes to the trash page 0
    (attention.py:1324-1330), so does a parked slot (its table row is 0); a
    negative pos, or a page id outside [0, P), is skipped (the JAX package
    leaves both undefined).  Returns the (updated) pools.  K14 on CUDA
    tensors, the plain version on CPU ones; a launch's checks are made once
    per ``_flush_key``."""
    arrays = (rows_k, rows_v, rows_ks, rows_vs, pos, page_table, ck, cv, cks, cvs)
    key = _flush_key(arrays)
    plan = _FLUSH_PLANS.get(key)
    if plan is None:
        L, P, KVH, ps, hd, B, MP = _check_pool_flush(*arrays)
        if _kernels.on_cpu("K14", *arrays):
            return kv_pool_flush_rows_plain(*arrays)
        _pool_in_place("K14", ck, cv, cks, cvs)
        if not _flush_ready(pos, rows_k, rows_v, rows_ks, rows_vs, page_table):
            return kv_pool_flush_rows(*_contiguous(rows_k, rows_v, rows_ks, rows_vs),
                                      pos.to(torch.int32).contiguous(), page_table.contiguous(),
                                      ck, cv, cks, cvs)
        plan = _flush_plan(key, "K14", ck.get_device(), [
            *(t.data_ptr() for t in arrays), L, B, KVH, P, ps, MP, hd,
            int(_vec16(hd, rows_k, rows_v, ck, cv))])
    kernel, fn, args, dev = plan
    _kernels.call(kernel, fn, args, _kernels.device_stream(dev))
    return ck, cv, cks, cvs


def _paged_block(ps: int) -> int:
    """K13's key block: min(256, ps), halved until it divides ps
    (attention.py:487-489); also the rows of K20's and K22's ring tiles,
    whose rounding block is the whole page (csrc/decode_split_page.cuh)."""
    ts = min(256, ps)
    while ps % ts:
        ts //= 2
    return ts


def paged_view(pool, page_table, layer: int):
    """Layer ``layer`` of a pool [L, P, KVH, ps(, hd)] as each slot's dense
    rows [1, B, KVH, MP * ps(, hd)] through the page table (a page id
    outside [0, P) reads page 0, as the kernels do): the cache the plain
    decode attention walks."""
    P, ps = pool.shape[1], pool.shape[3]
    pt = page_table.long().to(pool.device)
    pt = torch.where((pt >= 0) & (pt < P), pt, 0)
    B, MP = pt.shape
    v = pool[layer][pt]  # [B, MP, KVH, ps(, hd)]
    return v.transpose(1, 2).reshape(B, v.shape[2], MP * ps, *v.shape[4:])[None]


def _check_paged_q(name, q, k_pool, v_pool, k_scale, v_scale, page_table, pos, layer):
    """Validate a paged decode-attention call's queries, pools, table and
    positions; returns the layer as a host int."""
    L, P, KVH, ps, hd, B, MP = _check_pool(name, k_pool, v_pool, k_scale, v_scale, page_table)
    if q.dim() != 4 or q.shape[:2] != (B, KVH) or q.shape[3] != hd or pos.shape != (B,):
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"page_table {tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    return layer


def _check_paged_decode(name, q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v,
                        new_ks, new_vs, layer):
    """``_check_paged_q`` and the step's fresh rows; returns the layer as a
    host int."""
    layer = _check_paged_q(name, q, k_pool, v_pool, k_scale, v_scale, page_table, pos, layer)
    B, KVH, _, hd = q.shape
    if (new_k.shape != (B, KVH, hd) or new_v.shape != new_k.shape
            or new_ks.shape != (B, KVH) or new_vs.shape != new_ks.shape):
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, new_k {tuple(new_k.shape)}, "
                         f"new_ks {tuple(new_ks.shape)}")
    if any(t.dtype != torch.int8 for t in (new_k, new_v)) or any(
            t.dtype != torch.float32 for t in (new_ks, new_vs)):
        raise TypeError(f"{name}: the fresh rows are int8 with float32 scales")
    return layer


def _paged_online(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, layer: int, ts: int,
                  splits: int = 1):
    """K9's online softmax (``decode_split_softmax``) over the slots' pages
    of ``layer`` as dense rows, key blocks of ``ts`` rows, in ``splits``
    spans; returns (qs, acc, m, l)."""
    qs = _scaled_q(q)
    views = [paged_view(a, page_table, layer) for a in (k_pool, v_pool, k_scale, v_scale)]
    return (qs, *decode_split_softmax(_bf16(qs), *views, pos, 0, ts, splits))


def _paged_splits(q, k_pool, page_table, splits) -> int:
    """K13's splits: ``splits``, or the rule's for rows_max = MP * ps."""
    if splits is not None:
        return splits
    return decode_splits(q.shape[0], q.shape[1], _paged_block(k_pool.shape[3]),
                         page_table.shape[1] * k_pool.shape[3])


def page_splits(q, k_pool, page_table, splits) -> int:
    """K20's and K22's splits, runs of whole pages: ``splits``, or K13's
    count (``_paged_splits``) capped at the page count MP.  A function of
    the shapes alone, as ``decode_splits``."""
    if splits is not None:
        return splits
    return min(_paged_splits(q, k_pool, page_table, None), page_table.shape[1])


_SMEM_MAX = 232448  # dynamic shared memory one block may take on the H100


def page_cell_bytes(tiles: int, ts: int, ps: int, hd: int, G: int) -> int:
    """Shared memory of one block of the page-block cell with a ring of
    ``tiles`` tiles of ``ts`` rows (csrc/decode_split_page.cuh
    PageSmem::bytes): the ring, the queries in f32 and bf16, the page's
    scores and exps, its scale rows in as many slots as the ring reaches
    ahead, the warp maxima and the state."""
    pitch = -(-hd // 16) * 16
    npt = ps // ts
    slots = (npt + tiles - 1 + 2 * npt - 1) // (2 * npt)
    return tiles * ts * pitch + 4 * (2 * G * pitch + 2 * G * ps + 2 * slots * ps + 10 * 8 + 4)


def paged_flash_decode_attention_dma_plain(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                                           new_k, new_v, new_ks, new_vs, layer=0, splits=None):
    """Plain version of K13: K9's plain version over the pages, key blocks
    of min(256, ps) rows, in ``splits`` spans of the MP * ps rows (None:
    ``decode_splits``)."""
    qs, acc, m, l = _paged_online(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, layer,
                                  _paged_block(k_pool.shape[3]),
                                  _paged_splits(q, k_pool, page_table, splits))
    return _fresh_tail_merge(acc, m, l, qs, new_k, new_v, new_ks, new_vs)


def paged_flash_decode_attention_fresh_plain(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                             pos, new_k, new_v, new_ks, new_vs, layer=0,
                                             splits=None):
    """Plain version of K20: the online softmax with whole pages as key
    blocks (JAX's sequential page walk at one split) in ``splits`` runs of
    pages (None: ``page_splits``), then the fresh column merged in the TPU
    kernel's order (attention.py:104-120): e_new scaled by nvs before the
    product with nv."""
    qs, acc, m, l = _paged_online(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, layer,
                                  k_pool.shape[3], page_splits(q, k_pool, page_table, splits))
    s_new = (qs * new_k.float()[:, :, None, :]).sum(-1) * new_ks[:, :, None]
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    e_new = torch.exp(s_new - m_fin)
    l_fin = l * corr + e_new
    e_new = e_new * new_vs[:, :, None]
    return ((acc * corr[..., None] + e_new[..., None] * new_v.float()[:, :, None, :])
            / torch.clamp_min(l_fin, 1e-30)[..., None])


def _launch_paged_decode(kernel, args, layer: int, ts: int, splits: int):
    """Launch K13 or K20 (``args`` = q, the pools, page_table, pos and the
    step's new_k, new_v, new_ks, new_vs) or K22 (without the fresh rows) on
    CUDA tensors: key blocks (K13) or ring tiles (K20, K22) of ``ts`` rows,
    in ``splits`` spans, the split workspace and tickets after."""
    q, k_pool, v_pool, k_scale, v_scale, page_table, pos = args[:7]
    B, KVH, G, hd = q.shape
    L, P, _, ps, _ = k_pool.shape
    MP = page_table.shape[1]
    if G > 8 or hd > 128:
        raise NotImplementedError(f"{kernel} takes up to 8 query heads per kv head and "
                                  f"head_dim <= 128, got G={G}, hd={hd}")
    if kernel != "K13" and page_cell_bytes(2, ts, ps, hd, G) > _SMEM_MAX:
        raise NotImplementedError(f"{kernel} keeps a page's {G} x {ps} scores and exps in "
                                  f"shared memory: too many at G={G}, ps={ps}, hd={hd}")
    ch = launch_chunk(kernel, k_pool, v_pool, hd, k_scale, v_scale)
    qc = q.contiguous()
    fresh = [t.contiguous() for t in args[7:]]
    p32 = pos.to(torch.int32).contiguous()
    pt = page_table.contiguous()
    out = torch.empty((B, KVH, G, hd), dtype=torch.float32, device=q.device)
    sqrt_hd = float(sqrt_f32(hd))  # jnp.sqrt(f32(hd))
    st = _kernels.stream(qc)
    ws = split_workspace(B, KVH, G, hd, splits, q.device, st)
    _kernels.launch(kernel, qc.data_ptr(), _kernels.dtype_code(qc.dtype), k_pool.data_ptr(),
                    v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), pt.data_ptr(),
                    p32.data_ptr(), *(t.data_ptr() for t in fresh), out.data_ptr(), layer, B,
                    KVH, G, P, ps, MP, hd, ts, splits, sqrt_hd, ch, *(_ptr(t) for t in ws), st)
    return out


def paged_flash_decode_attention_dma(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k,
                                     new_v, new_ks, new_vs, layer=None,
                                     splits: int | None = None) -> torch.Tensor:
    """Deferred-flush decode attention over a page pool that reads only the
    pages below each slot's pos (K13; the JAX function's argument order).
    q [B, KVH, G, hd] raw queries (f32 or bf16); pools and page_table as
    ``PagedKVCache``; pos [B]; the step's fresh rows new_k/new_v int8
    [B, KVH, hd] with scales [B, KVH]; ``layer`` a host int.  Cache row s
    attends iff s < pos[b]; the fresh row is one more column.  K9's
    arithmetic over key blocks of min(256, ps) rows, in ``splits`` spans of
    the MP * ps rows (None: ``decode_splits``, K9's rule; K13 equals K9 on a
    paged copy at equal blocks and splits).  Returns f32 [B, KVH, G, hd].
    K13 on CUDA tensors, the plain version on CPU ones."""
    args = (q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v, new_ks, new_vs)
    layer = _check_paged_decode("paged_flash_decode_attention_dma", *args, layer)
    splits = _check_splits("paged_flash_decode_attention_dma", splits)
    if _kernels.on_cpu("K13", *args):
        return paged_flash_decode_attention_dma_plain(*args, layer=layer, splits=splits)
    return _launch_paged_decode("K13", args, layer, _paged_block(k_pool.shape[3]),
                                _paged_splits(q, k_pool, page_table, splits))


def paged_flash_decode_attention_fresh(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                                       new_k, new_v, new_ks, new_vs, layer=None,
                                       splits: int | None = None) -> torch.Tensor:
    """The contract of :func:`paged_flash_decode_attention_dma` (K20), with
    the TPU kernel's whole-page key blocks: an online softmax over the
    slot's pages below pos, in ``splits`` runs of whole pages merged after
    (None: ``page_splits``; at more than one, within 2^-8 of max |out| of
    the sequential page walk), the fresh column merged last.  Returns f32
    [B, KVH, G, hd].  K20 on CUDA tensors (a page's G x ps scores and exps
    in shared memory, so G x ps is bounded), the plain version on CPU
    ones."""
    args = (q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v, new_ks, new_vs)
    layer = _check_paged_decode("paged_flash_decode_attention_fresh", *args, layer)
    splits = _check_splits("paged_flash_decode_attention_fresh", splits)
    if _kernels.on_cpu("K20", *args):
        return paged_flash_decode_attention_fresh_plain(*args, layer=layer, splits=splits)
    return _launch_paged_decode("K20", args, layer, _paged_block(k_pool.shape[3]),
                                page_splits(q, k_pool, page_table, splits))


def paged_flash_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                                       layer=0, splits=None):
    """Plain version of K22: the online softmax with whole pages as key
    blocks (``decode_online_softmax`` at ts = ps: JAX's sequential page walk
    at one split) in ``splits`` runs of pages (None: ``page_splits``), rows
    t <= pos (pos clamped to [-1, MP * ps - 1], as the kernel), then acc /
    max(l, 1e-30)."""
    MP, ps = page_table.shape[1], k_pool.shape[3]
    bound = pos.long().clamp(-1, MP * ps - 1) + 1  # rows t < pos + 1
    _, acc, _, l = _paged_online(q, k_pool, v_pool, k_scale, v_scale, page_table, bound, layer,
                                 ps, page_splits(q, k_pool, page_table, splits))
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def paged_flash_decode_attention(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                                 layer=None, splits: int | None = None) -> torch.Tensor:
    """Write-then-attend decode attention over a page pool (K22; the JAX
    function's argument order): each slot's query attends its rows
    t <= pos[b] through the page table, the step's row already written.
    q [B, KVH, G, hd] raw queries (f32 or bf16); pools and page_table as
    ``PagedKVCache``; pos [B]; ``layer`` a host int.  The TPU kernel's
    arithmetic with whole pages as key blocks, in ``splits`` runs of pages
    merged after (None: ``page_splits``; at more than one, within 2^-8 of
    max |out| of the sequential page walk).  Returns f32 [B, KVH, G, hd].
    No path of the port calls it, as none of the JAX package does.  K22 on
    CUDA tensors (a page's G x ps scores and exps in shared memory), the
    plain version on CPU ones."""
    args = (q, k_pool, v_pool, k_scale, v_scale, page_table, pos)
    layer = _check_paged_q("paged_flash_decode_attention", *args, layer)
    splits = _check_splits("paged_flash_decode_attention", splits)
    if _kernels.on_cpu("K22", *args):
        return paged_flash_decode_attention_plain(*args, layer=layer, splits=splits)
    return _launch_paged_decode("K22", args, layer, _paged_block(k_pool.shape[3]),
                                page_splits(q, k_pool, page_table, splits))


# ---------------------------------------------------------------------------
# Pool-direct chunked prefill (forward_prefill_paged_chunked): per chunk and
# layer K16 attends the chunk's queries to the slots' past pool pages plus
# the chunk's fresh rows, and K17 writes the fresh rows into their pages in
# place (attention.py:1990, :2189).  No compact block, no dense gather.
# ---------------------------------------------------------------------------


def _check_chunk_rows(name, rows_k, rows_v, rows_ks, rows_vs, B: int, KVH: int, hd: int):
    """Validate a chunk's fresh rows [B, KVH, Tc, hd] int8 with f32 scales
    [B, KVH, Tc]; returns Tc."""
    if rows_k.dim() != 4:
        raise ValueError(f"{name}: want chunk rows [B, KVH, Tc, hd]")
    Tc = rows_k.shape[2]
    if (rows_k.shape != (B, KVH, Tc, hd) or rows_v.shape != rows_k.shape
            or rows_ks.shape != (B, KVH, Tc) or rows_vs.shape != rows_ks.shape):
        raise ValueError(f"{name}: chunk rows {tuple(rows_k.shape)}, scales "
                         f"{tuple(rows_ks.shape)}: want [{B}, {KVH}, Tc, {hd}] and "
                         f"[{B}, {KVH}, Tc]")
    if any(t.dtype != torch.int8 for t in (rows_k, rows_v)) or any(
            t.dtype != torch.float32 for t in (rows_ks, rows_vs)):
        raise TypeError(f"{name}: the chunk rows are int8 with float32 scales")
    return Tc


def kv_pool_write_chunk_plain(rows_k, rows_v, rows_ks, rows_vs, page_table, start, layer: int,
                              ck, cv, cks, cvs):
    """Plain version of K17: one sliced copy per slot and array, in place;
    ``start`` host ints.  A start whose page column lies past the table goes
    to page 0; a negative start, or a page id outside [0, P), writes
    nothing."""
    Tc = rows_k.shape[2]
    P, ps = ck.shape[1], ck.shape[3]
    MP = page_table.shape[1]
    for b, st in enumerate(start):
        if st < 0:
            continue
        col = st // ps
        page = int(page_table[b, col]) if col < MP else 0
        if not 0 <= page < P:
            continue
        off = st % ps
        for dst, src in ((ck, rows_k), (cv, rows_v), (cks, rows_ks), (cvs, rows_vs)):
            dst[layer, page, :, off:off + Tc] = src[b]
    return ck, cv, cks, cvs


def kv_pool_write_chunk(rows_k, rows_v, rows_ks, rows_vs, page_table, start, layer, ck, cv, cks,
                        cvs):
    """Write one layer's prefill chunk IN PLACE into each slot's page (K17;
    the JAX function's argument order): slot b's rows land in page
    ``page_table[b, start[b] // ps]``, rows [start % ps, start % ps + Tc),
    for K, V and both scale arrays.  rows_k/rows_v int8 [B, KVH, Tc, hd],
    rows_ks/rows_vs f32 [B, KVH, Tc]; page_table int32 [B, MP], the chunk's
    slots' rows, on the pool's device; ``start`` [B] host ints, a CPU
    tensor, or a tensor on the pool's device (not read back: K16 takes the
    same one); ``layer`` a host int; pools as ``PagedKVCache``.  Raises
    ValueError unless ps % Tc == 0 and every host start % Tc == 0 (a chunk
    never crosses a page), the contract the JAX kernel assumes; a device
    start's alignment is its caller's to check on the host
    (``forward_prefill_paged_chunked`` checks start0 once a wave), and the
    kernel writes nothing for a chunk that would cross its page.  A start
    whose page column lies past the table writes to the trash page 0, as in
    JAX; a parked slot's (table row 0) too; a negative start, or a page id
    outside [0, P), writes nothing.  Returns the (updated) pools.  K17 on
    CUDA tensors, the plain version on CPU ones."""
    L, P, KVH, ps, hd, B, MP = _check_pool("kv_pool_write_chunk", ck, cv, cks, cvs, page_table)
    Tc = _check_chunk_rows("kv_pool_write_chunk", rows_k, rows_v, rows_ks, rows_vs, B, KVH, hd)
    on_card = isinstance(start, torch.Tensor) and start.device.type != "cpu"
    st = None if on_card else [int(s) for s in (
        start.tolist() if isinstance(start, torch.Tensor) else start)]
    layer = int(layer)
    n = start.shape[0] if on_card else len(st)
    if n != B or (on_card and start.dim() != 1):
        raise ValueError(f"kv_pool_write_chunk: {n} starts for {B} slots")
    if ps % Tc or (st is not None and any(s % Tc for s in st)):
        raise ValueError(f"kv_pool_write_chunk: chunks of {Tc} rows must tile the {ps}-row "
                         f"pages: ps % Tc and every start % Tc must be 0, starts {st}")
    if not 0 <= layer < L:
        raise ValueError(f"kv_pool_write_chunk: layer {layer} outside [0, {L})")
    arrays = (rows_k, rows_v, rows_ks, rows_vs, page_table, ck, cv, cks, cvs)
    if _kernels.on_cpu("K17", *arrays):
        return kv_pool_write_chunk_plain(rows_k, rows_v, rows_ks, rows_vs, page_table,
                                         start.tolist() if on_card else st, layer,
                                         ck, cv, cks, cvs)
    _pool_in_place("K17", ck, cv, cks, cvs)
    rk, rv, rks, rvs = (t.contiguous() for t in (rows_k, rows_v, rows_ks, rows_vs))
    s32 = (start.to(device=ck.device, dtype=torch.int32).contiguous() if on_card
           else upload(st, ck.device, torch.int32))
    pt = page_table.contiguous()
    vec = _vec16(hd, rk, rv, ck, cv)
    _kernels.launch("K17", rk.data_ptr(), rv.data_ptr(), rks.data_ptr(), rvs.data_ptr(),
                    s32.data_ptr(), pt.data_ptr(), ck.data_ptr(), cv.data_ptr(), cks.data_ptr(),
                    cvs.data_ptr(), B, KVH, Tc, hd, P, ps, MP, layer, int(vec),
                    _kernels.stream(ck))
    return ck, cv, cks, cvs


def paged_flash_prefill_attention_plain(q, k_pool, v_pool, k_scale, v_scale, page_table, start,
                                        fresh_k, fresh_v, fresh_ks, fresh_vs, layer=0,
                                        past_pages=None, out_dtype=None):
    """Plain version of K16: K6's INT8 function (``_prefill_plain``) over a
    dense copy of the slot's keys, as the kernel indexes them -- the past
    keys s < e = min(max(start, 0), past_pages * ps) read through the first
    past_pages pages (``paged_view``: a page id outside [0, P) reads page
    0), then the fresh rows at [e, e + Tc), key s attending query t iff
    s <= e + t -- with the output rounded to bf16 (the JAX kernel emits
    bf16), then cast to ``out_dtype``."""
    B, Tc = q.shape[:2]
    KVH, ps, hd = k_pool.shape[2], k_pool.shape[3], k_pool.shape[4]
    W = page_table.shape[1] if past_pages is None else past_pages
    pt = page_table[:, :W]
    past = [paged_view(a, pt, layer)[0] for a in (k_pool, v_pool, k_scale, v_scale)]
    both = [torch.cat([p, f], dim=2)  # [B, KVH, W * ps + Tc(, hd)]
            for p, f in zip(past, (fresh_k, fresh_v, fresh_ks, fresh_vs))]
    dev = q.device
    Sd = W * ps + Tc
    e = start.to(dev).long().clamp(min=0, max=W * ps)[:, None]  # [B, 1]
    s = torch.arange(Sd, device=dev)[None, :]
    src = torch.where(s < e, s, torch.where(s < e + Tc, W * ps + s - e, 0))  # [B, Sd]
    k, v = (a.gather(2, src[:, None, :, None].expand(B, KVH, Sd, hd)) for a in both[:2])
    ks, vs = (a.gather(2, src[:, None, :].expand(B, KVH, Sd)) for a in both[2:])
    mask = s[:, None, :] <= e[:, :, None] + torch.arange(Tc, device=dev)[None, :, None]
    return _prefill_plain(q, k, v, ks, vs, mask, out_dtype, round_out=True)


def paged_flash_prefill_attention(q, k_pool, v_pool, k_scale, v_scale, page_table, start,
                                  fresh_k, fresh_v, fresh_ks, fresh_vs, layer=None,
                                  past_pages=None, out_dtype=None) -> torch.Tensor:
    """Chunked prefill attention straight against the page pool (K16; the
    JAX function's argument order): the chunk's queries q [B, Tc, NH, hd]
    (raw, roped; f32 or bf16) attend the slot's past keys s < start[b] of
    layer ``layer`` (a host int), read through page_table int32 [B, MP]
    (the chunk's slots' rows) in the first ``past_pages`` pages (default
    MP; JAX's static bound: every start <= past_pages * ps), plus the
    chunk's fresh rows fresh_k/fresh_v int8 [B, KVH, Tc, hd] with scales
    [B, KVH, Tc] at positions start + t', causally (t' <= t).  start [B]
    int32 on the pool's device.  A page id outside [0, P) reads the trash
    page 0.  Returns [B, Tc, NH * hd] rounded to bf16, in ``out_dtype``
    (default f32).  K6's INT8 arithmetic, the JAX kernel's: q and p * vs
    rounded to bf16 before the dots.  K16 on CUDA tensors, the plain
    version on CPU ones."""
    L, P, KVH, ps, hd, B, MP = _check_pool("paged_flash_prefill_attention", k_pool, v_pool,
                                           k_scale, v_scale, page_table)
    if q.dim() != 4 or q.shape[0] != B or q.shape[3] != hd or q.shape[2] % KVH:
        raise ValueError(f"paged_flash_prefill_attention: q {tuple(q.shape)}: want "
                         f"[{B}, Tc, NH, {hd}] with NH a multiple of {KVH}")
    Tc = _check_chunk_rows("paged_flash_prefill_attention", fresh_k, fresh_v, fresh_ks, fresh_vs,
                           B, KVH, hd)
    if q.shape[1] != Tc or start.shape != (B,):
        raise ValueError(f"paged_flash_prefill_attention: q {tuple(q.shape)}, start "
                         f"{tuple(start.shape)}, chunk rows {tuple(fresh_k.shape)}")
    W = MP if past_pages is None else int(past_pages)
    if not 0 <= W <= MP:
        raise ValueError(f"paged_flash_prefill_attention: past_pages {W} outside [0, {MP}]")
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"paged_flash_prefill_attention: layer {layer} outside [0, {L})")
    arrays = (q, k_pool, v_pool, k_scale, v_scale, page_table, start, fresh_k, fresh_v, fresh_ks,
              fresh_vs)
    if _kernels.on_cpu("K16", *arrays):
        return paged_flash_prefill_attention_plain(*arrays, layer=layer, past_pages=W,
                                                   out_dtype=out_dtype)
    NH = q.shape[2]
    if hd > 128:
        raise NotImplementedError(f"K16 takes head_dim <= 128, got {hd}")
    if not all(t.is_contiguous() for t in (k_pool, v_pool, k_scale, v_scale)):
        raise ValueError("K16 reads the pool where it lies: it must be contiguous")
    out_dtype = out_dtype or torch.float32
    qc = q.contiguous()
    fk, fv, fks, fvs = (t.contiguous() for t in (fresh_k, fresh_v, fresh_ks, fresh_vs))
    st = start.to(torch.int32).contiguous()
    pt = page_table.contiguous()
    out = torch.empty((B, Tc, NH * hd), dtype=out_dtype, device=q.device)
    sqrt_hd = float(sqrt_f32(hd))  # jnp.sqrt(f32(hd))
    _kernels.launch("K16", qc.data_ptr(), _kernels.dtype_code(qc.dtype), k_pool.data_ptr(),
                    v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), pt.data_ptr(),
                    st.data_ptr(), fk.data_ptr(), fv.data_ptr(), fks.data_ptr(), fvs.data_ptr(),
                    out.data_ptr(), _kernels.dtype_code(out_dtype), layer, B, Tc, NH, KVH, P, ps,
                    MP, W, hd, sqrt_hd, _kernels.stream(qc))
    return out
