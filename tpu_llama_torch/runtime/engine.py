"""Inference engine over a slot-based dense KV cache.

Port of tpu_llama/runtime/engine.py for the dense layouts: a float32 cache
(the default, as in JAX), a bfloat16 one or an INT8 one (``kv_dtype``),
over dense, Q8_0 or W8A8 weights:

* the cache has ``max_batch`` slots; requests hold slots independently, each
  at its own position;
* admission runs a compact batched prefill of the new prompts only (prompt
  length bucketed to a power of two) into a T-row block, then the K7 slot
  scatter writes that block into the chosen slots in place, on every cache
  and at every bucket; above 8192 prompt rows the block is prefilled in chunks of 256 positions
  (``forward_prefill_chunked``, K18 landing each fused chunk of an INT8
  cache);
* prefix reuse: ``snapshot_slot`` / ``restore_slot`` copy a slot's prefix
  rows (and an INT8 cache's scales) to the host and back, and
  ``prefill_continue`` prefills a suffix at start_pos > 0 against the
  restored rows;
* decode runs the full slot batch in one step -- inactive slots compute
  values nobody reads (they decode at position 0; their row lands there and
  the next admission's K7 scatter overwrites it).  With the deferred-flush
  attention (``attn="flash_dma"`` K9, what ``"auto"`` picks on the card,
  or ``"flash"`` K19) no layer writes the cache during the step: one K10
  flush after the layer loop writes every layer's row.  ``"xla"`` (what
  ``"auto"`` picks on the CPU) writes each layer's row in place before its
  attention.  On fused W8A8 layouts the card decodes through the fused
  decode (``fused="auto"``: mega2, one K12 launch per layer; ``True`` the
  two-launch K11 path; ``False`` the unfused one; ``"mega3"``, one K26
  launch per pair of layers, and ``"mega"``, one K27 launch per layer, only
  when asked for), ``Engine.decode_fused`` shows the resolved mode;
* the prefill attention: ``prefill_attn="auto"`` (JAX's engine leaves
  ``forward_prefill``'s ``attn`` at "auto" too) is K6 on the card and
  JAX's CPU math, "xla" (``attention_prefill``), on the CPU; an explicit
  ``"flash"`` makes a CPU engine compute the card's function (K6's plain
  version), ``Engine.prefill_attn`` shows the resolved one.  Pool-direct
  waves run K16 either way, as in JAX;
* ``precision`` (JAX's default "default") reaches dense float32 products:
  TF32 on the card for "default" and "high", full f32 for "highest";
* device sampling: ``decode_sample``, ``sample_logits`` and the multi-step
  ``decode_sample_chunk[_async]`` sample on the logits' device with JAX's
  threefry keys (``ops/sampling.py``), so only token ids leave the card;
* ``prefill_with_all_logits`` returns one prompt's logits at every
  position (compat generation, perplexity); ``warmup`` runs every prompt
  bucket and the decode steps once (and on the card builds every kernel
  library) before a server takes traffic.

JAX's donated functional cache becomes one cache object updated in place,
every write on the current stream, so work queued after a decode chunk
(an admission's K7, a restore, a continuation's write-back) lands after the
chunk's own writes.  Host data reaches the card through pinned memory
without waiting (``device.upload``): a blocking upload would stall the host
behind a chunk in flight.

``kv_layout="paged"`` (engine.py:433-463) keeps an INT8 ``PagedKVCache``
whose pages a host ``PagePool`` hands out (the native C++ one where ``g++``
exists): every admission reserves the pages of its whole step budget
(``can_admit`` is the scheduler's backpressure probe), the compact block
lands in them through K15 -- or, for an admission group above the JAX
engine's pool-direct gate (more than 8192 rows, T and the page size
multiples of 256), waves of at most 16 slots are prefilled straight into
their pages (``prefill_into_slots_waved``: K16 and K17, no compact block)
-- decode runs K13 (or K20) and one K14 per step, and a prefix snapshot
pins its full pages by refcount and copies only its boundary page on the
device.  The page table's host mirror reaches the card through
``device.upload`` after every change, so a wave's K16 and K17 read the
table uploaded after its admission's reservations.

``Engine(params, config, mesh=mesh)`` (engine.py:432-467, the mesh without
``tp_fused``) is the sharded engine, JAX's GSPMD single program: ``params``
are this rank's ``parallel.shard_params_spmd`` shard (dense, Q8_0 or
unfused W8A8 above model = 1; any layout at model = 1), the cache its
[L, max_batch / dp, KVH / tp, S, hd] shard: slot s lies on the ranks of
data index s // (max_batch / dp).  Every method runs on the rank's shards
(``parallel.spmd``): a decode step takes the whole slot batch and decodes
the rank's rows; an admission, a continuation or an all-position prefill is
computed by the ranks that hold its slots, and its logits are all-gathered
over ``data`` to every rank; a prefix snapshot is broadcast from the slot's
data rank to the others, so that it restores into any slot.

``Engine(params, config, mesh=mesh, tp_fused=True)`` (engine.py:432-467,
518-531, 615-740) serves tensor-parallel through the explicit-TP kernels:
``params`` are this rank's shard (``parallel.shard_params`` of
``fuse_projections(tp=...)`` W8A8 weights), the cache is this rank's
kv-head shard, admissions run ``tp_prefill_into_slots`` (one power-of-two
bucket capped at seq_len, K6 and K7 on the local cache), a decode step
``tp_forward_decode_fused`` (K8, K9, K2, K23, K24 and K10, two all-reduces
per layer); the sampled decode steps are the stepwise ones above, keys
fold_in(base_key, pos); prefix reuse continues a suffix through
``tp_forward_prefill`` at start_pos > 0 over the slots' rows of the local
cache, and snapshots copy the local shard.  Paged KV and dp > 1 are
refused, as in JAX; so is paged KV on the sharded engine (no JAX test holds
it: ROADMAP queue 1 item 11).

JAX drives the mesh from one controller; the port runs SPMD: every rank
builds the same Engine and the same ``ContinuousBatcher`` and feeds them
the same requests.  Each rank's logits are all-gathered to [B, V], so
greedy picks, host sampling and the device sampler give every rank the same
tokens and the batchers stay in step; rank 0 alone emits.
``parallel.launch.MeshEngine`` drives such ranks from one process, with
this class's methods: that is the port's counterpart of JAX's single
controller.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.device import resolve_device, upload
from tpu_llama_torch.models.llama import (
    LlamaParams,
    PagedKVCache,
    QuantKVCache,
    _resolve_decode_attn,
    _resolve_prefill_attn,
    _resolve_fused,
    forward_decode,
    forward_prefill,
    PRECISIONS,
    forward_prefill_chunked,
    forward_prefill_paged_chunked,
    make_kv_cache,
)
from tpu_llama_torch.ops.attention import kv_cache_scatter_slots, kv_pool_scatter_pages
from tpu_llama_torch.ops.sampling import fold_in, keys_numpy, sample_nosort
from tpu_llama_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, all_gather, broadcast
from tpu_llama_torch.parallel.spmd import (
    spmd_forward_decode,
    spmd_prefill_chunked_rows,
    spmd_prefill_rows,
)
from tpu_llama_torch.parallel.tp import (
    _local_config,
    tp_forward_decode_fused,
    tp_forward_prefill,
    tp_prefill_into_slots,
)
from tpu_llama_torch.runtime.paged import PagePool

# Above this many prompt rows (Bp * T, T a multiple of _CHUNK) the compact
# block is prefilled in chunks (engine.py:132-138).
_CHUNKED_ROWS = 8192
_CHUNK = 256
# The JAX engine's pool-direct admission (engine.py:39-45): a paged group
# above _POOL_DIRECT_ROWS prompt rows is prefilled straight into the pool in
# host-dispatched waves of at most _WAVE_ROWS chunk rows (slots x
# _POOL_CHUNK), _POOL_CHUNK positions at a time.
_POOL_DIRECT_ROWS = 8192
_POOL_CHUNK = 256
_WAVE_ROWS = 4096


def _pool_direct_ok(cache, Bp: int, T: int) -> bool:
    """The JAX engine's pool-direct gate (engine.py:48-52): a paged
    admission group above _POOL_DIRECT_ROWS rows, with T and the page size
    multiples of _POOL_CHUNK.  Admissions take last-token logits only, so
    JAX's ``logits_mode == "last"`` term always holds here."""
    return (isinstance(cache, PagedKVCache) and Bp * T > _POOL_DIRECT_ROWS
            and T % _POOL_CHUNK == 0 and cache.page_size % _POOL_CHUNK == 0)


def prefill_into_slots_waved(params: LlamaParams, cache, tokens: torch.Tensor,
                             lengths: torch.Tensor, slots: Sequence[int], config: ModelConfig,
                             precision: str = "default", attn: str = "auto"):
    """The admission front door (engine.py:55-93): a group that passes
    ``_pool_direct_ok`` is prefilled straight into the page pool
    (``forward_prefill_paged_chunked``, K16 and K17: no compact duplicate,
    which at 7B is 8.6 GB for 32 x 1024 prompts) in waves of
    bw = max(1, min(Bp, _WAVE_ROWS // _POOL_CHUNK)) slots, so the activation
    working set follows the wave, not the group; the last wave may be
    smaller.  Every other group takes ``_prefill_into_slots``' compact path,
    whose prefill attention is ``attn`` (``forward_prefill``'s; the
    pool-direct path always runs K16, as JAX's does).  Returns (next-token
    logits [Bp, V], cache), the cache updated in place."""
    Bp, T = tokens.shape
    if not _pool_direct_ok(cache, Bp, T):
        return _prefill_into_slots(params, cache, tokens, lengths, slots, config, precision,
                                   attn)
    bw = max(1, min(Bp, _WAVE_ROWS // _POOL_CHUNK))
    outs = []
    for w in range(0, Bp, bw):
        # every wave pool-direct: a wave is under the rows gate, but the
        # compact block is what this path exists to avoid
        last, cache = forward_prefill_paged_chunked(
            params, cache, tokens[w:w + bw], lengths[w:w + bw], slots[w:w + bw], config,
            precision=precision, chunk=_POOL_CHUNK)
        outs.append(last)
    return torch.cat(outs, dim=0), cache


def _make_page_pool(num_pages: int, page_size: int, slots: int, max_pages_per_slot: int):
    """The native C++ allocator (``native/pagepool.cpp`` through
    ``runtime.native_pool``, the same semantics), or the Python ``PagePool``
    where no compiler exists or ``TPU_LLAMA_TORCH_NO_NATIVE`` is set
    (engine.py:394-410)."""
    import os

    if not os.environ.get("TPU_LLAMA_TORCH_NO_NATIVE"):
        try:
            from tpu_llama_torch.runtime.native_pool import NativePagePool

            return NativePagePool(num_pages, page_size, slots, max_pages_per_slot)
        except ImportError:
            pass
    return PagePool(num_pages, page_size, slots, max_pages_per_slot)


def _prefill_into_slots(params: LlamaParams, cache, tokens: torch.Tensor, lengths: torch.Tensor,
                        slots: Sequence[int], config: ModelConfig, precision: str = "default",
                        attn: str = "auto", logits_mode: str = "last", mesh=None):
    """Compact prefill + scatter into the slot cache (engine.py:96).  Returns
    (logits, cache) with the cache updated in place: the next-token logits
    [Bp, V] for ``logits_mode="last"``, every position's [Bp, T, V] for
    "all", which (as in JAX) takes ``forward_prefill``'s start-position
    path, not the fresh one, and never the chunked one.  The
    scatter is K7 (its fp form on an fp cache) for every bucket: the TPU's
    ``T % 128`` gate and the indexed copy JAX's engine takes below it
    (engine.py:204-214) were a Mosaic alignment rule that the CUDA kernel
    does not have.  On a paged cache K15 lands the block in the slots' pages
    instead (engine.py:148-161); ``prefill_into_slots_waved`` takes the
    groups that skip the block.  ``slots`` stays on the host: the wrappers check it there and upload
    it.  With a ``mesh`` (the sharded engine) the rows are this rank's, the
    block holds its kv heads and the prefill is ``parallel.spmd``'s, its
    logits gathered over ``model``."""
    Bp, T = tokens.shape
    tp = 1 if mesh is None else mesh.size(MODEL_AXIS)
    small = make_kv_cache(_local_config(config, tp), Bp, kv_dtype=cache.k.dtype, seq_len=T,
                          device=tokens.device)
    fresh = logits_mode == "last"
    start = torch.zeros(Bp, dtype=torch.long)
    if fresh and T % _CHUNK == 0 and Bp * T > _CHUNKED_ROWS:
        if mesh is None:
            last, small = forward_prefill_chunked(params, small, tokens, lengths, config,
                                                  chunk=_CHUNK, precision=precision, attn=attn)
        else:
            last, small = spmd_prefill_chunked_rows(params, small, tokens, lengths, config, mesh,
                                                    chunk=_CHUNK, precision=precision, attn=attn)
    elif mesh is None:
        last, small = forward_prefill(
            params, small, tokens, start_pos=start, lengths=lengths, config=config,
            logits_mode=logits_mode, assume_fresh=fresh, precision=precision, attn=attn)
    else:
        last, small = spmd_prefill_rows(params, small, tokens, start, lengths, config, mesh,
                                        logits_mode, assume_fresh=fresh, precision=precision,
                                        attn=attn)
    if isinstance(cache, PagedKVCache):
        kv_pool_scatter_pages(small.k, small.v, small.ks, small.vs, slots, cache.page_table,
                              cache.k, cache.v, cache.ks, cache.vs)
    else:
        kv_cache_scatter_slots(small.k, small.v, slots, cache.k, cache.v, small.ks, small.vs,
                               cache.ks, cache.vs)
    return last, cache


def _prefill_continue_paged(params: LlamaParams, cache: PagedKVCache, tokens, starts, lengths,
                            slots, config: ModelConfig, precision: str, mp_cap: int,
                            attn: str = "auto"):
    """Suffix prefill against paged slots (engine.py:226-293): each slot's
    first ``mp_cap`` pages gathered into a dense INT8 view (the caller
    promises start + T <= mp_cap * ps for every row that matters), the
    start > 0 prefill there, then the rows at positions [start, start + T)
    written back into their pages.  Shared prefix pages are read, never
    written: suffix positions lie in the slot's private boundary and fresh
    pages, or past its reservation on the trash page.  ``starts`` on the
    host.  Plain PyTorch, as the JAX function is plain XLA.  Returns the
    next-token logits [n, V]."""
    n, T = tokens.shape
    L, _, KVH, ps, hd = cache.k.shape
    S = mp_cap * ps
    idx = upload(slots, cache.k.device, torch.long)
    pt = cache.page_table.index_select(0, idx)[:, :mp_cap].long()  # [n, mp_cap]

    def gather(pool):  # [L, n, mp_cap, KVH, ps(, hd)] -> [L, n, KVH, S(, hd)]
        sub = pool[:, pt].transpose(2, 3)
        return sub.reshape(L, n, KVH, S, *pool.shape[4:])

    sub = QuantKVCache(**{a: gather(getattr(cache, a)) for a in cache.arrays})
    logits, sub = forward_prefill(params, sub, tokens, starts, lengths, config,
                                  logits_mode="last", precision=precision, attn=attn)
    # positions [start, start + T) back into the pages; a position past the
    # view writes back the view's last row (what it holds), as JAX clamps
    t_abs = (upload(starts, cache.k.device, torch.long)[:, None]
             + torch.arange(T, device=cache.k.device)[None, :]).clamp(max=S - 1)  # [n, T]
    p_ix = pt.gather(1, t_abs // ps)[:, None, :]  # [n, 1, T]
    h_ix = torch.arange(KVH, device=cache.k.device)[None, :, None]
    r_ix = (t_abs % ps)[:, None, :]
    for a in cache.arrays:
        rows = getattr(sub, a)  # [L, n, KVH, S(, hd)]
        ix = t_abs[None, :, None, :]
        if rows.dim() == 5:
            ix = ix[..., None].expand(L, n, KVH, T, hd)
        else:
            ix = ix.expand(L, n, KVH, T)
        getattr(cache, a)[:, p_ix, h_ix, r_ix] = rows.gather(3, ix)
    return logits


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class Engine:
    """Owns params + slot cache; batched prefill/decode with numpy in and
    out at the host boundary."""

    def __init__(self, params: LlamaParams, config: ModelConfig, max_batch: int = 8,
                 kv_dtype=torch.float32, precision: str = "default", seq_len: int | None = None,
                 kv_layout: str = "dense", page_size: int = 512, num_pages: int | None = None,
                 attn: str = "auto", fused="auto", device=None, mesh=None,
                 tp_fused: bool = False, prefill_attn: str = "auto"):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout {kv_layout!r}: want 'dense' or 'paged'")
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: want one of {PRECISIONS}")
        self.spmd = mesh is not None and not tp_fused
        if self.spmd and kv_layout == "paged":
            raise NotImplementedError("a paged cache under a mesh (no JAX test holds it): "
                                      "ROADMAP queue 1 item 11")
        if tp_fused:
            if mesh is None:
                raise ValueError("tp_fused requires a mesh")
            if kv_layout == "paged":
                raise ValueError("tp_fused + paged KV not supported yet")
            if mesh.size(DATA_AXIS) != 1:
                raise ValueError("tp_fused admits through tp_prefill_into_slots, dp=1-only")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if params.tok_emb.device.type != self.device.type:
            raise ValueError(f"params live on {params.tok_emb.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.config = config
        self.precision = precision
        self.max_batch = max_batch
        self.seq_len = seq_len or config.seq_len
        self.mesh = mesh
        self.tp_fused = tp_fused
        self.pool = None
        if tp_fused:  # this rank's shard of the cache (engine.py:464-467)
            self.cache = make_kv_cache(_local_config(config, mesh.size(MODEL_AXIS)), max_batch,
                                       kv_dtype=kv_dtype, seq_len=self.seq_len,
                                       device=self.device)
            self.decode_attn, self.decode_fused = "flash", "tp"
            self.prefill_attn = _resolve_prefill_attn(prefill_attn, self.cache)
            return
        if self.spmd:  # this rank's shard of the cache: its slots and kv heads
            dp, tp = mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS)
            if max_batch % dp:
                raise ValueError(f"{max_batch} slots do not split over dp={dp}")
            self.slots_per_rank = max_batch // dp
            self.cache = make_kv_cache(_local_config(config, tp), self.slots_per_rank,
                                       kv_dtype=kv_dtype, seq_len=self.seq_len,
                                       device=self.device)
            self.decode_attn = _resolve_decode_attn(attn, self.cache)
            if tp > 1 and fused not in ("auto", False):
                raise ValueError(f"fused decode {fused!r} above model = 1: the sharded engine "
                                 "decodes through the unfused stack")
            # the whole batch's choice, as the single device makes it: a
            # rank's share of the slots would take mega2 where it does not
            self.decode_fused = False if tp > 1 else _resolve_fused(
                fused, self.decode_attn, params, config, self.cache, max_batch)
            self.prefill_attn = _resolve_prefill_attn(prefill_attn, self.cache)
            return
        if kv_layout == "paged":  # INT8 whatever kv_dtype says, as in JAX (engine.py:452-458)
            mp = -(-self.seq_len // page_size)
            n_pages = num_pages or max_batch * mp + 1
            self.pool = _make_page_pool(n_pages, page_size, max_batch, mp)
            self.cache = make_kv_cache(config, max_batch, kv_dtype="int8", seq_len=self.seq_len,
                                       paged=True, num_pages=n_pages, page_size=page_size,
                                       device=self.device)
        else:
            self.cache = make_kv_cache(config, max_batch, kv_dtype=kv_dtype,
                                       seq_len=self.seq_len, device=self.device)
        # the decode attention and fused decode every step runs ("auto"
        # resolved on these weights and this cache, as JAX's _decode_step
        # calls forward_decode with fused="auto", engine.py:308-320)
        self.decode_attn = _resolve_decode_attn(attn, self.cache)
        self.decode_fused = _resolve_fused(fused, self.decode_attn, params, config, self.cache,
                                           max_batch)
        # the prefill attention of the admissions and continuations
        self.prefill_attn = _resolve_prefill_attn(prefill_attn, self.cache)

    def _sync_page_table(self) -> None:
        """Upload the host page-table mirror into a new device tensor,
        through pinned memory and in stream order (``device.upload``): work
        already queued (a decode chunk in flight) keeps reading the table it
        was given, and ``upload`` copies the mirror, which the native pool
        rewrites in place."""
        self.cache.page_table = upload(self.pool.table, self.device, torch.int32)

    def can_admit(self, n_tokens: int, claimed: Sequence[int] = ()) -> bool:
        """Backpressure probe: can a request needing ``n_tokens`` positions
        be admitted now, beside requests of ``claimed`` positions already
        taken into the same admission?  Always on a dense cache (a free slot
        has room).  (JAX's probe, engine.py:466-471, sees one request at a
        time: a batch whose requests fit the pool alone but not together
        then fails at its reservation.)"""
        if self.pool is None:
            return True
        pool = self.pool
        need = sum(pool.pages_needed(n) for n in (*claimed, n_tokens))
        return pool.can_reserve(n_tokens) and need <= pool.free_pages

    def release_slot(self, slot: int) -> None:
        """Return a retired slot's pages to the pool (nothing on a dense
        cache)."""
        if self.pool is not None:
            self.pool.release(slot)
            self._sync_page_table()

    def _ints(self, a) -> torch.Tensor:
        return upload(a, self.device, torch.long)

    # ---- the sharded engine's slots (data parallelism) ----
    def _owners(self, slots: Sequence[int]) -> list[int]:
        """The data index that holds each slot."""
        return [int(s) // self.slots_per_rank for s in slots]

    def _mine(self, slots: Sequence[int]) -> list[int]:
        """Which of ``slots`` (by position) this rank's data index holds."""
        d = self.mesh.data_index
        return [i for i, o in enumerate(self._owners(slots)) if o == d]

    def _merge(self, local, slots: Sequence[int], tail: tuple) -> torch.Tensor:
        """Rows that each data index computed for the slots it holds (in
        ``slots`` order; ``local`` None where it holds none) -> every slot's
        row in ``slots`` order, on every rank: padded to the most rows any
        data index holds and all-gathered over ``data``."""
        if self.mesh.size(DATA_AXIS) == 1:
            return local
        owners = self._owners(slots)
        m = max(owners.count(d) for d in set(owners))
        buf = torch.zeros((m, *tail), dtype=torch.float32, device=self.device)
        if local is not None:
            buf[:local.shape[0]] = local
        rows = all_gather(buf, self.mesh, DATA_AXIS, 0)
        return rows[[o * m + owners[:i].count(o) for i, o in enumerate(owners)]]

    def _floats(self, a) -> torch.Tensor:
        return upload(a, self.device, torch.float32)

    def _keys(self, keys) -> torch.Tensor:
        """Key data [n, 2] (``ops.sampling.key``s) on the device."""
        if isinstance(keys, torch.Tensor) and keys.device == self.device:
            return keys
        return self._ints(keys)

    def prefill(self, prompts: Sequence[Sequence[int]], slots: Sequence[int],
                reserve_tokens: Sequence[int] | None = None, return_device: bool = False):
        """Prefill fresh prompts into slots.  Returns next-token logits [n, V]
        (numpy, or the device tensor with ``return_device=True``).

        The admission batch splits into power-of-two groups, largest first,
        each bucketing its own T (engine.py:533-561): a short-prompt group
        does not pay a long-prompt group's rows.  ``reserve_tokens`` (paged
        caches): the positions each request may ever occupy (prompt and
        generation budget); that many pages are reserved up front, so decode
        never fails mid-flight (engine.py:475-517).  Every group goes
        through ``prefill_into_slots_waved``: a paged group above the
        pool-direct gate is prefilled straight into its pages in waves, any
        other compact."""
        if not prompts or len(prompts) != len(slots):
            raise ValueError("need one slot per prompt, and at least one prompt")
        lengths = np.array([len(p) for p in prompts], np.int64)
        if lengths.min() < 1:
            raise ValueError("prompts must be non-empty (include BOS)")
        if int(lengths.max()) > self.seq_len:
            raise ValueError("prompt exceeds cache")
        n = len(prompts)
        if self.pool is not None:
            reserve = list(reserve_tokens) if reserve_tokens is not None else lengths.tolist()
            for slot, p, r in zip(slots, prompts, reserve):
                self.pool.release(slot)  # reclaim any stale holding
                if self.pool.reserve(slot, max(int(r), len(p))) is None:
                    raise RuntimeError(
                        f"page pool exhausted (slot {slot}: need "
                        f"{self.pool.pages_needed(max(int(r), len(p)))} pages, "
                        f"{self.pool.free_pages} free): gate admissions with Engine.can_admit")
            self._sync_page_table()
        if self.spmd:  # the slots of this rank's data index, grouped as above
            mine = self._mine(slots)
            local = None
            if mine:
                local = self._prefill_groups([prompts[i] for i in mine],
                                             [int(slots[i]) % self.slots_per_rank for i in mine])
            last = self._merge(local, slots, (self.config.vocab_size,))
            return last if return_device else last.cpu().numpy()
        if self.tp_fused:  # one group, T capped at the cache length (engine.py:518-531)
            T = min(_bucket(int(lengths.max())), self.seq_len)
            toks = np.zeros((n, T), np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
            last, self.cache = tp_prefill_into_slots(
                self.params, self.cache, self._ints(toks), self._ints(lengths),
                [int(s) for s in slots], self.config, self.mesh, self.precision,
                self.prefill_attn)
            return last if return_device else last.cpu().numpy()
        last = self._prefill_groups(prompts, slots)
        return last if return_device else last.cpu().numpy()

    def _prefill_groups(self, prompts, slots) -> torch.Tensor:
        """``prefill``'s power-of-two groups, largest first, each bucketing
        its own T (engine.py:533-561), through ``prefill_into_slots_waved``
        (the sharded engine: ``_prefill_into_slots`` on the rank's shards,
        ``slots`` local).  Returns the next-token logits [n, V]."""
        lengths = np.array([len(p) for p in prompts], np.int64)
        outs, start, n = [], 0, len(prompts)
        while start < n:
            g = 1 << ((n - start).bit_length() - 1)  # largest pow2 <= rest
            T = min(_bucket(int(lengths[start:start + g].max())), self.seq_len)
            toks = np.zeros((g, T), np.int64)
            for i, p in enumerate(prompts[start:start + g]):
                toks[i, :len(p)] = p
            args = (self.params, self.cache, self._ints(toks),
                    self._ints(lengths[start:start + g]),
                    [int(s) for s in slots[start:start + g]], self.config, self.precision,
                    self.prefill_attn)
            if self.spmd:
                last, self.cache = _prefill_into_slots(*args, mesh=self.mesh)
            else:
                last, self.cache = prefill_into_slots_waved(*args)
            outs.append(last)
            start += g
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def prefill_with_all_logits(self, prompt: Sequence[int], slot: int) -> np.ndarray:
        """Prefill one prompt into ``slot`` and return the logits at EVERY
        prompt position [len(prompt), V] (engine.py:563-578), for
        teacher-forced compat generation and perplexity.  A paged engine
        releases the slot's pages and reserves the prompt's anew.  The
        prompt pads to a power-of-two bucket capped at seq_len.  The sharded
        engine prefills it on the ranks that hold ``slot`` and gathers the
        logits to every rank; the TP engine through ``tp_prefill_into_slots``
        with all-position logits."""
        n = len(prompt)
        if not 1 <= n <= self.seq_len:
            raise ValueError(f"prompt of {n} tokens: want 1 to {self.seq_len}")
        T = min(_bucket(n), self.seq_len)
        toks = np.zeros((1, T), np.int64)
        toks[0, :n] = prompt
        if self.tp_fused:
            logits, self.cache = tp_prefill_into_slots(
                self.params, self.cache, self._ints(toks), self._ints([n]), [int(slot)],
                self.config, self.mesh, self.precision, self.prefill_attn, logits_mode="all")
            return logits[0, :n].cpu().numpy()
        if self.spmd:
            local = None
            if self._mine([slot]):
                local, self.cache = _prefill_into_slots(
                    self.params, self.cache, self._ints(toks), self._ints([n]),
                    [int(slot) % self.slots_per_rank], self.config, self.precision,
                    self.prefill_attn, logits_mode="all", mesh=self.mesh)
            logits = self._merge(local, [slot], (T, self.config.vocab_size))
            return logits[0, :n].cpu().numpy()
        if self.pool is not None:
            self.pool.release(slot)
            if self.pool.reserve(slot, n) is None:
                raise RuntimeError("page pool exhausted")
            self._sync_page_table()
        logits, self.cache = _prefill_into_slots(
            self.params, self.cache, self._ints(toks), self._ints([n]), [int(slot)], self.config,
            self.precision, self.prefill_attn, logits_mode="all")
        return logits[0, :n].cpu().numpy()

    def prefill_continue(self, suffixes: Sequence[Sequence[int]], slots: Sequence[int],
                         starts: Sequence[int], return_device: bool = False):
        """Prefill prompt suffixes into slots whose caches already hold the
        prefix rows [0, starts[i]) (prefix-reuse admission, engine.py:
        581-613, dense branch).  The suffix queries attend to the restored
        rows, so the slots' whole caches are gathered, prefilled at
        start_pos = starts (``forward_prefill``, logits_mode "last") and
        written back (``_prefill_continue_slots``, engine.py:200-223): at 7B
        and S = 2048 that is ~0.55 GB copied each way per slot.  On a paged
        cache only the pages that can hold attended keys are gathered:
        ``mp_cap`` = ceil(bucket(max start + T) / ps) pages
        (``_prefill_continue_paged``, engine.py:591-604).  Suffixes pad to one
        power-of-two bucket.  The sharded engine continues each suffix on the
        ranks that hold its slot (``parallel.spmd``) and gathers the logits to
        every rank; the TP engine runs ``tp_forward_prefill`` at start_pos =
        starts over the slots' rows of its local cache.  Returns next-token
        logits [n, V]."""
        if not suffixes or not len(suffixes) == len(slots) == len(starts):
            raise ValueError("need one slot and one start per suffix, and at least one suffix")
        lengths = np.array([len(s) for s in suffixes], np.int64)
        if lengths.min() < 1:
            raise ValueError("suffixes must be non-empty")
        if int(np.max(np.asarray(starts) + lengths)) > self.seq_len:
            raise ValueError("prefix + suffix exceeds cache")
        T = min(_bucket(int(lengths.max())), self.seq_len)
        toks = np.zeros((len(suffixes), T), np.int64)
        for i, s in enumerate(suffixes):
            toks[i, :len(s)] = s
        host_starts = torch.as_tensor(np.asarray(starts, np.int64))
        if self.pool is not None:
            ps = self.cache.page_size
            mp_cap = min(-(-_bucket(int(max(starts)) + T) // ps), self.cache.page_table.shape[1])
            logits = _prefill_continue_paged(self.params, self.cache, self._ints(toks),
                                             host_starts, self._ints(lengths),
                                             [int(s) for s in slots], self.config,
                                             self.precision, mp_cap, self.prefill_attn)
            return logits if return_device else logits.cpu().numpy()
        if self.spmd:
            mine = self._mine(slots)
            local = None
            if mine:
                local = self._continue_slots(
                    toks[mine], host_starts[mine], lengths[mine],
                    [int(slots[i]) % self.slots_per_rank for i in mine])
            logits = self._merge(local, slots, (self.config.vocab_size,))
        else:
            logits = self._continue_slots(toks, host_starts, lengths, slots)
        return logits if return_device else logits.cpu().numpy()

    def _continue_slots(self, toks, host_starts, lengths, slots) -> torch.Tensor:
        """The dense continuation (``_prefill_continue_slots``, engine.py:
        200-223): the slots' whole caches gathered, prefilled at start_pos =
        starts, written back.  ``slots`` index the local cache."""
        idx = self._ints(slots)
        sub = type(self.cache)(**{n: getattr(self.cache, n).index_select(1, idx)
                                  for n in self.cache.arrays})
        if self.tp_fused:
            logits, sub = tp_forward_prefill(self.params, sub, self._ints(toks), host_starts,
                                             self._ints(lengths), self.config, self.mesh,
                                             self.precision, logits_mode="last",
                                             attn=self.prefill_attn)
        elif self.spmd:
            logits, sub = spmd_prefill_rows(self.params, sub, self._ints(toks), host_starts,
                                            self._ints(lengths), self.config, self.mesh,
                                            "last", precision=self.precision,
                                            attn=self.prefill_attn)
        else:
            logits, sub = forward_prefill(self.params, sub, self._ints(toks), host_starts,
                                          self._ints(lengths), self.config, logits_mode="last",
                                          precision=self.precision, attn=self.prefill_attn)
        for n in self.cache.arrays:
            getattr(self.cache, n).index_copy_(1, idx, getattr(sub, n))
        return logits

    def decode(self, tokens: np.ndarray, pos: np.ndarray, return_device: bool = False):
        """One decode step over ALL slots. tokens/pos: [max_batch].  Returns
        the logits [max_batch, V] (numpy, or the device tensor with
        ``return_device=True``)."""
        logits = self.decode_device(self._ints(tokens), self._ints(pos))
        return logits if return_device else logits.cpu().numpy()

    def decode_device(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Device-resident decode step (no host transfer) for tight loops.
        (JAX's ``_decode_step``, engine.py:310, only exists to jit and donate
        the cache; here the step calls ``forward_decode`` directly.)"""
        if self.tp_fused:
            logits, self.cache = tp_forward_decode_fused(self.params, self.cache, tokens, pos,
                                                         self.config, self.mesh)
            return logits
        if self.spmd:
            logits, self.cache = spmd_forward_decode(self.params, self.cache, tokens, pos,
                                                     self.config, self.mesh,
                                                     attn=self.decode_attn,
                                                     fused=self.decode_fused,
                                                     precision=self.precision)
            return logits
        logits, self.cache = forward_decode(self.params, self.cache, tokens, pos,
                                            self.config, attn=self.decode_attn,
                                            fused=self.decode_fused, precision=self.precision)
        return logits

    def decode_sample(self, tokens, pos, temps, topps, keys, topks=None) -> np.ndarray:
        """Decode + per-slot sampling on the device (engine.py:644-666):
        ``keys`` are the step's keys [max_batch, 2] (already folded with the
        position).  Only the [max_batch] token ids come back."""
        B = len(tokens)
        topks = np.zeros(B, np.int64) if topks is None else topks
        logits = self.decode_device(self._ints(tokens), self._ints(pos))
        return sample_nosort(logits, self._keys(keys), self._floats(temps), self._floats(topps),
                             self._ints(topks)).cpu().numpy()

    def sample_logits(self, logits, temps, topps, topks, base_keys, pos) -> np.ndarray:
        """One token per logits row, sampled on the device with keys
        fold_in(base_key, pos) (engine.py:668-690): the admission's token
        folds in the last prompt position, so it never meets a decode step's
        key.  Rows pad to a power-of-two count, as the JAX engine pads its
        jit shapes.  Returns [n] token ids."""
        rows = [torch.as_tensor(lg).to(self.device) for lg in logits]
        n = len(rows)
        pad = _bucket(n, minimum=1) - n

        def padded(a, fill):
            a = np.asarray(a)
            return np.concatenate([a, np.full(pad, fill, a.dtype)])

        keys = np.asarray(base_keys, np.int64)
        keys = np.concatenate([keys, np.repeat(keys[:1], pad, axis=0)])
        out = sample_nosort(torch.stack(rows + rows[:1] * pad).float(),
                            fold_in(self._ints(keys), self._ints(padded(pos, 0))),
                            self._floats(padded(temps, 0.0)), self._floats(padded(topps, 1.0)),
                            self._ints(padded(topks, 0)))
        return out[:n].cpu().numpy()

    def decode_sample_chunk_async(self, tokens, pos, temps, topps, base_keys, steps: int,
                                  topks=None) -> torch.Tensor:
        """``steps`` decode + sample steps, each sampled token fed back on the
        device, with keys fold_in(base_key, fed position) (engine.py:
        348-382), so a chunk samples as step-at-a-time sampling does.
        Returns the device tensor [max_batch, steps] with no host sync: the
        caller reads it after queueing more work (the overlapped
        admission).  Nothing in the loop waits for the card: the inputs go
        up through pinned memory, the sampler's bisection is a fixed loop."""
        B = len(tokens)
        topks = np.zeros(B, np.int64) if topks is None else topks
        toks, p = self._ints(tokens), self._ints(pos)
        temps, topps, topks = self._floats(temps), self._floats(topps), self._ints(topks)
        base = self._keys(base_keys)
        out = []
        for _ in range(steps):
            logits = self.decode_device(toks, p)
            toks = sample_nosort(logits, fold_in(base, p), temps, topps, topks)
            out.append(toks)
            p = p + 1
        return torch.stack(out, dim=1)

    def decode_sample_chunk(self, tokens, pos, temps, topps, base_keys, steps: int,
                            topks=None) -> np.ndarray:
        """``decode_sample_chunk_async``, read back: [max_batch, steps]."""
        return self.decode_sample_chunk_async(tokens, pos, temps, topps, base_keys, steps,
                                              topks).cpu().numpy()

    def warmup(self, max_bucket: int | None = None, sample: bool = True,
               chunk: int = 1) -> list[int]:
        """Run every prompt bucket's admission (16, 32, ... below
        ``max_bucket``, then ``max_bucket``; default and cap seq_len), a
        decode step, ``decode_sample`` and every power-of-two
        ``decode_sample_chunk`` up to ``chunk``, then ``reset`` (engine.py:
        739-769).  On the card every kernel library is built first (one
        ``nvcc`` per source, in parallel), so no request's time to first
        token carries a build.  Returns the bucket sizes."""
        if self.device.type == "cuda":
            from tpu_llama_torch.ops import _kernels

            _kernels.build()
        max_bucket = min(max_bucket or self.seq_len, self.seq_len)
        buckets, b = [], 16
        while b < max_bucket:
            buckets.append(b)
            b *= 2
        buckets.append(max_bucket)
        for T in buckets:
            self.prefill([[1] * T], [0], reserve_tokens=[T])
        B = self.max_batch
        zeros = np.zeros(B, np.int64)
        self.decode(zeros, zeros)
        if sample:
            keys = keys_numpy([0] * B)
            temps, topps = np.zeros(B, np.float32), np.ones(B, np.float32)
            self.decode_sample(zeros, zeros, temps, topps, keys)
            k = 2
            while k <= chunk:  # every power-of-two chunk the scheduler takes
                self.decode_sample_chunk(zeros, zeros, temps, topps, keys, k)
                k *= 2
        self.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return buckets

    def reset(self) -> None:
        """Zero the cache; a paged engine also gets a fresh pool (every page
        free, page table zero)."""
        self.cache.zero_()
        if self.pool is not None:
            self.pool = _make_page_pool(self.pool.num_pages, self.pool.page_size, self.max_batch,
                                        self.pool.max_pages_per_slot)

    def _copy_pool_pages(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Device copy of whole pool pages src[i] -> dst[i] in every layer
        and array, in stream order (the prefix boundary pages, engine.py:
        296-305)."""
        s, d = (upload(list(x), self.device, torch.long) for x in (src, dst))
        for a in self.cache.arrays:
            arr = getattr(self.cache, a)
            arr.index_copy_(1, d, arr.index_select(1, s))

    # ---- KV snapshot / prefix reuse (engine.py:776-853) ----
    def snapshot_slot(self, slot: int, length: int) -> dict | None:
        """Keep one slot's KV prefix (positions [0, length)) for requests that
        share it.

        Dense: copy rows [0, length) of K, V (and an INT8 cache's scales) to
        the host; on the card the copies go into pinned memory without
        waiting, complete once the stream has passed them, which
        ``restore_slot`` (queued on the same stream) needs no more than.
        Paged: no copy of the prefix -- its full pages are pinned by
        refcount and only the partial boundary page is copied on the
        device, into a page of its own (the slot goes on appending into its
        copy).  Returns None when the pool cannot spare that page now (the
        caller simply does not cache).  The mesh engines snapshot their local
        shard; the sharded engine at dp > 1 broadcasts it from the slot's data
        index over ``data``, so that every rank holds it and it restores into
        any slot."""
        if self.spmd and self.mesh.size(DATA_AXIS) > 1:
            return self._snapshot_spmd(slot, length)
        if self.pool is not None:
            pool = self.pool
            row = [int(p) for p in pool.table[slot, :pool.pages_needed(length)]]
            n_shared = length // pool.page_size
            pin = row[:n_shared]
            if length % pool.page_size:
                bp = pool.alloc_page()
                if bp is None:
                    return None
                pool.retain(pin)
                self._copy_pool_pages([row[n_shared]], [bp])
                pin = pin + [bp]
            else:
                pool.retain(pin)
            return {"paged": True, "length": int(length), "pages": pin}
        snap = {"length": int(length)}
        for n in self.cache.arrays:
            src = getattr(self.cache, n)[:, slot, :, :length]
            if src.is_cuda:
                snap[n] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                snap[n].copy_(src, non_blocking=True)
            else:
                snap[n] = src.clone()
        return snap

    def release_snapshot(self, snap: dict | None) -> None:
        """Drop a snapshot's page pins (nothing to release for host copies).
        Call it when a prefix-cache entry is evicted, or its pages stay
        pinned until ``reset``."""
        if snap and snap.get("paged") and self.pool is not None:
            self.pool.release_pages(snap["pages"])

    def restore_slot(self, slot: int, snap: dict, reserve_tokens: int | None = None) -> None:
        """Give a slot a snapshot's prefix; the caller then continues from
        pos == snap["length"].  Dense: write the rows back, on the stream.
        Paged: map the pinned full pages straight into the slot's page-table
        row (shared: decode only appends) and copy the boundary page into a
        private fresh page; ``reserve_tokens`` sizes the slot's whole
        reservation (prompt and generation budget)."""
        length = snap["length"]
        if snap.get("paged"):
            self.pool.release(slot)  # reclaim any stale holding
            need = max(reserve_tokens or length, length)
            res = self.pool.reserve_with_prefix(slot, need, snap["pages"], length)
            if res is None:
                raise RuntimeError("page pool exhausted on prefix restore: gate admissions "
                                   "with Engine.can_admit")
            copies = res[1]
            if copies:
                self._copy_pool_pages([c[0] for c in copies], [c[1] for c in copies])
            self._sync_page_table()
            return
        if self.spmd:
            if not self._mine([slot]):
                return
            slot = int(slot) % self.slots_per_rank
        for n in self.cache.arrays:
            getattr(self.cache, n)[:, slot, :, :length].copy_(snap[n], non_blocking=True)

    def _snapshot_spmd(self, slot: int, length: int) -> dict:
        """A snapshot of ``slot``'s rows [0, length) on every rank of its
        model index: the owner's local rows broadcast over ``data``, then
        copied to the host as ``snapshot_slot``'s."""
        owner = self._owners([slot])[0]
        mine = owner == self.mesh.data_index
        snap = {"length": int(length)}
        for n in self.cache.arrays:
            arr = getattr(self.cache, n)
            rows = (arr[:, int(slot) % self.slots_per_rank, :, :length].contiguous() if mine
                    else torch.empty((arr.shape[0], arr.shape[2], length, *arr.shape[4:]),
                                     dtype=arr.dtype, device=arr.device))
            rows = broadcast(rows, self.mesh, DATA_AXIS, owner)
            snap[n] = rows.cpu() if rows.is_cuda else rows
        return snap
