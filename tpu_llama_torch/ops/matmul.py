"""Quantized matrix products: W8A8 (per-row INT8 activations x
per-channel INT8 weights, K1, and its resident-x form K29) and Q8_0 (fp
activations x group-wise INT8 weights dequantized in the kernel, K25).

Port of tpu_llama/ops/matmul.py:437-610 (``w8a8_matmul`` and
``w8a8_matmul_prequant``, with the residual epilogue of
``_w8a8_res_kernel``, :388), :314 (``_w8a8_rows_resident_call``, taken
above 256 rows under the JAX package's own switch
``TPU_LLAMA_ROWS_RESIDENT=1``, matmul.py:224-234, 513-519) and :142
(``q8_matmul``).  No row padding: the kernels mask their own ragged edges,
and results exist only for real rows.  The kernels' host-side rules (K1's
form, tile, raster and K padding; K29's rows, ring and cluster) have pure
Python mirrors here (``w8a8_plan``, ``w8a8_raster``, ``rows_resident_plan``,
``rows_resident_cluster``, ``rows_resident_grid``), which the CPU tests hold.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor, quantize_activations


def _check(xq: torch.Tensor, sx: torch.Tensor, w: ChannelQuantTensor) -> None:
    if xq.dtype != torch.int8 or w.q.dtype != torch.int8:
        raise TypeError("w8a8 operands must be int8")
    if sx.dtype != torch.float32 or w.s.dtype != torch.float32:
        raise TypeError("w8a8 scales must be float32")
    if xq.dim() != 2 or w.q.dim() != 2:
        raise ValueError(f"want xq [M, IN] and w.q [OUT, IN], got {tuple(xq.shape)}, "
                         f"{tuple(w.q.shape)}")
    m, k = xq.shape
    n = w.q.shape[0]
    if w.q.shape[1] != k or sx.shape != (m,) or w.s.shape != (n,):
        raise ValueError(f"shape mismatch: xq {tuple(xq.shape)}, sx {tuple(sx.shape)}, "
                         f"w.q {tuple(w.q.shape)}, w.s {tuple(w.s.shape)}")


def w8a8_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  out_dtype=torch.float32, residual=None) -> torch.Tensor:
    """K1's epilogue on its sums ``acc`` [M, N] (int32, or their exact
    float value): ``(f32(acc) * sx[row]) * sw[col]`` (matmul.py:383-385),
    one cast to ``out_dtype``; with a residual, ``residual + that`` in
    ``out_dtype`` (matmul.py:407-409).  Each step is one correctly rounded
    operation, as in the kernel, so on the int32 form's sums (all-reduced
    over K-slices by the sharded engine) it gives K1's output bit for
    bit."""
    out = (acc.float() * sx[:, None] * sw[None, :]).to(out_dtype)
    return out if residual is None else residual.to(out_dtype) + out


def w8a8_matmul_int32_plain(xq: torch.Tensor, w: ChannelQuantTensor) -> torch.Tensor:
    """Plain version of K1's int32 form: the exact sums xq @ w.q^T as int32
    [M, N], the accumulation of ``w8a8_matmul_prequant_plain`` before its
    epilogue (exact in float64: 127^2 * IN < 2^53)."""
    return (xq.double() @ w.q.double().T).to(torch.int32)


def w8a8_matmul_prequant_plain(xq, sx, w: ChannelQuantTensor, out_dtype=torch.float32,
                               residual=None):
    """Plain version of K1.  The int32 accumulation is exact in float64
    (127^2 * IN < 2^53 for every IN this engine sees), then
    ``w8a8_epilogue``."""
    acc = (xq.double() @ w.q.double().T).float()
    return w8a8_epilogue(acc, sx, w.s, out_dtype, residual)


def w8a8_matmul_int32(xq: torch.Tensor, w: ChannelQuantTensor) -> torch.Tensor:
    """K1's int32 form: xq int8 [M, IN] times w [OUT, IN] -> the exact
    int32 sums [M, OUT], no epilogue (the scales go unread).  The sharded
    engine runs it on a row-sharded product's K-slice, all-reduces the sums
    and applies ``w8a8_epilogue`` once.  K1's kernel (both its forms, by M)
    on CUDA tensors, counted as ``"K1:i32"``; the plain version on CPU
    ones."""
    if xq.dtype != torch.int8 or w.q.dtype != torch.int8:
        raise TypeError("w8a8 operands must be int8")
    if xq.dim() != 2 or w.q.dim() != 2 or w.q.shape[1] != xq.shape[1]:
        raise ValueError(f"want xq [M, IN] and w.q [OUT, IN], got {tuple(xq.shape)}, "
                         f"{tuple(w.q.shape)}")
    if _kernels.on_cpu("K1:i32", xq, w.q):
        return w8a8_matmul_int32_plain(xq, w)
    return launch_w8a8("K1:i32", xq, None, w, torch.int32)


def w8a8_matmul_prequant(xq: torch.Tensor, sx: torch.Tensor, w: ChannelQuantTensor,
                         out_dtype=torch.float32, residual=None) -> torch.Tensor:
    """xq int8 [M, IN] (quantized rows), sx f32 [M], w [OUT, IN] -> [M, OUT]
    in ``out_dtype``.  ``residual`` [M, OUT] (any float dtype) gives
    ``residual + xq @ W``: the matmul term is rounded to ``out_dtype``
    first, then added in that dtype, as the unfused ``x + mm``.  K1 on CUDA
    tensors, the plain version on CPU ones; K29 (the same numbers) where
    ``rows_resident_route`` holds."""
    _check(xq, sx, w)
    if residual is not None and residual.shape != (xq.shape[0], w.out_features):
        raise ValueError(f"want residual [{xq.shape[0]}, {w.out_features}], got "
                         f"{tuple(residual.shape)}")
    if rows_resident_route(xq.shape[0], xq.shape[1]):
        return w8a8_rows_resident(xq, sx, w, out_dtype, residual)
    tensors = (xq, sx, w.q, w.s) + (() if residual is None else (residual,))
    if _kernels.on_cpu("K1", *tensors):
        return w8a8_matmul_prequant_plain(xq, sx, w, out_dtype, residual)
    return launch_w8a8("K1", xq, sx, w, out_dtype, residual)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# K29 (csrc/w8a8_rows_resident.cu): a resident x slice of BM rows and K
# rounded up to 128-byte TMA boxes (no row pad: the 128-byte swizzle keeps
# the wgmma reads free of bank conflicts), beside a ring of 2-8 stages of 64
# weight rows x 128 k-bytes for each consumer warpgroup, the ring's barriers
# and 1 KB of alignment slack, within the 232448 bytes a block may use.
RESIDENT_BK = 128  # k bytes of a stage and of an x box
_RESIDENT_STAGES = (2, 8)  # the least and the most stages of the ring
_RESIDENT_FIXED = 1024 + (2 * _RESIDENT_STAGES[1] + 1) * 8
_RESIDENT_SMEM = 232448
# (x rows, consumer warpgroups), in the kernel's order of preference
_RESIDENT_ORDER = ((32, 4), (32, 2), (16, 4), (16, 2))
# the blocks of a cluster along M that share each weight stage by multicast
ROWS_RESIDENT_CLUSTER = 2
RESIDENT_CLUSTERS = (1, 2, 4, 8)


@dataclass(frozen=True)
class RowsPlan:
    """How K29 runs an inner size: ``bm`` x rows a block holds (0: not
    taken), ``consumers`` warpgroups of 64 weight rows each (a stage and a
    weight tile are ``rows`` = 64 x consumers rows) and ``stages`` in the
    ring."""
    bm: int
    consumers: int
    stages: int

    @property
    def rows(self) -> int:
        return 64 * self.consumers


def rows_resident_smem(bm: int, n_in: int, consumers: int, stages: int) -> int:
    """Shared memory of a K29 block: the slice, the ring, barriers and slack."""
    return _RESIDENT_FIXED + bm * _cdiv(n_in, RESIDENT_BK) * RESIDENT_BK + \
        stages * 64 * consumers * RESIDENT_BK


def rows_resident_plan(n_in: int) -> RowsPlan:
    """K29's rows, consumers and ring for an inner size ``n_in``: the first
    of 32 rows and 4 consumers, 32 and 2, 16 and 4, 16 and 2 beside which two
    or more stages fit (more consumers issue more of the narrow wgmma at
    once; more rows halve the blocks that stream W); bm 0 where K29 does not
    take ``n_in`` (not a multiple of 16, which TMA's strides need, or too
    wide).  The rule of csrc/w8a8_rows_resident.cu plan_for."""
    if n_in >= 16 and n_in % 16 == 0:
        lo, hi = _RESIDENT_STAGES
        for bm, consumers in _RESIDENT_ORDER:
            left = _RESIDENT_SMEM - rows_resident_smem(bm, n_in, consumers, 0)
            stages = min(hi, max(0, left) // (64 * consumers * RESIDENT_BK))
            if stages >= lo:
                return RowsPlan(bm, consumers, stages)
    return RowsPlan(0, 0, 0)


def rows_resident_bm(n_in: int) -> int:
    """The rows of x a K29 block holds for an inner size ``n_in`` (32 or
    16), 0 where K29 does not take ``n_in`` (``rows_resident_plan``)."""
    return rows_resident_plan(n_in).bm


def rows_resident_cluster(m: int, bm: int) -> int:
    """The blocks along M of a K29 cluster (each fetches 1/C of every weight
    stage and multicasts it to all C): ROWS_RESIDENT_CLUSTER, halved while
    it exceeds the m-blocks."""
    c, blocks = ROWS_RESIDENT_CLUSTER, _cdiv(m, bm)
    while c > 1 and c > blocks:
        c //= 2
    return c


def rows_resident_grid(m: int, n: int, plan: RowsPlan, cluster: int,
                       sms: int = 132) -> tuple[int, int]:
    """K29's grid (m-blocks, splits of the weight tiles): ceil(M / BM)
    m-blocks rounded up to a multiple of the cluster, and where fewer
    m-blocks than SMs run, floor(SMs / m-blocks) blocks along y, each
    walking the weight tiles of ``plan.rows`` rows t = y, y + splits, ...
    The rule of csrc/w8a8_rows_resident.cu launch."""
    nm = _cdiv(_cdiv(m, plan.bm), cluster) * cluster
    return nm, max(1, min(_cdiv(n, plan.rows), sms // nm))


def rows_resident_route(m: int, n_in: int) -> bool:
    """Whether ``w8a8_matmul_prequant`` takes K29: above 256 rows with the
    JAX package's switch ``TPU_LLAMA_ROWS_RESIDENT=1`` set (read at each
    call), for an inner size K29 takes -- as the JAX function takes its
    rows-resident kernel where its plan exists (matmul.py:513-519)."""
    return (m > 256 and os.environ.get("TPU_LLAMA_ROWS_RESIDENT") == "1"
            and rows_resident_bm(n_in) > 0)


def w8a8_rows_resident(xq: torch.Tensor, sx: torch.Tensor, w: ChannelQuantTensor,
                       out_dtype=torch.float32, residual=None, cluster=None) -> torch.Tensor:
    """K1's function (see :func:`w8a8_matmul_prequant`) with each block's x
    rows held resident in shared memory while the weights stream past
    them (K29): equal to K1 bit for bit.  The inner size must be a multiple
    of 16 that ``rows_resident_bm`` takes.  ``cluster`` (1, 2, 4 or 8)
    overrides ``rows_resident_cluster``'s pick.  K29 on CUDA tensors, K1's
    plain version on CPU ones."""
    _check(xq, sx, w)
    if residual is not None and residual.shape != (xq.shape[0], w.out_features):
        raise ValueError(f"want residual [{xq.shape[0]}, {w.out_features}], got "
                         f"{tuple(residual.shape)}")
    if cluster is not None and cluster not in RESIDENT_CLUSTERS:
        raise ValueError(f"K29 clusters hold {RESIDENT_CLUSTERS} blocks, not {cluster}")
    tensors = (xq, sx, w.q, w.s) + (() if residual is None else (residual,))
    if _kernels.on_cpu("K29", *tensors):
        return w8a8_matmul_prequant_plain(xq, sx, w, out_dtype, residual)
    m, k = xq.shape
    bm = rows_resident_bm(k)
    if not bm:
        raise NotImplementedError(f"K29 holds x rows of a multiple of 16 bytes, up to 12288, "
                                  f"in shared memory: got {k}")
    code = _kernels.dtype_code(out_dtype)
    xq, sx = xq.contiguous(), sx.contiguous()
    wq, ws = w.q.contiguous(), w.s.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("K29 loads x and w by TMA: both must be 16-byte aligned")
    res = None if residual is None else residual.to(out_dtype).contiguous()
    n = wq.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        _kernels.launch("K29", xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        None if res is None else res.data_ptr(), out.data_ptr(), code, m, n, k,
                        bm, cluster or rows_resident_cluster(m, bm), _kernels.stream(xq))
    return out


# K1 (csrc/w8a8_matmul.cu): up to W8A8_DECODE_ROWS rows the mma.sync decode
# tile (16 x 32, 256-byte k-tiles, any K); above them the wgmma + TMA
# kernel's 128 x 256 tiles (x rows x weight rows, 128 k-bytes a stage) in
# raster groups of W8A8_GROUP_N column blocks.  TMA reads rows of a multiple
# of 16 bytes from 16-byte aligned bases.
W8A8_DECODE_ROWS = 16
W8A8_DECODE_TILE = (16, 32, 256)
W8A8_TILE = (128, 256, 128)
W8A8_GROUP_N = 16
_TMA_BYTES = 16


@dataclass(frozen=True)
class W8A8Plan:
    """How K1 runs a product of M x K by K x N: ``form`` "decode" or
    "wgmma", its ``tile`` (rows, columns, k bytes a stage), the ``k`` it is
    launched with (K zero-padded to a multiple of 16 on the wgmma form: the
    padded columns add 0 to every int32 sum) and its ``blocks``."""
    form: str
    tile: tuple[int, int, int]
    k: int
    blocks: int


def w8a8_plan(m: int, k: int, n: int) -> W8A8Plan:
    """K1's form, tile and K padding for M x K by K x N (the rule of
    csrc/w8a8_matmul.cu dispatch)."""
    if m <= W8A8_DECODE_ROWS:
        bm, bn, _ = W8A8_DECODE_TILE
        return W8A8Plan("decode", W8A8_DECODE_TILE, k, _cdiv(m, bm) * _cdiv(n, bn))
    bm, bn, _ = W8A8_TILE
    return W8A8Plan("wgmma", W8A8_TILE, _cdiv(k, _TMA_BYTES) * _TMA_BYTES,
                    _cdiv(m, bm) * _cdiv(n, bn))


def w8a8_raster(m: int, n: int) -> list[tuple[int, int]]:
    """(m-block, n-block) of each block of K1's wgmma kernel, by block index:
    groups of W8A8_GROUP_N column blocks (the last group what is left), the
    column blocks of a group side by side and its m-blocks one after
    another (csrc/w8a8_matmul.cu w8a8_wgmma_kernel's raster)."""
    bm, bn, _ = W8A8_TILE
    num_n, num_m = _cdiv(n, bn), _cdiv(m, bm)
    per_group = W8A8_GROUP_N * num_m
    order = []
    for b in range(num_n * num_m):
        grp, in_grp = divmod(b, per_group)
        first_n = grp * W8A8_GROUP_N
        gsz = min(num_n - first_n, W8A8_GROUP_N)
        order.append((in_grp // gsz, first_n + in_grp % gsz))
    return order


def launch_w8a8(kernel: str, xq, sx, w: ChannelQuantTensor, out_dtype, residual=None):
    """Launch K1's CUDA kernel on checked CUDA operands, counted as
    ``kernel`` (K1, K8 for a layer view of stacked weights, K1:i32 for the
    int32 form: ``out_dtype`` int32, ``sx`` None, scales unread); above
    W8A8_DECODE_ROWS rows K is zero-padded as ``w8a8_plan`` says and
    operands off 16-byte boundaries are copied, for TMA."""
    acc = out_dtype == torch.int32
    code = _kernels.I32_CODE if acc else _kernels.dtype_code(out_dtype)
    xq, wq = xq.contiguous(), w.q.contiguous()
    sx, ws = (None, None) if acc else (sx.contiguous(), w.s.contiguous())
    res = None if residual is None else residual.to(out_dtype).contiguous()
    m, k = xq.shape
    n = wq.shape[0]
    plan = w8a8_plan(m, k, n)
    if plan.form == "wgmma":
        if plan.k != k:
            xq = torch.nn.functional.pad(xq, (0, plan.k - k))
            wq = torch.nn.functional.pad(wq, (0, plan.k - k))
        xq = xq.clone() if xq.data_ptr() % _TMA_BYTES else xq
        wq = wq.clone() if wq.data_ptr() % _TMA_BYTES else wq
        vec = True
    else:
        vec = k % 16 == 0 and xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        _kernels.launch(kernel, xq.data_ptr(), None if acc else sx.data_ptr(), wq.data_ptr(),
                        None if acc else ws.data_ptr(), None if res is None else res.data_ptr(),
                        out.data_ptr(), code, m, n, plan.k, int(vec), _kernels.stream(xq))
    return out


def w8a8_matmul(x: torch.Tensor, w: ChannelQuantTensor, out_dtype=torch.float32,
                residual=None):
    """``x @ dequant(w)`` with x quantized per row (K2) and the contraction in
    int8 (K1).  x [..., IN] -> [..., OUT]; ``residual`` [..., OUT] is added
    in K1's epilogue (see :func:`w8a8_matmul_prequant`)."""
    lead = x.shape[:-1]
    xq, sx = quantize_activations(x.reshape(-1, x.shape[-1]))
    res = None if residual is None else residual.reshape(-1, w.out_features)
    out = w8a8_matmul_prequant(xq, sx, w, out_dtype=out_dtype, residual=res)
    return out.reshape(*lead, w.out_features)


# ---------------------------------------------------------------------------
# Q8_0: x @ W with W group-wise INT8, dequantized with the TPU kernel's bf16
# rounding points (K25).
# ---------------------------------------------------------------------------


def _check_q8(x: torch.Tensor, w: QuantTensor) -> None:
    if w.q.dim() != 2:
        raise ValueError(f"want one [out_p, in_p] matrix (a layer view of stacked weights), "
                         f"got q {tuple(w.q.shape)}")
    if w.q.dtype != torch.int8 or w.s.dtype != torch.float32:
        raise TypeError("Q8_0 weights are int8 values and float32 scales")
    _kernels.dtype_code(x.dtype)  # float32 or bfloat16, else TypeError
    pout, pin = w.q.shape
    if w.s.shape != (pout, pin // w.group_size) or pin % w.group_size:
        raise ValueError(f"scales {tuple(w.s.shape)} do not group q {tuple(w.q.shape)}")
    if x.shape[-1] not in (w.logical_in, pin):
        raise ValueError(f"x has {x.shape[-1]} inputs, the weights {w.logical_in}")


def _pad_in(x2: torch.Tensor, pin: int) -> torch.Tensor:
    """x rows zero-padded to the weights' padded in-dim (matmul.py:159-160)."""
    return x2 if x2.shape[-1] == pin else torch.nn.functional.pad(x2, (0, pin - x2.shape[-1]))


def q8_weight_bf16(w: QuantTensor) -> torch.Tensor:
    """The weights as K25 multiplies them: bf16(bf16(q) * bf16(s)), K-major
    [out_p, in_p] bf16 (matmul.py:130-131)."""
    g = w.group_size
    pout, pin = w.q.shape
    qb = w.q.to(torch.bfloat16).reshape(pout, pin // g, g)
    return (qb * w.s.to(torch.bfloat16)[..., None]).reshape(pout, pin)


def q8_matmul_plain(x: torch.Tensor, w: QuantTensor, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K25: bf16(x) times the bf16 weights of
    ``q8_weight_bf16``, each product exact in f32 and summed in f32 (a
    float32 matmul of bf16 values, exact products in TF32 too), then one
    cast to ``out_dtype``."""
    lead = x.shape[:-1]
    xb = _pad_in(x.reshape(-1, x.shape[-1]), w.padded_in).to(torch.bfloat16).float()
    out = xb @ q8_weight_bf16(w).float().t()
    return out[:, :w.logical_out].to(out_dtype).reshape(*lead, w.logical_out)


# K25's rows limit for its decode kernel (csrc/q8_matmul.cu q8_gemv_kernel);
# above it the wgmma kernel runs on x cast to bf16 and permuted
Q8_GEMV_ROWS = 16


def q8_matmul(x: torch.Tensor, w: QuantTensor, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ dequantize(w)`` with the dequant inside the kernel
    (matmul.py:142): x [..., in] (f32 or bf16; in logical or padded) and one
    Q8_0 matrix (``w.layer(i)`` of stacked weights) -> [..., out] in
    ``out_dtype``.  The weights are dequantized as bf16(bf16(q) *
    bf16(s)), x is rounded to bf16, products are summed in f32.  K25 on
    CUDA tensors, the plain version on CPU ones."""
    _check_q8(x, w)
    if _kernels.on_cpu("K25", x, w.q, w.s):
        return q8_matmul_plain(x, w, out_dtype)
    lead = x.shape[:-1]
    pout, pin = w.q.shape
    if pout % 128:
        raise ValueError(f"K25 takes weights padded to 128 output rows, got {pout}")
    x2 = _pad_in(x.reshape(-1, x.shape[-1]), pin)
    m = x2.shape[0]
    if m > Q8_GEMV_ROWS:
        # the wgmma kernel reads x as bf16 (the contract's own rounding,
        # applied once here rather than by every block) with its k order
        # permuted within each 16: logical k 8 h + 2 t + e holds element
        # 4 t + 2 h + e, so that a lane's weight fragment is 4 neighbouring
        # bytes (csrc/q8_matmul.cu dequant_tile).  One copy.
        xp = torch.empty((m, pin), dtype=torch.bfloat16, device=x.device)
        xp.view(m, pin // 16, 2, 4, 2).copy_(
            x2.reshape(m, pin // 16, 4, 2, 2).permute(0, 1, 3, 2, 4))
        x2 = xp
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    q, sc = w.q.contiguous(), w.s.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("K25 takes weights on 16-byte boundaries (TMA)")
    out = torch.empty((m, w.logical_out), dtype=out_dtype, device=x.device)
    if m:
        _kernels.launch("K25", x2.data_ptr(), _kernels.dtype_code(x2.dtype), q.data_ptr(),
                        sc.data_ptr(), out.data_ptr(), _kernels.dtype_code(out_dtype), m,
                        w.logical_out, pout, pin, w.group_size, _kernels.stream(x2))
    return out.reshape(*lead, w.logical_out)
