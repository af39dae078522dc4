"""Per-channel INT8 weights and per-row INT8 activations (W8A8), the
group-wise INT8 weight format Q8_0, and the fused prefill passes that end
in a row quant (K3-K5).

Port of tpu_llama/ops/quant.py:30-541.  Every quantizer here uses the
formula of the JAX package (quant.py:115-118, :255-263): ``s = absmax /
127``, then ``inv = 1 / s`` (0 where s == 0), then ``q = clip(round(x *
inv), -127, 127)`` -- a multiply by the reciprocal, not a division -- with
round half to even (``torch.round``).

One detail decides the bytes: the JAX package quantizes activations and KV
rows inside ``jit`` (and in its Pallas kernel), where XLA's algebraic
simplifier turns ``absmax / 127`` into ``absmax * f32(1/127)``, which can
differ in the last bit; it quantizes weights eagerly, as a true division.
The port does the same in each place, so its int8 bytes and f32 scales
equal the JAX package's as it runs.

W8A8 tensors keep their logical shapes (no TPU padding).  Q8_0 tensors keep
the JAX package's padding (in-dim to ``kernel_alignment(g)``, out-dim to
128), which K25 relies on too.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_llama_torch.ops import _kernels


@dataclasses.dataclass
class ChannelQuantTensor:
    """Per-output-channel symmetric INT8 weights (the W8 of W8A8).

    ``q``: int8 [..., out, in] -- stored K-major, the transpose of the JAX
    package's [..., in, out], because the K1 kernel reads both operands
    contiguous along the contraction.  ``s``: f32 [..., out], one scale per
    output column.  Leading dims (layers) stack.
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def in_features(self) -> int:
        return self.q.shape[-1]

    @property
    def out_features(self) -> int:
        return self.q.shape[-2]

    def layer(self, i: int) -> "ChannelQuantTensor":
        """Layer ``i`` of a stacked tensor, as views (no copy)."""
        return ChannelQuantTensor(q=self.q[i], s=self.s[i])


@dataclasses.dataclass
class QuantTensor:
    """Group-wise symmetric INT8 weights, Q8_0 (quant.py:30): one f32 scale
    per group of ``g`` consecutive weights along the contraction (in) axis.

    ``q``: int8 [..., out_p, in_p] and ``s``: f32 [..., out_p, in_p / g] --
    both stored K-major, the transposes of the JAX package's [..., in_p,
    out_p] and [..., in_p / g, out_p]: K25 reads a weight column's bytes and
    its scales contiguous along the contraction (16-byte copies of one
    column's k-run, and mma's column-major B fragments without a
    transpose), as K1 reads ``ChannelQuantTensor``.  in_p and out_p carry
    the JAX package's zero padding (in to ``kernel_alignment(g)``, out to
    128); padding groups have scale 0.  ``logical_in`` / ``logical_out``
    are the unpadded sizes.  Leading dims (layers) stack.
    """

    q: torch.Tensor
    s: torch.Tensor
    logical_in: int
    logical_out: int

    @property
    def group_size(self) -> int:
        return self.q.shape[-1] // self.s.shape[-1]

    @property
    def in_features(self) -> int:
        return self.logical_in

    @property
    def out_features(self) -> int:
        return self.logical_out

    @property
    def padded_in(self) -> int:
        return self.q.shape[-1]

    @property
    def padded_out(self) -> int:
        return self.q.shape[-2]

    def layer(self, i: int) -> "QuantTensor":
        """Layer ``i`` of a stacked tensor, as views (no copy)."""
        return QuantTensor(q=self.q[i], s=self.s[i], logical_in=self.logical_in,
                           logical_out=self.logical_out)


def kernel_alignment(g: int) -> int:
    """The in-dim of a Q8_0 tensor pads to a multiple of max(8 g, 128)
    (quant.py:74: the TPU kernel's tiling; K25 takes any multiple of 128)."""
    return max(8 * g, 128)


def pick_group_size(in_features: int, preferred: int = 64) -> int:
    """Largest group <= preferred whose kernel alignment divides in_features
    (no padding); otherwise the group minimizing padding (ties -> larger g)
    (quant.py:80)."""
    candidates = [g for g in (64, 32, 16) if g <= max(preferred, 16)]
    for g in candidates:
        if in_features % kernel_alignment(g) == 0:
            return g

    def padding(g):
        a = kernel_alignment(g)
        return -(-in_features // a) * a - in_features

    return min(candidates, key=padding)


def _quantize_q8_2d(w: torch.Tensor, g: int, pin: int, pout: int):
    """One [in, out] matrix -> K-major (q [pout, pin], s [pout, pin / g])."""
    n_in, n_out = w.shape
    wp = torch.zeros((pin, pout), dtype=torch.float32, device=w.device)
    wp[:n_in, :n_out] = w
    wg = wp.reshape(pin // g, g, pout)
    absmax = wg.abs().amax(dim=1)  # [pin / g, pout]
    s = absmax / 127.0
    pos = s > 0
    inv = torch.where(pos, torch.ones_like(s) / torch.where(pos, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.round(wg * inv[:, None, :]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(pin, pout).t().contiguous(), s.t().contiguous()


def quantize_q8(w: torch.Tensor, group_size: int | None = None) -> QuantTensor:
    """[..., in, out] fp weights (the JAX layout) -> Q8_0 (quant.py:95):
    scale = absmax / 127 per group of g along in, q = round(w * (1 / s))
    clipped to +-127 (the JAX function's reciprocal multiply, round half to
    even), zero-scale groups q = 0, s = 0; in zero-padded to
    ``kernel_alignment(g)`` and out to 128.  The bytes equal the JAX
    package's.  Stacked leading dims are quantized one matrix at a time, so
    the f32 temporaries are one layer's, not the stack's."""
    n_in, n_out = w.shape[-2:]
    g = group_size or pick_group_size(n_in)
    align = kernel_alignment(g)
    pin = -(-n_in // align) * align
    pout = -(-n_out // 128) * 128
    lead = w.shape[:-2]
    flat = w.reshape(-1, n_in, n_out)
    q = torch.empty((flat.shape[0], pout, pin), dtype=torch.int8, device=w.device)
    s = torch.empty((flat.shape[0], pout, pin // g), dtype=torch.float32, device=w.device)
    for i in range(flat.shape[0]):
        q[i], s[i] = _quantize_q8_2d(flat[i].float(), g, pin, pout)
    return QuantTensor(q=q.reshape(*lead, pout, pin), s=s.reshape(*lead, pout, pin // g),
                       logical_in=n_in, logical_out=n_out)


def dequantize(t: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """-> [..., in, out], the JAX layout without padding (quant.py:125):
    q * s in f32, then one cast."""
    g = t.group_size
    lead, (pout, pin) = t.q.shape[:-2], t.q.shape[-2:]
    w = (t.q.float().reshape(*lead, pout, pin // g, g) * t.s[..., None]).reshape(*lead, pout, pin)
    return w.transpose(-1, -2)[..., :t.logical_in, :t.logical_out].to(dtype)


def _recip_f32(n: float) -> float:
    """f32(1 / n), correctly rounded, as XLA folds a divide by a constant."""
    return float(torch.tensor(1.0) / torch.tensor(float(n)))


_RECIP_127 = _recip_f32(127)


def sqrt_f32(a) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 values ``a``, as CUDA's
    ``__fsqrt_rn`` and numpy's ``np.sqrt`` give it: taken in f64 and
    rounded once to f32 (double rounding is innocuous for sqrt: f64 has more
    than 2 * 24 + 2 bits).  PyTorch's vectorised f32 ``torch.sqrt`` is not
    correctly rounded on every CPU (1 ulp off on some rows on AVX-512
    hosts), so a plain version that must equal a kernel bit for bit does
    not use it."""
    return torch.sqrt(torch.as_tensor(a, dtype=torch.float32).double()).float()


def _absmax_quant(xf: torch.Tensor, dim: int, jitted: bool = True, out=None):
    """Symmetric absmax INT8 over ``dim`` of an f32 tensor -> (q, s).
    ``jitted`` picks the scale as the JAX package computes it inside jit
    (``absmax * f32(1/127)``) rather than eagerly (``absmax / 127``).
    ``out`` (with ``jitted``): (q, s) tensors to write the result into (the
    same operations, the last of each writing there)."""
    absmax = xf.abs().amax(dim=dim)
    s = torch.mul(absmax, _RECIP_127, out=out and out[1]) if jitted else absmax / 127.0
    pos = s > 0
    inv = torch.where(pos, torch.ones_like(s) / torch.where(pos, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.round(xf * inv.unsqueeze(dim)).clamp_(-127, 127)
    return (out[0].copy_(q) if out else q.to(torch.int8)), s


def quantize_channel(w: torch.Tensor) -> ChannelQuantTensor:
    """w [..., in, out] (the JAX layout) -> per-out-channel INT8, stored
    K-major (quant.py:183)."""
    q, s = _absmax_quant(w.float(), dim=-2, jitted=False)
    return ChannelQuantTensor(q=q.transpose(-1, -2).contiguous(), s=s)


def dequantize_channel(t: ChannelQuantTensor, dtype=torch.float32) -> torch.Tensor:
    """-> [..., in, out], the JAX layout (quant.py:246)."""
    return (t.q.float() * t.s.unsqueeze(-1)).transpose(-1, -2).to(dtype)


def _vec16(n_elems: int, t: torch.Tensor) -> bool:
    """Rows of n_elems elements of t load as 16-byte vectors."""
    return (n_elems * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0


# K2's and K3's launch (csrc/row_quant.cuh): blocks of RQ_WARPS warps, a team
# of 1, 2, 4 or 8 of them a row, RQ_VECS 16-byte vectors of the row in each
# lane's registers; the grid holds at most RQ_GRID_PER_SM blocks an SM (three
# are resident at once, the launch bounds; the block scheduler refills an SM
# as its teams finish).  K3 holds w in shared memory: at most RQ_W_SMEM
# bytes (the 227 KB a block may take).  RQ_WARPS and RQ_VECS are
# row_quant.cuh's kRqWarps and kRqVecs, checked against each built library
# before its first launch (_rq_layout_checked).
RQ_WARPS = 8
RQ_VECS = 8
RQ_GRID_PER_SM = 8
RQ_W_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class RowQuantPlan:
    """How K2 and K3 cover M rows: ``warps`` warps a row (a team), ``grid``
    blocks of RQ_WARPS / warps teams, each team walking at most
    ``rows_per_team`` rows by stride."""

    warps: int
    grid: int
    rows_per_team: int


def rq_plan(m: int, n: int, elem_bytes: int, sms: int) -> RowQuantPlan:
    """K2's and K3's launch rule for x [m, n] of ``elem_bytes`` bytes an
    element on a card of ``sms`` SMs.  A team is the fewest warps whose
    registers hold the row (RQ_VECS vectors a lane: two warps a 7B bf16 row),
    doubled while the grid would have fewer than RQ_WARPS warps an SM (small
    m: a decode step's 8 rows spread over whole blocks, so no lane walks a
    long row alone).  One row a team up to RQ_GRID_PER_SM blocks an SM
    (every row of a 7B admission, chunk or wave); past that the teams walk
    rows by stride."""
    if m <= 0 or n <= 0:
        raise ValueError(f"rq_plan: want m, n > 0, got {m}, {n}")
    nvec = -(-n * elem_bytes // 16)
    warps = 1
    while warps < RQ_WARPS and (nvec > 32 * warps * RQ_VECS or m * warps < sms * RQ_WARPS):
        warps *= 2
    teams = RQ_WARPS // warps
    grid = min(-(-m // teams), sms * RQ_GRID_PER_SM)
    return RowQuantPlan(warps, grid, -(-m // (grid * teams)))


@functools.lru_cache(maxsize=None)
def _rq_layout_checked(kernel: str) -> None:
    """Raises unless ``kernel``'s library (K2 or K3) has the block layout
    that rq_plan assumes: row_quant.cuh's kRqWarps and kRqVecs."""
    got = _kernels.row_quant_layout(kernel)
    if got != (RQ_WARPS, RQ_VECS):
        raise RuntimeError(f"{kernel} was built with (warps, vectors) {got}; rq_plan "
                           f"assumes {(RQ_WARPS, RQ_VECS)}")


@functools.lru_cache(maxsize=256)
def _rq_plan_on(kernel: str, m: int, n: int, elem_bytes: int, device: int) -> tuple:
    """(warps, grid) of rq_plan for ``kernel`` on card ``device``."""
    _rq_layout_checked(kernel)
    plan = rq_plan(m, n, elem_bytes, torch.cuda.get_device_properties(device).multi_processor_count)
    return plan.warps, plan.grid


def _rq_launch_args(kernel: str, x2: torch.Tensor) -> tuple:
    """(vec, q16, warps, grid) of K2's or K3's launch on x2 [M, N]: q16,
    16-byte int8 stores, for bf16 rows whose int8 rows are 16-byte aligned
    (row_quant.cuh)."""
    m, n = x2.shape
    vec = _vec16(n, x2)
    return (int(vec), int(vec and n % 16 == 0 and x2.element_size() == 2),
            *_rq_plan_on(kernel, m, n, x2.element_size(), x2.device.index))


def quantize_activations_plain(x: torch.Tensor):
    """Per-token (last-axis) dynamic symmetric INT8 (quant.py:255): returns
    (q int8 [..., IN], s f32 [...]) with x ~= q * s[..., None]."""
    return _absmax_quant(x.float(), dim=-1)


def quantize_activations(x: torch.Tensor):
    """``quantize_activations_plain`` through the K2 kernel on a CUDA tensor
    (every row count: the TPU's > 256-row gate was an XLA memory-placement
    matter, matmul.py:462-468); the plain version on a CPU tensor."""
    if _kernels.on_cpu("K2", x):
        return quantize_activations_plain(x)
    code = _kernels.dtype_code(x.dtype)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    m = x2.shape[0]
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m and n:
        _kernels.launch("K2", x2.data_ptr(), code, q.data_ptr(), s.data_ptr(), m, n,
                        *_rq_launch_args("K2", x2), _kernels.stream(x2))
    elif m:
        s.zero_()
    return q.reshape(*lead, n), s.reshape(lead)


# ---------------------------------------------------------------------------
# The fused prefill passes (K3, K4, K5).  Each quantizes f32 values that are
# never rounded to the activation dtype, as the TPU kernels define them
# (quant.py:324-329, :387, :443-447), so they differ from the unfused chain
# (rmsnorm, silu * up, apply_rope, each cast back) by design.  Each plain
# version does the CUDA kernel's arithmetic step for step: products and sums
# rounded one at a time (the kernels use round-to-nearest intrinsics, so no
# FMA contraction), the rmsnorm sum of squares in f64.
# ---------------------------------------------------------------------------


def _check_float(name: str, *tensors: torch.Tensor) -> None:
    """float32 or bfloat16, one dtype for all of ``tensors``."""
    for t in tensors:
        _kernels.dtype_code(t.dtype)  # else TypeError
    if len({t.dtype for t in tensors}) > 1:
        raise TypeError(f"{name}: inputs must share one dtype, got "
                        f"{sorted(str(t.dtype) for t in tensors)}")


def rmsnorm_quantize_plain(x: torch.Tensor, w: torch.Tensor):
    """Plain version of K3: ``ms = f32(sum x^2) * f32(1/IN)`` (the sum in
    f64), ``xf = (x * (1 / sqrt(1e-5 + ms))) * w`` in f32, then the row
    quant: (q int8 [M, IN], s f32 [M])."""
    x32 = x.float()
    return _absmax_quant((x32 * rms_factor(x32)) * w.float(), dim=-1)


def rms_factor(x32: torch.Tensor) -> torch.Tensor:
    """K3's rmsnorm factor of each f32 row, [..., 1]: r = 1 / sqrt(1e-5 +
    f32(ss) * f32(1/IN)) with the sum of squares ss in f64, the sqrt
    correctly rounded (``sqrt_f32``), the reciprocal in f32 (common.cuh
    ``rms_factor``)."""
    ss = (x32.double() * x32.double()).sum(dim=-1, keepdim=True).float()
    return sqrt_f32(1e-5 + ss * _recip_f32(x32.shape[-1])).reciprocal()


def rmsnorm_quantize(x: torch.Tensor, w: torch.Tensor):
    """Fused rmsnorm + per-row INT8 (quant.py:340): x [M, IN] (f32 or bf16),
    w [IN] (f32 or bf16) -> (q int8 [M, IN], s f32 [M]).  K3 on CUDA
    tensors, the plain version on CPU ones."""
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"want x [M, IN] and w [IN], got {tuple(x.shape)}, {tuple(w.shape)}")
    _check_float("rmsnorm_quantize", x)  # w's float dtype may differ
    _check_float("rmsnorm_quantize", w)
    if _kernels.on_cpu("K3", x, w):
        return rmsnorm_quantize_plain(x, w)
    if x.shape[1] * w.element_size() > RQ_W_SMEM:
        raise ValueError(f"K3 holds w in shared memory: at most {RQ_W_SMEM} bytes, got "
                         f"{x.shape[1]} x {w.element_size()}")
    xc, wc = x.contiguous(), w.contiguous()
    m, n = xc.shape
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m and n:
        _kernels.launch("K3", xc.data_ptr(), _kernels.dtype_code(xc.dtype), wc.data_ptr(),
                        _kernels.dtype_code(wc.dtype), q.data_ptr(), s.data_ptr(), m, n,
                        *_rq_launch_args("K3", xc), _kernels.stream(xc))
    elif m:
        s.zero_()
    return q, s


def silu_mul_quantize_plain(gate: torch.Tensor, up: torch.Tensor):
    """Plain version of K4: ``(g * sigmoid(g)) * u`` in f32 (``jax.nn.silu``
    is x * sigmoid(x)), then the row quant: (q int8 [M, H], s f32 [M])."""
    g = gate.float()
    return _absmax_quant((g * torch.sigmoid(g)) * up.float(), dim=-1)


def silu_mul_quantize(gate: torch.Tensor, up: torch.Tensor):
    """Fused SwiGLU gate + per-row INT8 (quant.py:396): gate, up [M, H] ->
    (q int8 [M, H], s f32 [M]).  gate and up may be the two column halves
    of one [M, 2H] tensor: they must share a row stride and have unit
    column strides, and are read where they lie (no copy).  K4 on CUDA
    tensors, the plain version on CPU ones."""
    if gate.dim() != 2 or up.shape != gate.shape:
        raise ValueError(f"want gate and up [M, H], got {tuple(gate.shape)}, "
                         f"{tuple(up.shape)}")
    _check_float("silu_mul_quantize", gate, up)
    m, h = gate.shape
    if m and h and (gate.stride(1) != 1 or up.stride(1) != 1
                    or (m > 1 and gate.stride(0) != up.stride(0))):
        raise ValueError(f"gate and up need unit column strides and one row stride, got "
                         f"{gate.stride()}, {up.stride()}")
    if _kernels.on_cpu("K4", gate, up):
        return silu_mul_quantize_plain(gate, up)
    ld = gate.stride(0) if m > 1 else h
    q = torch.empty((m, h), dtype=torch.int8, device=gate.device)
    s = torch.empty((m,), dtype=torch.float32, device=gate.device)
    if m and h:
        vec = _vec16(h, gate) and _vec16(ld, gate) and _vec16(h, up)
        _kernels.launch("K4", gate.data_ptr(), up.data_ptr(), _kernels.dtype_code(gate.dtype),
                        ld, q.data_ptr(), s.data_ptr(), m, h, int(vec), _kernels.stream(gate))
    elif m:
        s.zero_()
    return q, s


def rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs of every head in f32
    (llama.py:540 before its cast): x [..., n_heads, hd], cos/sin f32
    broadcastable to [..., hd/2].  ``r0 = x0 cos - x1 sin``,
    ``r1 = x0 sin + x1 cos``, each product and sum rounded."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)  # broadcast over heads
    r0 = x0 * cos - x1 * sin  # promotes to f32 (the tables are f32)
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(shape)


def _check_rope_split(qkv, cos, sin, D, KVH, hd, out):
    if hd <= 0 or hd % 2 or D % hd:
        raise ValueError(f"want an even head_dim dividing D, got hd={hd}, D={D}")
    if qkv.dim() != 2 or qkv.shape[1] != D + 2 * KVH * hd:
        raise ValueError(f"want qkv [M, {D + 2 * KVH * hd}], got {tuple(qkv.shape)}")
    _check_float("rope_split_quantize", qkv)
    M = qkv.shape[0]
    if cos.shape != (M, hd // 2) or sin.shape != cos.shape:
        raise ValueError(f"want cos and sin [{M}, {hd // 2}], got {tuple(cos.shape)}, "
                         f"{tuple(sin.shape)}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError("the rope tables must be float32")
    if out is None:
        return
    kq, ks, vq, vs = out
    if kq.dim() != 4 or kq.shape[2:] != (KVH, hd) or kq.shape[0] * kq.shape[1] != M:
        raise ValueError(f"want out K/V [B, T, {KVH}, {hd}] with B * T = {M}, got "
                         f"{tuple(kq.shape)}")
    if vq.shape != kq.shape or ks.shape != kq.shape[:3] or vs.shape != ks.shape:
        raise ValueError("out: K/V and their scales disagree in shape")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or ks.dtype != torch.float32 \
            or vs.dtype != torch.float32:
        raise TypeError("out: int8 K/V and float32 scales")
    if kq.stride() != vq.stride() or ks.stride() != vs.stride() or kq.stride(3) != 1:
        raise ValueError("out: K and V (and their scales) need one layout, hd contiguous")


def rope_split_quantize_plain(qkv, cos, sin, D: int, KVH: int, hd: int, out=None):
    """Plain version of K5 (its arguments and results are
    :func:`rope_split_quantize`'s)."""
    M, KVD = qkv.shape[0], KVH * hd
    x = qkv.float()
    q = rope_f32(x[:, :D].reshape(M, D // hd, hd), cos, sin).reshape(M, D).to(qkv.dtype)
    kq, ks = _absmax_quant(rope_f32(x[:, D:D + KVD].reshape(M, KVH, hd), cos, sin), dim=-1)
    vq, vs = _absmax_quant(x[:, D + KVD:].reshape(M, KVH, hd), dim=-1)
    if out is None:
        return q, kq.reshape(M, KVD), ks, vq.reshape(M, KVD), vs
    for dst, src in zip(out, (kq, ks, vq, vs)):
        dst.copy_(src.reshape(dst.shape))
    return (q, *out)


def rope_split_quantize(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, D: int,
                        KVH: int, hd: int, out=None):
    """Fused qkv epilogue of the prefill (quant.py:476): qkv [M, D + 2 KVD]
    (f32 or bf16), cos/sin f32 [M, hd/2] (each row's position, gathered) ->
    (q roped [M, D] in qkv's dtype, kq int8 [M, KVD], ks f32 [M, KVH],
    vq int8 [M, KVD], vs f32 [M, KVH]): RoPE in f32 on q and k, then k and
    v quantized per (row, head) from the unrounded f32 values.

    ``out=(kq, ks, vq, vs)`` writes K/V into given tensors instead, in
    place: views [B, T, KVH, hd] and [B, T, KVH] with B * T = M (row
    m = b T + t), any strides with hd contiguous -- e.g. the layer's block
    of a head-major cache ``cache.k[l, :, :, :T].transpose(1, 2)``, which spares the
    transposes and copies; these views are returned in their places.  K5 on
    CUDA tensors, the plain version on CPU ones."""
    _check_rope_split(qkv, cos, sin, D, KVH, hd, out)
    tensors = (qkv, cos, sin) + (tuple(out) if out is not None else ())
    if _kernels.on_cpu("K5", *tensors):
        return rope_split_quantize_plain(qkv, cos, sin, D, KVH, hd, out)
    if hd > 128:
        raise NotImplementedError(f"K5 takes head_dim <= 128, got {hd}")
    M, KVD = qkv.shape[0], KVH * hd
    x = qkv.contiguous()
    if x.data_ptr() % (2 * x.element_size()):
        raise ValueError("K5 reads qkv in aligned element pairs")
    cs, sn = cos.contiguous(), sin.contiguous()
    dev = qkv.device
    q = torch.empty((M, D), dtype=qkv.dtype, device=dev)
    if out is None:
        kq = torch.empty((M, KVD), dtype=torch.int8, device=dev)
        vq = torch.empty((M, KVD), dtype=torch.int8, device=dev)
        ks = torch.empty((M, KVH), dtype=torch.float32, device=dev)
        vs = torch.empty((M, KVH), dtype=torch.float32, device=dev)
        res = (q, kq, ks, vq, vs)
        T, kst, sst = M, (0, KVD, hd), (0, KVH, 1)  # (b, t, h) strides of the JAX layout
    else:
        kq, ks, vq, vs = out
        res = (q, *out)
        T, kst, sst = kq.shape[1], kq.stride()[:3], ks.stride()
    if M:
        _kernels.launch("K5", x.data_ptr(), _kernels.dtype_code(x.dtype), cs.data_ptr(),
                        sn.data_ptr(), q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                        vq.data_ptr(), vs.data_ptr(), M, D // hd, KVH, hd, T, *kst, *sst,
                        _kernels.stream(x))
    return res
