"""What a bare stream of a row quant's bytes reaches on the card, and K2's
and K3's times beside it.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.stream_probe [--kernels-only] [--sweep]

(a) Builds ``csrc/stream_probe.cu`` (no kernel of the port) and times, at
K2's bytes on bf16 [4096, 4096] (33.6 MB read, 16.8 MB written), two bare
streams: a read-reduce-write with 16-byte loads and stores over a
persistent grid (``unroll`` units of 32 input bytes in flight a thread),
and a 1D bulk-copy ring (``cp.async.bulk`` of ``piece``-byte pieces,
``stages`` in flight a block, as K12's weight ring).  (b) Times K2
(``quantize_activations``) and K3 (``rmsnorm_quantize``, bf16 w) through
the package's wrappers at bf16 [4096, 4096], [2048, 4096] and [8, 4096]
and f32 [8, 4096], K2 also at bf16 [4096, 11008] and f32 [8, 2048], each
against its plain version (K2 bit-equal, K3
within one int8 step on 1e-4 of entries); where the package has
``ops.quant.rq_plan`` and ``--sweep`` is given, also at other launch
plans (warps a row, blocks).  Kernel times are device ms from a
torch.profiler trace over 20 launches (the wrappers' back-to-back
CUDA-event ms beside, which on a slow host read the Python launch path),
inputs rotated past the 50 MB L2.  Prints one JSON line per reading.  It
calls the wrappers' public signatures only, so ``PYTHONPATH=<other
checkout> python3 tpu_llama_torch/stream_probe.py --kernels-only`` times
another checkout's K2 and K3.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

HBM_BYTES_S = 3.35e12  # H100 SXM, NVIDIA data sheet
_SRC = Path(__file__).resolve().parent / "csrc" / "stream_probe.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def events_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean ms of ``fn(i)`` over ``iters`` back-to-back calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _copies(nbytes: int) -> int:
    return int(min(8, max(1, math.ceil(2 * 50e6 / nbytes))))


def streams(smi: str, sms: int) -> None:
    from tpu_llama_torch.ops import _kernels as K

    lib = ctypes.CDLL(str(K.build_extra(_SRC)))
    lib.probe_stream_rrw.argtypes = [_P, _P, _L, _I, _I, _P]
    lib.probe_stream_ring.argtypes = [_P, _P, _L, _I, _I, _I, _P]
    lib.probe_residency.argtypes = [_I, _I, _I, _P]
    for f in (lib.probe_stream_rrw, lib.probe_stream_ring, lib.probe_residency):
        f.restype = ctypes.c_int
    in_bytes = 4096 * 4096 * 2
    copies = _copies(in_bytes)
    ins = [torch.randint(-2**15, 2**15, (in_bytes // 2,), dtype=torch.int16, device="cuda")
           for _ in range(copies)]
    out = torch.empty(in_bytes // 2, dtype=torch.uint8, device="cuda")
    want = ins[0].view(torch.uint8).view(-1, 2)[:, 1].contiguous()
    st = torch.cuda.current_stream().cuda_stream
    moved = in_bytes * 1.5

    def resident(kernel, unroll, smem):
        n = ctypes.c_int(0)
        code = lib.probe_residency(kernel, unroll, smem, ctypes.byref(n))
        if code:
            raise RuntimeError(f"residency query failed ({code})")
        return n.value

    def report(form, ms, **kw):
        print(json.dumps(dict(probe="stream", form=form, ms=ms, tb_s=moved / ms / 1e9,
                              share_of_bound=moved / HBM_BYTES_S * 1e3 / ms, card=smi, **kw)),
              flush=True)

    for unroll in (1, 2, 4, 8):
        top = resident(0, unroll, 0)
        for bps in sorted({1, 2, 4, top}):
            if bps > top:
                continue
            grid = sms * bps

            def run(i, u=unroll, g=grid):
                code = lib.probe_stream_rrw(ins[i % copies].data_ptr(), out.data_ptr(), in_bytes,
                                            u, g, st)
                if code:
                    raise RuntimeError(f"stream_rrw failed ({code})")

            run(0)
            torch.cuda.synchronize()
            assert torch.equal(out, want), "stream_rrw wrote other bytes"
            report("read_reduce_write", events_ms(run), unroll=unroll, blocks_per_sm=bps)
    for piece in (8192, 16384):
        for stages in (2, 4, 8):
            smem = piece * stages
            top = resident(1, 0, smem)
            for bps in sorted({1, top}):
                if bps < 1 or bps > top:
                    continue
                grid = sms * bps

                def run(i, p=piece, s=stages, g=grid):
                    code = lib.probe_stream_ring(ins[i % copies].data_ptr(), out.data_ptr(),
                                                 in_bytes, p, s, g, st)
                    if code:
                        raise RuntimeError(f"stream_ring failed ({code})")

                out.zero_()
                run(0)
                torch.cuda.synchronize()
                assert torch.equal(out, want), "stream_ring wrote other bytes"
                report("bulk_ring", events_ms(run), piece=piece, stages=stages,
                       blocks_per_sm=bps)


# (kernel, M, N, x dtype): the admission's, a chunk's and a decode step's
# rows (bf16 as the admission runs them, f32 as mega2's prologue and the TP
# decode at tp 1 and 2 do), and K2 on the unfused w2 input
SHAPES = (("K2", 4096, 4096, "bf16"), ("K2", 2048, 4096, "bf16"), ("K2", 8, 4096, "bf16"),
          ("K2", 4096, 11008, "bf16"), ("K2", 8, 4096, "f32"), ("K2", 8, 2048, "f32"),
          ("K3", 4096, 4096, "bf16"), ("K3", 2048, 4096, "bf16"), ("K3", 8, 4096, "bf16"),
          ("K3", 8, 4096, "f32"))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNEL_NAMES = {"K2": "quantize_rows_kernel", "K3": "rmsnorm_quantize_kernel"}


def device_ms(fn, name: str, n: int = 20) -> float:
    """Mean device ms of the kernels named ``name`` (a substring) over ``n``
    calls of ``fn(i)``, from a torch.profiler trace (taken again, up to
    three times, when the tracer dropped more than half the launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(us) >= n // 2:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"{len(us)} {name} launches traced of {n}")


def _plans(tq, m, n, eb, sms):
    """The launch plans to sweep: (warps a row, blocks) at the rule's warps
    and twice that, grids of 2-8 blocks an SM and of one row a team."""
    p = tq.rq_plan(m, n, eb, sms)
    seen = []
    for warps in (p.warps, 2 * p.warps):
        if warps <= tq.RQ_WARPS:
            teams = tq.RQ_WARPS // warps
            for bps in (2, 3, 4, 6, 8, None):
                seen.append((warps, -(-m // teams) if bps is None else
                             min(-(-m // teams), sms * bps)))
    return list(dict.fromkeys(seen))


def kernels(smi: str, sms: int, sweep: bool) -> None:
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import quant as tq

    names = ["quantize_rows", "rmsnorm_quantize"]
    logs = K.build(names)  # these two only, not every source
    K.load(names)
    for src in names:
        for ln in logs[src].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {src}: {ln.strip()[:160]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = (1 + 0.2 * torch.randn(4096, generator=gen, device="cuda")).to(torch.bfloat16)
    st = torch.cuda.current_stream().cuda_stream
    for kernel, m, n, dt in SHAPES:
        eb = torch.empty(0, dtype=DTYPES[dt]).element_size()
        copies = _copies(eb * m * n)
        xs = [(torch.randn(m, n, generator=gen, device="cuda") * 2).to(DTYPES[dt])
              for _ in range(copies)]
        code = 1 if dt == "bf16" else 0
        q16 = int(n % 16 == 0 and eb == 2)  # as ops/quant.py passes it
        moved = (eb + 1) * m * n + 4 * m + (2 * n if kernel == "K3" else 0)
        if kernel == "K2":
            fn, plain = tq.quantize_activations, tq.quantize_activations_plain
        else:
            fn, plain = (lambda x: tq.rmsnorm_quantize(x, w)), \
                (lambda x: tq.rmsnorm_quantize_plain(x, w))
        forms = [("wrapper", lambda i: fn(xs[i % copies]))]
        if sweep and hasattr(tq, "rq_plan"):
            q = torch.empty(m, n, dtype=torch.int8, device="cuda")
            s = torch.empty(m, dtype=torch.float32, device="cuda")
            for plan in _plans(tq, m, n, eb, sms):

                def run(i, plan=plan, q=q, s=s):
                    x = xs[i % copies]
                    if kernel == "K2":
                        K.launch("K2", x.data_ptr(), code, q.data_ptr(), s.data_ptr(), m, n, 1,
                                 q16, *plan, st)
                    else:
                        K.launch("K3", x.data_ptr(), code, w.data_ptr(), 1, q.data_ptr(),
                                 s.data_ptr(), m, n, 1, q16, *plan, st)
                    return q, s

                forms.append(("plan " + " ".join(map(str, plan)), run))
        for form, run in forms:
            qq, ss = run(0)
            torch.cuda.synchronize()
            qp, sp = plain(xs[0])
            d = (qq.int() - qp.int()).abs()
            flips = int((d != 0).sum().item())
            exact = torch.equal(qq, qp) and torch.equal(ss, sp)
            ok = exact if kernel == "K2" else (d.max().item() <= 1 and flips <= 1e-4 * d.numel())
            dev = device_ms(run, KERNEL_NAMES[kernel])
            ms = events_ms(run) if form == "wrapper" else None
            print(json.dumps(dict(probe="kernel", kernel=kernel, shape=[m, n], dtype=dt, form=form,
                                  device_ms=dev, ms=ms, tb_s=moved / dev / 1e9,
                                  bound_ms=moved / HBM_BYTES_S * 1e3, exact=exact, flips=flips,
                                  ok=bool(ok), card=smi)), flush=True)
            if not ok:
                raise SystemExit(f"{kernel} {form} [{m}, {n}] disagrees with its plain version")
        del xs


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="skip the bare streams")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 and K3 at each launch plan of _plans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if not args.kernels_only:
        streams(smi, sms)
    kernels(smi, sms, args.sweep)


if __name__ == "__main__":
    main()
