"""Where the time of K12 (and of K11, K27, K23 or K24) goes, phase by phase, on the card.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.k12_phases [--reps 10] [--kernel k12|k11|k27|k23|k24|k10|k14]

Builds ``csrc/fused_step2.cu`` a second time with ``-DFD_STAMPS`` (every
block records ``%globaltimer`` at each of its FD_STAMP events,
``csrc/fused_decode.cuh``), swaps that library in for K12's, and runs
``fused_step2_layer`` at Llama-2 7B width on random W8A8 weights at the
four shapes of PERF.md's K12 row: batch 8 with one slot at each of
0, 1, 127, 128, 511, 1000, 1900, 2047 (layer 17), batch 1 at pos 511 and
at pos 2047 (layer 17), and batch 8 on the last layer.  For every event it
prints, over ``--reps`` launches, the median of the time from the first
block's start to the LAST block reaching the event (the launch's critical
path) and to the FIRST block reaching it, in microseconds.  It also times,
with CUDA events, the stamped and the committed library in turns (the
stamps' cost), and the committed K12 alone against K12 launched after
K9's split cell (the shared-memory carveout question of PERF.md section 7).
Prints one JSON line per shape, then one for the carveout test.

``--kernel k11`` stamps K11 (``csrc/fused_layer.cu``, the same streaming
body's phases without cells) through ``fused_layer_linear`` at batch 8 on
layer 17 and the last layer, batch 32 on layer 17 and batch 1 on layer 17;
``--kernel k27`` stamps K27 (``csrc/fused_step.cu``: the cells, then the
phases) through ``fused_step_layer`` at K12's four shapes.  Both print the
same lines as K12's, without the carveout test.  Events (fused_step2.cuh):
19 the layer's start, 0 / 1 phase A, 14 / 15 the first row step (blocks b <
B), 2 / 3 phase B ready, 4 phase B done, 5 phase C ready, 6 phase C done,
16 / 17 the second row step, 7 / 8 phase D ready, 9 phase D done, 10 / 11
the cells, 18 / 12 the attention quant, 13 the exit; 20 / 21 / 22 inside
the row steps (the row's loads, its sum of squares, its quant).

``--kernel k23`` / ``k24`` stamps the tensor-parallel spans
(``csrc/fused_ffn.cu`` / ``fused_rms_qkv.cu``) through
``fused_ffn_stacked`` / ``fused_rms_qkv_stacked`` at Llama-2 7B's local
widths (D 4096, Hl = 11008 / tp, QOl = 12288 / tp) for tp 1 / 2 / 4 / 8 at
batch 8, and tp 1 at batch 32, 37 (two row groups) and 1.  For each shape
it prints the stamps' medians (from event 19, which every block stamps
first -- in the last row group where there are two; 14 / 15 the row step,
2 / 3 phase B ready or 7 / 8 phase D ready, 4 / 6 / 9 the phases done, 13
the exit; 20 / 21 / 22 inside the row step), whether the committed build's
output equals the plain version bit for bit, and its CUDA-event and trace
device ms per call.

``--kernel k10`` / ``k14`` stamps the KV row flush (``csrc/kv_flush.cuh``,
built with ``-DKV_STAMPS``) through ``kv_cache_flush_rows`` /
``kv_pool_flush_rows`` at ``profile_serving.flush_cases``' shapes (K10
INT8, f32 and bf16 on the 7B cache; K14 at batch 8 and 32).  Events: 0
the block's start, 1 pos (and the page) in hand, 2 the rows in registers,
3 the stores done (after a fence).  Then the committed build's CUDA-event
and trace device ms per call.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

DECODE_POS = [0, 1, 127, 128, 511, 1000, 1900, 2047]
SHAPES = ((8, DECODE_POS, 17), (1, [511], 17), (1, [2047], 17), (8, DECODE_POS, 31))


def _stamped_lib(name="fused_step2"):
    """Build csrc/<name>.cu with -DFD_STAMPS (once; ``build_extra``) and load
    it with its kernel's argument types; its stamps' reader is
    ``lib.stamps``."""
    from tpu_llama_torch.ops import _kernels as K

    lib = K.open_lib(name, K.build_extra(K._CSRC / f"{name}.cu", ["-DFD_STAMPS"]))
    lib.stamps = getattr(lib, f"tl_{name}_stamps")
    lib.stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stamps.restype = ctypes.c_int
    return lib


EV_N, BLK_N = 24, 2048  # fused_decode.cuh kStampEvents, kStampBlocks
FLUSH_EV_N = 4  # kv_flush.cuh kStampEvents (its kStampBlocks is BLK_N)


def stamp_medians(lib, call, reps: int, start: int = 0, ev_n: int = EV_N):
    """Over ``reps`` calls of ``call(r)`` (each one launch of ``lib``'s
    stamped kernel), the median of the time from the first block's start
    (event ``start``, which every block stamps first) to the last block and
    to the first block reaching each event, in us, by event; and the blocks
    of the launch.  ``ev_n``: the events a block has room for."""
    buf = (ctypes.c_ulonglong * (ev_n * BLK_N))()
    last, first = {}, {}
    nb = 0
    for r in range(reps):
        # a block's stamp of an event it did not reach this launch is an
        # older launch's: each launch is read from its own first start on
        call(r)
        torch.cuda.synchronize()
        code = lib.stamps(buf, ev_n * BLK_N)
        if code:
            raise RuntimeError(f"stamps read failed ({code})")
        st = np.frombuffer(buf, dtype=np.uint64).reshape(BLK_N, ev_n).astype(np.int64)
        # this launch's blocks started within a few us of each other; rows
        # of blocks past its grid hold an older launch's stamps
        starts = st[:, start]
        run = st[starts >= starts.max() - 1_000_000]
        nb = len(run)
        t0 = run[:, start].min()
        for e in range(ev_n):
            col = run[:, e]
            col = col[col >= t0]
            if col.size == 0:
                continue
            last.setdefault(e, []).append((col.max() - t0) / 1e3)
            first.setdefault(e, []).append((col.min() - t0) / 1e3)
    return ({e: statistics.median(v) for e, v in sorted(last.items())},
            {e: statistics.median(v) for e, v in sorted(first.items())}, nb)


def events_ms(fn, iters):
    """CUDA-event ms per call of ``fn(i)`` over ``iters`` back-to-back calls."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn(0)
    torch.cuda.synchronize()
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def stamp_kernel(kernel: str, reps: int, smi: str, ws, rf, ra, gen, cfg) -> None:
    """``--kernel k11`` or ``k27``: one JSON line per shape, as K12's, for
    K11 (fused_layer.cu) or K27 (fused_step.cu)."""
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import fused_layer as tfl
    from tpu_llama_torch.ops import fused_step as tfst

    name = {"k11": "fused_layer", "k27": "fused_step"}[kernel]
    K.load([name])
    committed = K._libs[name]
    stamped = _stamped_lib(name)
    L, D, KVH, hd, S = cfg.n_layers, cfg.dim, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    shapes = (((8, None, 17), (8, None, L - 1), (32, None, 17), (1, None, 17)) if kernel == "k11"
              else SHAPES)
    for B, pos, layer in shapes:
        x = torch.randn(B, D, generator=gen, device="cuda")
        layers = [layer] if layer == L - 1 else [(layer + i) % (L - 1) for i in range(8)]
        if kernel == "k11":
            attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda",
                                 dtype=torch.int8)
            satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005

            def call(i):
                tfl.fused_layer_linear(x, attq, satt, *ws, rf, ra, layers[i % len(layers)], L)
        else:
            cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                                   dtype=torch.int8) for _ in range(2)]
            scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                      for _ in range(2)]
            q = torch.randn(B, KVH, 1, hd, generator=gen, device="cuda")
            nk = torch.randint(-127, 128, (B, KVH, hd), generator=gen, device="cuda",
                               dtype=torch.int8)
            nks = torch.rand(B, KVH, generator=gen, device="cuda") * 0.02 + 0.01
            pt = torch.tensor(pos, dtype=torch.int32, device="cuda")

            def call(i):
                tfst.fused_step_layer(x, q, nk, nk, nks, nks, *cache, *scales, pt, *ws, rf, ra,
                                      layers[i % len(layers)], L)
        K._libs[name] = stamped
        call(0)
        torch.cuda.synchronize()
        last, first, nb = stamp_medians(stamped, call, reps, 10 if kernel == "k27" else 0)
        turns = []
        for lib in (stamped, committed, stamped, committed):
            K._libs[name] = lib
            turns.append(events_ms(call, 20))
        K._libs[name] = committed
        shape = (f"B={B} layer {layer}" if pos is None else
                 f"B={B} pos={pos[0] if B == 1 else 'mix'} layer {layer}")
        print(json.dumps(dict(kernel=kernel.upper(), shape=shape, blocks=nb,
            last_us=last, first_us=first, events_ms_committed=turns[1::2],
            events_ms_stamped=turns[0::2], card=smi)), flush=True)
        torch.cuda.empty_cache()


SPAN_SHAPES = ((1, 8), (2, 8), (4, 8), (8, 8), (1, 32), (1, 37), (1, 1))  # (tp, batch)


def stamp_span(kernel: str, reps: int, smi: str, gen) -> None:
    """``--kernel k23`` or ``k24``: one JSON line per shape of SPAN_SHAPES."""
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import fused_layer as tfl
    from tpu_llama_torch.ops.quant import ChannelQuantTensor
    from tpu_llama_torch.profile_serving import timed

    name = {"k23": "fused_ffn", "k24": "fused_rms_qkv"}[kernel]
    K.load([name])
    committed = K._libs[name]
    stamped = _stamped_lib(name)
    Lw, D = 4, 4096
    for tp, B in SPAN_SHAPES:
        N = (11008 if kernel == "k23" else 12288) // tp

        def qt(n_in, n_out):
            return ChannelQuantTensor(
                q=torch.randint(-127, 128, (Lw, n_out, n_in), generator=gen, device="cuda",
                                dtype=torch.int8),
                s=torch.rand(Lw, n_out, generator=gen, device="cuda") * 2e-4 + 1e-4)

        rms = (1 + 0.1 * torch.randn(Lw, D, generator=gen, device="cuda")).to(torch.bfloat16)
        x = torch.randn(B, D, generator=gen, device="cuda")
        if kernel == "k23":
            w = (qt(D, 2 * N), qt(N, D))
            fn, plain = tfl.fused_ffn_stacked, tfl.fused_ffn_stacked_plain
        else:
            w = (qt(D, N),)
            fn, plain = tfl.fused_rms_qkv_stacked, tfl.fused_rms_qkv_stacked_plain

        def call(i):
            return fn(x, *w, rms, i % Lw)

        exact = bool(torch.equal(call(1), plain(x, *w, rms, 1)))
        K._libs[name] = stamped
        call(0)
        torch.cuda.synchronize()
        last, first, nb = stamp_medians(stamped, call, reps, 19)
        K._libs[name] = committed
        ev, dev = timed(call, 20)
        print(json.dumps(dict(kernel=kernel.upper(), tp=tp, batch=B, D=D, N=N, blocks=nb,
                              bit_equal=exact, last_us=last, first_us=first, events_ms=ev,
                              device_ms=dev, card=smi)), flush=True)
        del w, x
        torch.cuda.empty_cache()


def stamp_flush(kernel: str, reps: int, smi: str, cfg) -> None:
    """``--kernel k10`` or ``k14``: one JSON line per shape of the kernel in
    ``profile_serving.flush_cases``."""
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import attention as tatt
    from tpu_llama_torch.profile_serving import flush_cases, timed

    name = {"k10": "kv_flush_rows", "k14": "kv_pool_flush_rows"}[kernel]
    K.load([name])
    committed = K._libs[name]
    stamped = K.open_lib(name, K.build_extra(K._CSRC / f"{name}.cu", ["-DKV_STAMPS"]))
    stamped.stamps = getattr(stamped, f"tl_{name}_stamps")
    stamped.stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    stamped.stamps.restype = ctypes.c_int

    def use(lib):
        K._libs[name] = lib
        tatt._FLUSH_PLANS.clear()  # a plan keeps the entry point it was made with

    for case in flush_cases(cfg, (kernel.upper(),)):
        use(stamped)
        case["call"](0)
        torch.cuda.synchronize()
        last, first, nb = stamp_medians(stamped, case["call"], reps, 0, FLUSH_EV_N)
        use(committed)
        ev, dev = timed(case["call"], 50)
        print(json.dumps(dict(kernel=case["kernel"], shape=case["label"], blocks=nb,
                              last_us=last, first_us=first, events_ms=ev, device_ms=dev,
                              card=smi)), flush=True)
        del case


def main(argv=None) -> None:
    import argparse

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import attention as tatt
    from tpu_llama_torch.ops import fused_step2 as tfs
    from tpu_llama_torch.ops.quant import ChannelQuantTensor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernel", choices=("k12", "k11", "k27", "k23", "k24", "k10", "k14"),
                    default="k12")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k12_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    L, D, H, KVH, hd, S = (cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_kv_heads, cfg.head_dim,
                           cfg.seq_len)
    QO = D + 2 * KVH * hd
    gen = torch.Generator(device="cuda").manual_seed(12)
    if args.kernel in ("k23", "k24"):
        stamp_span(args.kernel, args.reps, smi, gen)
        return
    if args.kernel in ("k10", "k14"):
        stamp_flush(args.kernel, args.reps, smi, cfg)
        return

    def qt(n_in, n_out):
        return ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=gen, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=gen, device="cuda") * 2e-4 + 1e-4)

    ws = (qt(D, D), qt(D, 2 * H), qt(H, D), qt(D, QO))
    rf, ra = [(1 + 0.1 * torch.randn(L, D, generator=gen, device="cuda")).to(torch.bfloat16)
              for _ in range(2)]
    if args.kernel != "k12":
        stamp_kernel(args.kernel, args.reps, smi, ws, rf, ra, gen, cfg)
        return
    K.load(["fused_step2", "flash_decode_dma"])
    committed = K._libs["fused_step2"]
    stamped = _stamped_lib()

    for B, pos, layer in SHAPES:
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                  for _ in range(2)]
        ang = torch.rand(B, hd // 2, generator=gen, device="cuda") * 6.3
        x = torch.randn(B, D, generator=gen, device="cuda")
        attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda", dtype=torch.int8)
        satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        call_args = (x, attq, satt, cache[0], cache[1], scales[0], scales[1], pt, ang.cos(),
                     ang.sin(), *ws, rf, ra)
        layers = [layer] if layer == L - 1 else [(layer + i) % (L - 1) for i in range(8)]

        def k12(i):
            tfs.fused_step2_layer(*call_args, layers[i % len(layers)], L, cfg.n_heads)

        K._libs["fused_step2"] = stamped
        k12(0)
        torch.cuda.synchronize()
        last, first, nb = stamp_medians(stamped, k12, args.reps)
        ms_stamped = events_ms(k12, 20)
        K._libs["fused_step2"] = committed
        ms_committed = events_ms(k12, 20)
        K._libs["fused_step2"] = stamped
        ms_stamped2 = events_ms(k12, 20)
        K._libs["fused_step2"] = committed
        ms_committed2 = events_ms(k12, 20)
        line = dict(shape=f"B={B} pos={pos[0] if B == 1 else 'mix'} layer {layer}", blocks=nb,
                    last_us=last, first_us=first,
                    events_ms_committed=[ms_committed, ms_committed2],
                    events_ms_stamped=[ms_stamped, ms_stamped2], card=smi)
        print(json.dumps(line), flush=True)
        del cache, scales, call_args
        torch.cuda.empty_cache()

    # the carveout question: K12 alone, then each K12 launch right after a K9
    # split-cell launch (105 KB of shared memory a block), per-launch events
    B, pos = 1, [2047]
    cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
              for _ in range(2)]
    ang = torch.rand(B, hd // 2, generator=gen, device="cuda") * 6.3
    x = torch.randn(B, D, generator=gen, device="cuda")
    attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda", dtype=torch.int8)
    satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005
    pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
    call_args = (x, attq, satt, cache[0], cache[1], scales[0], scales[1], pt, ang.cos(),
                 ang.sin(), *ws, rf, ra)
    q = torch.randn(B, KVH, 1, hd, generator=gen, device="cuda")
    nk = torch.randint(-127, 128, (B, KVH, hd), generator=gen, device="cuda", dtype=torch.int8)
    nks = torch.rand(B, KVH, generator=gen, device="cuda") * 0.02 + 0.01

    def k9():
        tatt.flash_decode_attention_dma(q, cache[0], cache[1], pt, nk, nk, scales[0],
                                        scales[1], nks, nks, layer=3)

    def per_launch(with_k9, n=16):
        out = []
        for i in range(n):
            if with_k9:
                k9()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            tfs.fused_step2_layer(*call_args, (17 + i) % (L - 1), L, cfg.n_heads)
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    per_launch(True, 2)
    turns = [("alone", per_launch(False)), ("after_k9", per_launch(True)),
             ("after_k9", per_launch(True)), ("alone", per_launch(False))]
    print(json.dumps(dict(carveout="K12 B=1 pos=2047 layer 17+, per-launch events ms",
                          turns=turns, card=smi)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
