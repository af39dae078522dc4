"""Where K12's time goes, phase by phase, on the card.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.k12_phases [--reps 10]

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


def _stamped_lib():
    """Build fused_step2.cu with -DFD_STAMPS (once; ``build_extra``) and load
    it with K12's argument types."""
    from tpu_llama_torch.ops import _kernels as K

    lib = K.open_lib("fused_step2", K.build_extra(K._CSRC / "fused_step2.cu", ["-DFD_STAMPS"]))
    lib.tl_fused_step2_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tl_fused_step2_stamps.restype = ctypes.c_int
    return lib


def main(argv=None) -> None:
    import argparse

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels as K
    from tpu_llama_torch.ops import attention as tatt
    from tpu_llama_torch.ops import fused_step2 as tfs
    from tpu_llama_torch.ops.quant import ChannelQuantTensor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k12_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    K.load(["fused_step2", "flash_decode_dma"])
    committed = K._libs["fused_step2"]
    stamped = _stamped_lib()
    ev_n, blk_n = 24, 2048  # fused_decode.cuh kStampEvents, kStampBlocks
    buf = (ctypes.c_ulonglong * (ev_n * blk_n))()

    cfg = LLAMA2_7B
    L, D, H, KVH, hd, S = (cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_kv_heads, cfg.head_dim,
                           cfg.seq_len)
    QO = D + 2 * KVH * hd
    gen = torch.Generator(device="cuda").manual_seed(12)

    def qt(n_in, n_out):
        return ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=gen, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=gen, device="cuda") * 2e-4 + 1e-4)

    ws = (qt(D, D), qt(D, 2 * H), qt(H, D), qt(D, QO))
    rf, ra = [(1 + 0.1 * torch.randn(L, D, generator=gen, device="cuda")).to(torch.bfloat16)
              for _ in range(2)]

    def events_ms(fn, iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn(0)
        torch.cuda.synchronize()
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

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
        last, first = {}, {}
        nb = 0
        for r in range(args.reps):
            # a block's stamp of an event it did not reach this launch is an
            # older launch's: each launch is read from its own first start on
            k12(r)
            torch.cuda.synchronize()
            code = stamped.tl_fused_step2_stamps(buf, ev_n * blk_n)
            if code:
                raise RuntimeError(f"stamps read failed ({code})")
            st = np.frombuffer(buf, dtype=np.uint64).reshape(blk_n, ev_n).astype(np.int64)
            starts = st[:, 0]
            nb = int((starts > 0).sum()) if r == 0 else nb
            run = st[:nb]
            t0 = run[:, 0].min()
            for e in range(ev_n):
                col = run[:, e]
                col = col[col >= t0]
                if col.size == 0:
                    continue
                last.setdefault(e, []).append((col.max() - t0) / 1e3)
                first.setdefault(e, []).append((col.min() - t0) / 1e3)
        ms_stamped = events_ms(k12, 20)
        K._libs["fused_step2"] = committed
        ms_committed = events_ms(k12, 20)
        K._libs["fused_step2"] = stamped
        ms_stamped2 = events_ms(k12, 20)
        K._libs["fused_step2"] = committed
        ms_committed2 = events_ms(k12, 20)
        line = dict(shape=f"B={B} pos={pos[0] if B == 1 else 'mix'} layer {layer}", blocks=nb,
                    last_us={e: statistics.median(v) for e, v in sorted(last.items())},
                    first_us={e: statistics.median(v) for e, v in sorted(first.items())},
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
