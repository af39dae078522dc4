"""Phase 4i's 2-layer tensor-parallel parity, card against CPU, over several
weight seeds: the readings that set ``chip_smoke.py``'s greedy rule for it.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.tp_parity_seeds --seeds 1 2 3 4 5 6 --tp 1 2

For each seed and tp, ``parallel.launch.tp_parity`` on Llama-2 7B's width
cut to 2 layers (f32 activations, random W8A8 weights drawn from the seed;
the prompts and steps of phase 4i) runs on the card (kernels: K6 and K7 for
the admission, K9 for the fused TP decode, K21 for the unfused one) and on
the CPU (plain versions) -- tp = 1 in this process, tp = 2 as two ranks
over gloo on each side, as phase 4i runs it -- and
``launch.parity_reading`` compares them: for each TP decode, the step the greedy picks first part, the logits'
largest error over max |logit| up to there, and at a parting the CPU's gap
between the two logits that swapped and the card-CPU error of those rows.
Prints one JSON line per seed, then one with the largest readings, the
card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from tpu_llama_torch.config import LLAMA2_7B
from tpu_llama_torch.parallel import MeshConfig, launch, single_device_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=[16, 9])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tp", type=int, nargs="+", default=[1], choices=[1, 2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_parity_seeds: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    rng = np.random.default_rng(7)  # phase 4i's prompts
    prompts = [[1] + [int(t) for t in rng.integers(3, cfg.vocab_size, n - 1)]
               for n in args.prompt_lens]
    readings = []

    def side(tp, device, seed):
        parity = (cfg, seed, prompts, args.steps)
        if tp == 1:
            return launch.tp_parity(single_device_mesh(device), *parity)
        return launch.run(launch.tp_parity, MeshConfig(1, tp), args=parity, backend="gloo",
                          device=device, timeout=600, threads=4)[0]

    for tp in args.tp:
        for seed in args.seeds:
            reading = launch.parity_reading(side(tp, "cuda", seed), side(tp, "cpu", seed))
            readings.append(reading)
            print(json.dumps(dict(seed=seed, tp=tp, layers=2, **reading, card=smi)), flush=True)
    summary = {}
    for mode in ("fused", "unfused"):
        rds = [r[mode] for r in readings]
        parted = [r for r in rds if r["parted_at"] is not None]
        summary[mode] = dict(max_logits_err=max(r["logits_err"] for r in rds),
                             parted=len(parted), of=len(rds),
                             gap_over_row_err=[r["gap"] / r["row_err"] for r in parted])
    print(json.dumps(dict(summary=summary, seeds=args.seeds, tp=args.tp, card=smi)), flush=True)


if __name__ == "__main__":
    main()
