"""Builder and runner of the independent C oracle (``native/oracle.c``).

Port of tpu_llama/compat/native_oracle.py.  The C binary is a second
implementation of the reference's numeric contract (f64 compute, f32
stores -- llama2.ts:205-303, :348-394) that shares no code with
``compat.oracle``; tests hold the two to the same token streams.  Compiled
at first use with cc, gcc or g++ into ``build/native/``
(``tpu_llama_torch.native``); ``build_oracle`` returns None where no
compiler builds it, and callers (tests) skip.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from tpu_llama_torch import native


def build_oracle() -> Path | None:
    """The built ``native/oracle.c`` binary, compiled now if it is missing;
    None where that is impossible."""
    return native.build("oracle.c", "oracle", ("cc", "gcc", "g++"), ("-O2",), libs=("-lm",))


def run_oracle(model_path: str | os.PathLike, tokenizer_path: str | os.PathLike,
               prompt: str = "", steps: int = 256, temperature: float = 1.0, topp: float = 1.0,
               seed: int = 1, timeout: float = 600.0) -> list[int]:
    """Run the C oracle; returns the chosen-token stream (prompt-forced and
    sampled, stopping before the BOS terminator): the stream that
    ``compat.generate.generate_compat`` returns in ``.tokens``."""
    binary = build_oracle()
    if binary is None:
        raise RuntimeError("no C compiler available for native/oracle.c")
    cmd = [str(binary), str(model_path), str(tokenizer_path), "-s", str(seed),
           "-t", repr(temperature), "-p", repr(topp), "-n", str(steps)]
    if prompt:
        cmd += ["-i", prompt]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"oracle exited {out.returncode}: {out.stderr}")
    return [int(line) for line in out.stdout.split()]
