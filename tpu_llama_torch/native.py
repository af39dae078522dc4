"""Builds of the host-side C/C++ helpers under ``native/`` (the page
allocator, the BPE encoder, the C oracle), compiled at first use into
``build/native/`` at the repo root.

A build's file name carries a hash of its source and command line, so an
edited source rebuilds and the JAX package's builds (in a temp directory of
their own) never share a path with these.  The compiler writes a file
beside the target, which ``os.replace`` then moves into place: a concurrent
build (pytest-xdist workers) never loads half a file.  Nothing is built at
import time.  Host code only: no device work.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native"
BUILD = ROOT / "build" / "native"


def build(source: str, stem: str, compilers: tuple[str, ...], flags: tuple[str, ...],
          libs: tuple[str, ...] = (), suffix: str = "") -> Path | None:
    """``native/<source>`` compiled with the first of ``compilers`` that is
    installed and succeeds (``<cc> <flags> src -o out <libs>``), or None
    where the source is missing or no compiler builds it.  A build made
    earlier is returned as it is."""
    src = NATIVE / source
    if not src.exists():
        return None
    for cc in compilers:
        if shutil.which(cc) is None:
            continue
        key = src.read_bytes() + " ".join((cc, *flags, *libs)).encode()
        out = BUILD / f"{stem}-{hashlib.sha256(key).hexdigest()[:16]}{suffix}"
        if out.exists():
            return out
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cc, *flags, str(src), "-o", str(tmp), *libs], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        return out
    return None
