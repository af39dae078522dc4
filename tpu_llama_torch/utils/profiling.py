"""Tracing: ``torch.profiler`` capture in a context manager.

Port of tpu_llama/utils/profiling.py.  The trace records host (CPU)
activity, and the card's kernels where CUDA is available, and is written as
a Chrome trace (``trace.json``) into the directory, which Perfetto opens.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
