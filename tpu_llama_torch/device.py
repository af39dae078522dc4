"""Device selection for the port's entry points, and host-to-device uploads."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``"cuda"``).  Asking for CUDA where there is
    no card raises: the port runs on the CPU only when the caller asks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def upload(a, device, dtype=None) -> torch.Tensor:
    """A copy of host data ``a`` (array-like) on ``device``, in ``dtype``.
    On a CUDA device the copy goes through pinned memory and does not wait:
    PyTorch's copy from pageable memory synchronizes the stream, which would
    stall the host behind every kernel already queued (a decode chunk in
    flight, say).  The pinned block stays reserved until the copy is done."""
    t = torch.tensor(np.asarray(a), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
