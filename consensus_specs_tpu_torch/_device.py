"""Device selection for the port.

Every entry point takes ``device=``.  None means the CUDA card; a host
without one raises instead of quietly running on the CPU.  The CPU runs
only when a caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA card."""
    if device is None:
        return default_device()
    return torch.device(device)


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` holding ``host``'s values.  Read-only numpy
    arrays (the resident column stores hand those out) are copied first,
    since torch may share memory with its source on the CPU."""
    if not host.flags.writeable:
        host = host.copy()
    return torch.as_tensor(host, device=device)
