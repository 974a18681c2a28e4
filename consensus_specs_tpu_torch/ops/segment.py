"""Segment-sum primitive for per-node vote aggregation.

The batched fork-choice engine reduces hundreds of thousands of
``(validator_index, target_node, effective_balance)`` vote rows into one
weight delta per proto-array node.  That reduction is a segment sum over
the node axis — the same shape as the participation scatters in
``ops/epoch.py`` (``np.add.at`` over dense arrays) and an int64
``index_add_`` on a device.

The host path is the default: vote batches are memory-light (int64
triples) and arrive host-side, so one ``np.add.at`` wins over an upload,
a scatter and a download.  ``CSTPU_SEGMENT_BACKEND=torch`` (or
``backend="torch"``) moves the reduction onto ``device`` unchanged (None
is the CUDA card, which raises on a host without one); the differential
tests (tests/test_torch_forkchoice.py) pin the two backends
element-identical.
"""
from __future__ import annotations

import os

import numpy as np

BACKENDS = ("numpy", "torch")


def backend_in_use() -> str:
    """The backend a call without ``backend=`` takes."""
    return os.environ.get("CSTPU_SEGMENT_BACKEND", "numpy")


def segment_sum(values: np.ndarray, segment_ids: np.ndarray,
                num_segments: int, backend: str | None = None,
                device=None) -> np.ndarray:
    """``out[s] = sum(values[segment_ids == s])`` as int64 [num_segments].

    ``segment_ids`` must be in ``[0, num_segments)``; callers filter
    negative ids (the proto-array's "no node" sentinel) beforehand.
    """
    if backend is None:
        backend = backend_in_use()
    if backend not in BACKENDS:
        raise ValueError(f"unknown segment backend {backend!r}")
    values = np.asarray(values, dtype=np.int64)
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    if backend == "torch":
        import torch

        from consensus_specs_tpu_torch._device import resolve_device, upload

        dev = resolve_device(device)
        out = torch.zeros(num_segments, dtype=torch.int64, device=dev)
        out.index_add_(0, upload(segment_ids, dev), upload(values, dev))
        # host-sync: callers consume the node deltas on the host
        return out.cpu().numpy()
    out = np.zeros(num_segments, dtype=np.int64)
    np.add.at(out, segment_ids, values)
    return out
