"""Segment-sum primitive for per-node vote aggregation.

The batched fork-choice engine reduces hundreds of thousands of
``(validator_index, target_node, effective_balance)`` vote rows into one
weight delta per proto-array node.  That reduction is a segment sum over
the node axis — the same shape as the participation scatters in
``ops/epoch.py`` (``np.add.at`` over dense arrays).

This slice of the port keeps the host (numpy) path only; the device
branch of the reference comes back with fork choice (ROADMAP queue A,
item 10).
"""
from __future__ import annotations

import numpy as np


def segment_sum(values: np.ndarray, segment_ids: np.ndarray,
                num_segments: int) -> np.ndarray:
    """``out[s] = sum(values[segment_ids == s])`` as int64 [num_segments].

    ``segment_ids`` must be in ``[0, num_segments)``; callers filter
    negative ids (the proto-array's "no node" sentinel) beforehand.
    """
    values = np.asarray(values, dtype=np.int64)
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    out = np.zeros(num_segments, dtype=np.int64)
    np.add.at(out, segment_ids, values)
    return out
