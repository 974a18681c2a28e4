"""Vectorized swap-or-not shuffle (whole-permutation form).

The spec's ``compute_shuffled_index`` (reference:
specs/phase0/beacon-chain.md:760-781) maps ONE index through
``SHUFFLE_ROUND_COUNT`` rounds, costing 2 SHA-256 per round per index.
Committees need the image of *every* index, so the per-index form does
O(n · rounds) hashes with n-fold redundancy: within a round, indices
sharing ``position // 256`` share the source hash.

This module computes the full permutation in one pass: per round, one
pivot hash plus ``ceil(n/256)`` source hashes (hashlib, C speed), then a
numpy gather applies the round to all lanes at once.  For mainnet-scale
(400k validators, 90 rounds) that is ~140k hashes total instead of
~72M.  ``permutation[i] == compute_shuffled_index(i, n, seed)`` exactly;
differential-tested in tests/test_shuffle.py.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

_cache: Dict[Tuple[bytes, int, int], np.ndarray] = {}
_CACHE_MAX = 16


def compute_shuffle_permutation(seed: bytes, index_count: int, round_count: int) -> np.ndarray:
    """Return an int64 array p of length index_count with
    p[i] = compute_shuffled_index(i, index_count, seed)."""
    from consensus_specs_tpu_torch import tracing

    key = (bytes(seed), int(index_count), int(round_count))
    hit = _cache.get(key)
    if hit is not None:
        tracing.count("shuffle.permutation_cache_hit")
        return hit
    tracing.count("shuffle.permutation_compute")
    n = int(index_count)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    seed = bytes(seed)
    m = np.arange(n, dtype=np.int64)
    n_blocks = (n + 255) // 256
    block_ids = np.arange(n_blocks, dtype=np.int64)
    for rnd in range(round_count):
        rb = bytes([rnd])
        pivot = int.from_bytes(hashlib.sha256(seed + rb).digest()[:8], "little") % n
        flip = (pivot - m) % n
        position = np.maximum(m, flip)
        # one source hash per 256-index block; gather bits per lane
        src = np.frombuffer(
            b"".join(
                hashlib.sha256(seed + rb + int(b).to_bytes(4, "little")).digest()
                for b in block_ids
            ),
            dtype=np.uint8,
        ).reshape(n_blocks, 32)
        byte_vals = src[position // 256, (position % 256) // 8]
        bits = (byte_vals >> (position % 8).astype(np.uint8)) & 1
        m = np.where(bits.astype(bool), flip, m)
    if len(_cache) >= _CACHE_MAX:
        _cache.pop(next(iter(_cache)))
    m.setflags(write=False)  # shared across callers; mutation would corrupt committees
    _cache[key] = m
    return m


def committee_bounds(n_active: int, committees_per_epoch: int) -> np.ndarray:
    """Slice boundaries of every committee of an epoch over the shuffled
    permutation: ``bounds[g] : bounds[g + 1]`` is the permutation range of
    global committee index ``g`` (``(slot % SLOTS_PER_EPOCH) *
    committees_per_slot + index``), exactly the spec's ``compute_committee``
    start/end arithmetic (beacon-chain.md:944-950) evaluated for all
    committees at once."""
    g = np.arange(committees_per_epoch + 1, dtype=np.int64)
    return (n_active * g) // committees_per_epoch
