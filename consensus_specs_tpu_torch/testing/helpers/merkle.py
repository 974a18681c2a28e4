"""Merkle proof helper for tests (reference capability:
test/helpers/merkle.py) — thin adapter over the ssz gindex machinery."""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.gindex import build_proof as _build_proof


def build_proof(anchor, leaf_index):
    """Single-leaf branch proof for generalized index ``leaf_index``,
    anchored at a view or backing node."""
    node = anchor.get_backing() if hasattr(anchor, "get_backing") else anchor
    if leaf_index <= 1:
        return []
    return _build_proof(node, leaf_index)
