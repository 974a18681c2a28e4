"""Standalone reference merkleizer (behavioral twin of
eth2spec/utils/merkle_minimal.py:7-89) used as the correctness oracle for
the persistent-node merkleization and by deposit-proof helpers.
"""
from __future__ import annotations

from typing import List, Sequence

from .hashing import ZERO_HASHES, sha256


def calc_merkle_tree_from_leaves(values: Sequence[bytes], layer_count: int = 32) -> List[List[bytes]]:
    values = list(values)
    tree = [values[:]]
    for h in range(layer_count):
        if len(values) % 2 == 1:
            values.append(ZERO_HASHES[h])
        values = [sha256(values[i] + values[i + 1]) for i in range(0, len(values), 2)]
        tree.append(values[:])
    return tree


def get_merkle_root(values: Sequence[bytes], pad_to: int = 1) -> bytes:
    layer_count = (pad_to - 1).bit_length() if pad_to > 1 else 0
    if len(values) == 0:
        return ZERO_HASHES[layer_count]
    return calc_merkle_tree_from_leaves(values, layer_count)[-1][0]


def get_merkle_proof(tree: List[List[bytes]], item_index: int, tree_len: int = None) -> List[bytes]:
    proof = []
    for i in range(tree_len if tree_len is not None else len(tree)):
        subindex = (item_index // 2**i) ^ 1
        proof.append(tree[i][subindex] if subindex < len(tree[i]) else ZERO_HASHES[i])
    return proof


def merkleize_chunks(chunks: Sequence[bytes], limit: int = None) -> bytes:
    """Streaming merkleization per ssz/simple-serialize.md:210-248."""
    count = len(chunks)
    if limit is None:
        limit = count
    assert count <= limit, f"merkleize: {count} chunks exceeds limit {limit}"
    if limit == 0:
        return ZERO_HASHES[0]
    depth = (limit - 1).bit_length() if limit > 1 else 0
    if count == 0:
        return ZERO_HASHES[depth]
    layer = [bytes(c) for c in chunks]
    for h in range(depth):
        if len(layer) % 2 == 1:
            layer.append(ZERO_HASHES[h])
        layer = [sha256(layer[i] + layer[i + 1]) for i in range(0, len(layer), 2)]
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return sha256(root + length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return sha256(root + selector.to_bytes(32, "little"))
