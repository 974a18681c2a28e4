"""Generalized indices over SSZ types (reference: ssz/merkle-proofs.md:58-189).

Provides ``get_generalized_index(type, *path)`` used by the altair light
client sync protocol (FINALIZED_ROOT_INDEX / NEXT_SYNC_COMMITTEE_INDEX)
and merkle-proof test helpers, plus single-branch proof construction and
verification against a view's backing.
"""
from __future__ import annotations

from typing import List as PyList

from .node import BranchNode, Node, get_subtree, merkle_root
from .types import Bitlist, Bitvector, ByteList, ByteVector, Container, List, Vector, _HomogeneousBase, ceil_log2

GeneralizedIndex = int


def get_generalized_index(typ, *path) -> GeneralizedIndex:
    """Walk `path` (field names / element indices / '__len__') from `typ`."""
    gindex = 1
    for p in path:
        if p == "__len__":
            assert isinstance(typ, type) and issubclass(typ, (List, Bitlist, ByteList))
            gindex = gindex * 2 + 1
            typ = None
            continue
        if isinstance(typ, type) and issubclass(typ, Container):
            idx = typ._field_index[p]
            gindex = (gindex << typ._depth) | idx
            typ = typ._field_types[idx]
        elif isinstance(typ, type) and issubclass(typ, (List, Vector, Bitlist, Bitvector, ByteList, ByteVector)):
            i = int(p)
            if issubclass(typ, (List, Bitlist, ByteList)):
                gindex = gindex * 2  # contents side of the length mixin
            if issubclass(typ, _HomogeneousBase):
                depth = typ.contents_depth()
                if typ._is_packed():
                    per = typ._elems_per_chunk()
                    gindex = (gindex << depth) | (i // per)
                    typ = None
                else:
                    gindex = (gindex << depth) | i
                    typ = typ.ELEM_TYPE
            elif issubclass(typ, (Bitlist, Bitvector)):
                n_chunks_depth = ceil_log2((typ.LENGTH + 255) // 256)
                gindex = (gindex << n_chunks_depth) | (i // 256)
                typ = None
            else:  # ByteVector / ByteList
                byte_len = typ.TYPE_BYTE_LENGTH if issubclass(typ, ByteVector) else typ.LIMIT
                n_chunks_depth = ceil_log2((byte_len + 31) // 32)
                gindex = (gindex << n_chunks_depth) | (i // 32)
                typ = None
        else:
            raise TypeError(f"cannot index into {typ} with {p}")
    return gindex


def get_generalized_index_length(index: GeneralizedIndex) -> int:
    """Depth of a generalized index (ssz/merkle-proofs.md)."""
    return index.bit_length() - 1


def get_subtree_at_gindex(node: Node, gindex: GeneralizedIndex) -> Node:
    depth = gindex.bit_length() - 1
    return get_subtree(node, depth, gindex - (1 << depth))


def build_proof(node: Node, gindex: GeneralizedIndex) -> PyList[bytes]:
    """Sibling hashes along the branch, leaf-side first (matches
    is_valid_merkle_branch ordering, phase0/beacon-chain.md:742-753)."""
    depth = gindex.bit_length() - 1
    index = gindex - (1 << depth)
    proof: PyList[bytes] = []
    cur = node
    for k in range(depth - 1, -1, -1):
        assert isinstance(cur, BranchNode)
        bit = (index >> k) & 1
        sibling = cur.left if bit else cur.right
        proof.append(merkle_root(sibling))
        cur = cur.right if bit else cur.left
    return list(reversed(proof))


# --- multiproofs (ssz/merkle-proofs.md:249-326) -----------------------------


def generalized_index_sibling(index: GeneralizedIndex) -> GeneralizedIndex:
    return index ^ 1


def generalized_index_parent(index: GeneralizedIndex) -> GeneralizedIndex:
    return index // 2


def get_branch_indices(tree_index: GeneralizedIndex) -> PyList[GeneralizedIndex]:
    """Sister-node chain a single-leaf proof consists of."""
    o = [generalized_index_sibling(tree_index)]
    while o[-1] > 1:
        o.append(generalized_index_sibling(generalized_index_parent(o[-1])))
    return o[:-1]


def get_path_indices(tree_index: GeneralizedIndex) -> PyList[GeneralizedIndex]:
    """The leaf's own chain of ancestors up to (excluding) the root."""
    o = [tree_index]
    while o[-1] > 1:
        o.append(generalized_index_parent(o[-1]))
    return o[:-1]


def get_helper_indices(indices) -> PyList[GeneralizedIndex]:
    """Indices of all extra nodes a combined multiproof needs, in the
    canonical descending order."""
    all_helper_indices = set()
    all_path_indices = set()
    for index in indices:
        all_helper_indices.update(get_branch_indices(index))
        all_path_indices.update(get_path_indices(index))
    return sorted(all_helper_indices - all_path_indices, reverse=True)


def calculate_multi_merkle_root(leaves, proof, indices) -> bytes:
    """Root implied by ``leaves`` at ``indices`` plus the helper ``proof``
    nodes (in get_helper_indices order)."""
    from .hashing import sha256

    assert len(leaves) == len(indices)
    helper_indices = get_helper_indices(indices)
    assert len(proof) == len(helper_indices)
    objects = {
        **{index: bytes(node) for index, node in zip(indices, leaves)},
        **{index: bytes(node) for index, node in zip(helper_indices, proof)},
    }
    keys = sorted(objects.keys(), reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and k ^ 1 in objects and k // 2 not in objects:
            objects[k // 2] = sha256(
                objects[(k | 1) ^ 1] + objects[k | 1]
            )
            keys.append(k // 2)
        pos += 1
    return objects[1]


def verify_merkle_multiproof(leaves, proof, indices, root: bytes) -> bool:
    return calculate_multi_merkle_root(leaves, proof, indices) == bytes(root)


def build_multiproof(node: Node, gindices) -> PyList[bytes]:
    """Helper-node roots for a combined proof of all ``gindices`` against
    a backing tree, in get_helper_indices order."""
    return [
        merkle_root(get_subtree_at_gindex(node, helper))
        for helper in get_helper_indices(gindices)
    ]
