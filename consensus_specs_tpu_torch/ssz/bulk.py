"""Bulk numpy <-> SSZ-backing transfers.

The vectorized epoch pipeline consumes whole-registry columns (effective balances,
participation flags, epochs) and produces whole-registry balance vectors.
Feeding those through the per-element view protocol costs O(n) Python
object churn per epoch; these helpers move data between numpy arrays and
the persistent Merkle backing directly at chunk granularity.

The reference has no analogue — its spec loops per validator (e.g.
process_rewards_and_penalties, phase0/beacon-chain.md:1439-1561); this
module is the seam that lets the compiled spec keep identical semantics
while the state transfer runs at memcpy speed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .node import (
    BranchNode,
    Node,
    PackedLazySubtree,
    ZERO_HASHES,
    pack_chunks,
    subtree_fill_to_contents,
    uint_to_leaf,
    zero_node,
)
from .types import _collect_leaf_roots


def _packed_to_numpy(view, elem_bytes: int, np_dtype: str) -> np.ndarray:
    cls = type(view)
    node = view.get_backing()  # flush pending writes
    contents = node.left if cls.IS_LIST else node
    n = len(view)
    per_chunk = 32 // elem_bytes
    n_chunks = (n + per_chunk - 1) // per_chunk
    data = b"".join(_collect_leaf_roots(contents, cls.contents_depth(), n_chunks))
    return np.frombuffer(data, dtype=np_dtype)[:n]


def packed_lazy_contents(data: bytes, contents_depth: int) -> Node:
    """Contents node for a freshly bulk-written packed subtree: the dense
    power-of-two region is a ``PackedLazySubtree`` (eager level-loop root,
    children materialized only on demand), the zero spine above carries
    eagerly folded roots — a whole-column write costs one vectorized hash
    pass instead of ~n/32 leaf nodes plus a wave re-merkleization."""
    import hashlib

    n_chunks = (len(data) + 31) // 32
    if n_chunks == 0 or not any(data):
        return zero_node(contents_depth)
    dense_depth = (n_chunks - 1).bit_length()
    if dense_depth == 0:
        node: Node = pack_chunks(data)[0]
    else:
        node = PackedLazySubtree(data, dense_depth)
    root = node._root
    for d in range(dense_depth, contents_depth):
        parent = BranchNode(node, zero_node(d))
        root = parent._root = hashlib.sha256(root + ZERO_HASHES[d]).digest()
        node = parent
    return node


def _set_packed_from_numpy(view, arr: np.ndarray, lazy: bool = False) -> None:
    cls = type(view)
    if cls.IS_LIST:
        if len(arr) > cls.LENGTH:
            raise ValueError(f"{len(arr)} exceeds list limit {cls.LENGTH}")
    elif len(arr) != cls.LENGTH:
        raise ValueError(f"vector needs exactly {cls.LENGTH} elements")
    if lazy:
        contents = packed_lazy_contents(arr.tobytes(), cls.contents_depth())
    else:
        contents = subtree_fill_to_contents(
            pack_chunks(arr.tobytes()), cls.contents_depth()
        )
    backing = (
        BranchNode(contents, uint_to_leaf(len(arr))) if cls.IS_LIST else contents
    )
    # install fresh backing; drop any materialized value cache
    view._values = None
    view._dirty_chunks = set()
    view._backing = backing
    view._length = len(arr) if cls.IS_LIST else cls.LENGTH
    view._invalidate()  # parent (e.g. the BeaconState container) sees the change


def packed_uint64_to_numpy(view) -> np.ndarray:
    """List/Vector[uint64, N] -> int64 numpy array (values < 2^63 assumed,
    which Gwei balances satisfy by orders of magnitude)."""
    return _packed_to_numpy(view, 8, "<u8").astype(np.int64)


def set_packed_uint64_from_numpy(view, arr: np.ndarray) -> None:
    """Replace the full contents of a packed uint64 List/Vector in one
    bottom-up rebuild, preserving view/parent dirty-tracking semantics."""
    _set_packed_from_numpy(view, np.ascontiguousarray(arr, dtype="<u8"))


def packed_uint8_to_numpy(view) -> np.ndarray:
    """List/Vector[uint8, N] (e.g. altair participation flags) -> uint8."""
    return _packed_to_numpy(view, 1, np.uint8).copy()


def set_packed_uint8_from_numpy(view, arr: np.ndarray) -> None:
    """uint8 columns take the lazy-subtree write: participation flags are
    rewritten once per block and their subtree ROOT is always consumed by
    the next state-root check, while their chunk nodes are read back only
    on a resident-store miss — the eager-root/lazy-children split is
    exactly that access pattern.  (uint64 balance writes stay node-built:
    epoch processing rewrites them several times between root reads, so
    an eager root per write would hash MORE, not less.)"""
    _set_packed_from_numpy(
        view, np.ascontiguousarray(arr, dtype=np.uint8), lazy=True)


def bitlist_to_numpy(bits) -> np.ndarray:
    """Bool column of a ``Bitlist``/``Bitvector`` view (the per-bit view
    protocol costs a Python object per member; attestation batching reads
    whole aggregation-bit columns)."""
    inner = getattr(bits, "_bits", None)
    if inner is not None:  # the in-repo bit views hold a plain bool list
        return np.asarray(inner, dtype=bool)
    return np.fromiter(bits, dtype=bool, count=len(bits))


def composite_subtrees(view) -> list:
    """The backing subtree node of each element of a List/Vector of
    composites, left to right (no hashing is triggered)."""
    cls = type(view)
    node = view.get_backing()
    contents = node.left if cls.IS_LIST else node
    n = len(view)
    out: list = []
    if n == 0:
        return out
    stack = [(contents, cls.contents_depth())]
    while stack and len(out) < n:
        nd, d = stack.pop()
        if d == 0:
            out.append(nd)
            continue
        stack.append((nd.right, d - 1))
        stack.append((nd.left, d - 1))
    return out


def _field_path(field_index: int, depth: int):
    """Descent path (True=right) for a field at the given container depth."""
    return [bool((field_index >> (depth - 1 - b)) & 1) for b in range(depth)]


def _walk(node: Node, path) -> Node:
    for go_right in path:
        node = node.right if go_right else node.left
    return node


# --- validator registry columns ---------------------------------------------

# epoch-processing columns (phase0/beacon-chain.md Validator container; later
# forks may append fields — e.g. the early capella draft's
# fully_withdrawn_epoch — so paths are derived from the element class layout)
_V_FIELDS_U64 = (
    "effective_balance",
    "activation_eligibility_epoch",
    "activation_epoch",
    "exit_epoch",
    "withdrawable_epoch",
)


def validator_pubkeys(validators) -> list:
    """One walk over the registry subtrees -> every validator's pubkey as
    raw 48-byte strings.  The per-index view path
    (``state.validators[i].pubkey``) costs a tree descent + view
    materialization per read; attestation verification reads ~25k pubkeys
    per block, which makes this column the cheap representation."""
    et = type(validators).ELEM_TYPE
    path = _field_path(et._field_index["pubkey"], et._depth)
    out = []
    for sub in composite_subtrees(validators):
        node = _walk(sub, path)
        # Bytes48 backing: Branch(chunk0, chunk1) with 16 zero tail bytes
        out.append(node.left._root + node.right._root[:16])
    return out


class RootKeyedCache:
    """FIFO cache keyed by a view's tree root: any mutation produces a new
    root, so invalidation is automatic.  THE shared memoizer for derived
    registry representations (pubkey column here, numeric columns in
    ops/epoch_jax.registry_columns)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._store: Dict[bytes, object] = {}

    def get(self, view, build, on_insert=None):
        """Cached value for ``view``; on a miss, builds and inserts.
        ``on_insert(store, root)`` fires after a fresh insert — the stf
        cache transaction uses it to record the insert for rollback."""
        root = bytes(view.hash_tree_root())
        hit = self._store.get(root)
        if hit is None:
            if len(self._store) >= self.capacity:
                self._store.pop(next(iter(self._store)))
            hit = build(view)
            self._store[root] = hit
            if on_insert is not None:
                on_insert(self._store, root)
        return hit


# 2 entries cover the pre/post-epoch registries a transition touches
_PUBKEY_CACHE = RootKeyedCache(2)


def cached_validator_pubkeys(validators) -> list:
    return _PUBKEY_CACHE.get(validators, validator_pubkeys)


_PUBKEY_INDEX_CACHE = RootKeyedCache(2)


def cached_pubkey_index(validators) -> Dict[bytes, int]:
    """pubkey bytes -> FIRST validator index carrying it (list.index
    semantics, which is what the altair sync-committee reward loop's
    ``all_pubkeys.index(pubkey)`` resolves to on duplicate keys)."""

    def build(v):
        index_of: Dict[bytes, int] = {}
        for i, pk in enumerate(cached_validator_pubkeys(v)):
            index_of.setdefault(pk, i)
        return index_of

    return _PUBKEY_INDEX_CACHE.get(validators, build)


def validator_columns(validators) -> Dict[str, np.ndarray]:
    """One walk over the registry subtrees -> all epoch-processing columns.

    Field paths come from the element class's own layout (field count sets
    the tree depth).  Saturates epochs at int64 max (FAR_FUTURE_EPOCH =
    2^64-1 would wrap)."""
    et = type(validators).ELEM_TYPE
    depth = et._depth
    findex = et._field_index
    subs = composite_subtrees(validators)
    n = len(subs)
    cols: Dict[str, np.ndarray] = {}
    u64_paths = {
        name: _field_path(findex[name], depth) for name in _V_FIELDS_U64
    }
    slashed_path = _field_path(findex["slashed"], depth)
    raw = {name: bytearray() for name in u64_paths}
    slashed = np.zeros(n, dtype=bool)
    for i, sub in enumerate(subs):
        for name, path in u64_paths.items():
            raw[name] += _walk(sub, path)._root[:8]
        slashed[i] = _walk(sub, slashed_path)._root[0] != 0
    for name, buf in raw.items():
        u = np.frombuffer(bytes(buf), dtype="<u8")
        cols[name] = np.minimum(u, np.uint64(2**63 - 1)).astype(np.int64)
    cols["slashed"] = slashed
    return cols
