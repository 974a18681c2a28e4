"""Persistent (structurally shared) binary Merkle tree nodes.

This is the remerkleable-equivalent backing layer (reference seam:
eth2spec/utils/ssz/ssz_impl.py:8-13 routes ``hash_tree_root`` through
``View.get_backing().merkle_root()``).  Key properties kept from the
reference design, because the test framework's zero-copy state cache
depends on them (reference: eth2spec/test/context.py:105-125):

  * nodes are immutable; updates copy the path from root to leaf
  * every node memoizes its Merkle root, so unchanged subtrees are never
    re-hashed (incremental ``hash_tree_root``)
  * zero-subtrees of every depth are globally shared singletons

Device-first difference: root computation is *layer-batched*.  Instead of
recursive child-then-parent hashing, all unhashed nodes are collected and
hashed in ready-waves through ``hashing.hash_layer`` — one device dispatch
per tree level — so a dirty 400k-validator registry becomes a handful of
large SHA-256 batches instead of ~10^5 single hashes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .hashing import ZERO_HASHES, hash_layer


class Node:
    __slots__ = ("_root",)


class LeafNode(Node):
    __slots__ = ()

    def __init__(self, root: bytes):
        assert len(root) == 32
        self._root = root

    @property
    def root(self) -> bytes:
        return self._root

    def __repr__(self) -> str:
        return f"Leaf({self._root.hex()[:16]})"


class BranchNode(Node):
    __slots__ = ("left", "right")

    def __init__(self, left: Node, right: Node):
        self.left = left
        self.right = right
        self._root: Optional[bytes] = None

    def __repr__(self) -> str:
        return f"Branch(root={'?' if self._root is None else self._root.hex()[:16]})"


ZERO_LEAF = LeafNode(b"\x00" * 32)

# zero_node(d): root of a fully-zero subtree of depth d, globally shared.
_ZERO_NODES: List[Node] = [ZERO_LEAF]
for _d in range(1, 64):
    _b = BranchNode(_ZERO_NODES[-1], _ZERO_NODES[-1])
    _b._root = ZERO_HASHES[_d]
    _ZERO_NODES.append(_b)


def zero_node(depth: int) -> Node:
    return _ZERO_NODES[depth]


def merkle_root(node: Node) -> bytes:
    """Compute (and memoize) the root, hashing whole ready-waves at once."""
    if node._root is not None:
        return node._root
    # Collect every unhashed branch reachable from `node` (deduped: the tree
    # is a DAG under structural sharing).
    pending: List[BranchNode] = []
    seen = set()
    stack: List[Node] = [node]
    while stack:
        n = stack.pop()
        if n._root is not None or id(n) in seen:
            continue
        seen.add(id(n))
        pending.append(n)  # type: ignore[arg-type]
        if n.left._root is None:  # type: ignore[union-attr]
            stack.append(n.left)  # type: ignore[union-attr]
        if n.right._root is None:  # type: ignore[union-attr]
            stack.append(n.right)  # type: ignore[union-attr]
    # Topological ready-waves: a node is ready once both children have
    # roots or are scheduled in an earlier wave.
    waves: List[List[BranchNode]] = []
    scheduled = set()
    rest = pending
    while rest:
        ready: List[BranchNode] = []
        later: List[BranchNode] = []
        for n in rest:
            if ((n.left._root is not None or id(n.left) in scheduled)
                    and (n.right._root is not None or id(n.right) in scheduled)):
                ready.append(n)
            else:
                later.append(n)
        for n in ready:
            scheduled.add(id(n))
        waves.append(ready)
        rest = later

    for wave in waves:
        digests = hash_layer([n.left._root + n.right._root for n in wave])
        for n, d in zip(wave, digests):
            n._root = d
    return node._root  # type: ignore[return-value]


def branch_with_root(left: Node, right: Node, root: bytes) -> BranchNode:
    """A ``BranchNode`` with its memoized root pre-installed — the
    deserialization constructor (persist/store.py's tree codec rebuilds
    checkpointed states from digest-verified artifacts; recomputing
    every root would re-pay the full-tree hash the memo exists to skip).
    Owner-side on purpose: installing ``_root`` anywhere else is a CC01
    violation, because only a verified byte stream may vouch for it."""
    node = BranchNode(left, right)
    node._root = root
    return node


def get_subtree(node: Node, depth: int, index: int) -> Node:
    """Descend `depth` levels; bit k of `index` (MSB first) picks the child."""
    for k in range(depth - 1, -1, -1):
        assert isinstance(node, BranchNode), "descended past a leaf"
        node = node.right if (index >> k) & 1 else node.left
    return node


def with_subtree(node: Node, depth: int, index: int, subtree: Node) -> Node:
    """Return a new tree with the subtree at (depth, index) replaced (path copy)."""
    if depth == 0:
        return subtree
    assert isinstance(node, BranchNode)
    bit = (index >> (depth - 1)) & 1
    if bit:
        return BranchNode(node.left, with_subtree(node.right, depth - 1, index, subtree))
    return BranchNode(with_subtree(node.left, depth - 1, index, subtree), node.right)


def with_updated_subtrees(
    node: Node, depth: int, updates: Sequence[Tuple[int, Node]]
) -> Node:
    """Bulk path-copy update: `updates` is a sorted list of (index, subtree).

    Untouched subtrees are returned by identity, preserving their memoized
    roots — this is what keeps epoch-boundary registry updates incremental.
    """
    if not updates:
        return node
    if depth == 0:
        assert len(updates) == 1
        return updates[0][1]
    half = 1 << (depth - 1)
    split = 0
    while split < len(updates) and updates[split][0] < half:
        split += 1
    left_updates = updates[:split]
    right_updates = [(i - half, n) for i, n in updates[split:]]
    if isinstance(node, BranchNode):
        left, right = node.left, node.right
    else:
        raise AssertionError("descended past a leaf")
    new_left = with_updated_subtrees(left, depth - 1, left_updates) if left_updates else left
    new_right = (
        with_updated_subtrees(right, depth - 1, right_updates) if right_updates else right
    )
    if new_left is left and new_right is right:
        return node
    return BranchNode(new_left, new_right)


class PackedLazySubtree(BranchNode):
    """A packed subtree held as raw bytes with an EAGER root and LAZY
    children — the tree half of the resident-column contract
    (stf/columns.py): per-block bulk writes of a whole packed column
    (participation flags are the canonical case) need the subtree's ROOT
    at the next state-root check, but its ~n/32 chunk nodes only if some
    later consumer actually descends — and the resident column store
    answers almost every read before the tree is touched.  The root comes
    from one vectorized hashlib level-loop over the raw bytes (~2x the
    node-layer wave hash, with zero node churn); ``left``/``right``
    materialize on first access (a per-element read, an SSZ encode, a
    path-copy write landing inside the subtree) and recursively stay
    lazy, so a single-leaf descent builds one path, not the whole tree.

    Instances are immutable like every node: ``_data`` is private bytes,
    children memoize, and the eager ``_root`` makes ``merkle_root`` a
    field read."""

    __slots__ = ("_data", "_depth", "_l", "_r")

    def __init__(self, data: bytes, depth: int, root: bytes = None):
        self._data = data
        self._depth = depth
        self._l = self._r = None
        self._root = root if root is not None else packed_subtree_root(
            data, depth)

    @property
    def left(self) -> Node:
        if self._l is None:
            self._l = self._child(0)
        return self._l

    @property
    def right(self) -> Node:
        if self._r is None:
            self._r = self._child(1)
        return self._r

    def _child(self, side: int) -> Node:
        d = self._depth - 1
        half = 32 << d  # bytes per half subtree
        data = self._data[side * half: (side + 1) * half]
        if not any(data):
            return zero_node(d)
        if d == 0:
            return LeafNode(data.ljust(32, b"\x00"))
        return PackedLazySubtree(data, d)

    def leaf_roots(self, count: int) -> List[bytes]:
        """First ``count`` chunk roots straight off the raw bytes — the
        bulk-unpack shortcut (ssz/types._collect_leaf_roots)."""
        data = self._data
        need = count * 32
        if len(data) < need:
            data = data.ljust(need, b"\x00")
        return [data[i: i + 32] for i in range(0, need, 32)]


def packed_subtree_root(data: bytes, depth: int) -> bytes:
    """Root of a depth-``depth`` subtree whose leading chunks are ``data``
    (zero chunks beyond): one hashlib level-loop over contiguous buffers,
    folding the all-zero tail with the shared zero hashes instead of
    hashing it."""
    from hashlib import sha256

    n_chunks = (len(data) + 31) // 32
    assert n_chunks <= (1 << depth)
    if n_chunks == 0 or not any(data):
        return ZERO_HASHES[depth]
    if len(data) % 32:
        data = data + b"\x00" * (32 - len(data) % 32)
    level = data
    for d in range(depth):
        if (len(level) // 32) & 1:
            level += ZERO_HASHES[d]
        level = b"".join(
            sha256(level[i: i + 64]).digest()
            for i in range(0, len(level), 64))
    return level


def subtree_fill_to_contents(nodes: Sequence[Node], depth: int) -> Node:
    """Build a depth-`depth` subtree whose first len(nodes) leaves are `nodes`,
    zero-padded on the right (shared zero subtrees)."""
    n = len(nodes)
    assert n <= (1 << depth)
    if n == 0:
        return zero_node(depth)
    if depth == 0:
        return nodes[0]
    layer: List[Node] = list(nodes)
    for d in range(depth):
        odd = len(layer) & 1
        pairs = len(layer) >> 1
        nxt: List[Node] = [BranchNode(layer[2 * i], layer[2 * i + 1]) for i in range(pairs)]
        if odd:
            nxt.append(BranchNode(layer[-1], zero_node(d)))
        layer = nxt
    assert len(layer) == 1
    return layer[0]


def pack_chunks(data: bytes) -> List[LeafNode]:
    """Split serialized bytes into zero-padded 32-byte chunk leaves."""
    if len(data) % 32:
        data = data + b"\x00" * (32 - len(data) % 32)
    return [LeafNode(data[i : i + 32]) for i in range(0, len(data), 32)]


def uint_to_leaf(value: int) -> LeafNode:
    return LeafNode(value.to_bytes(32, "little"))
