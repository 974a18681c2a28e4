"""Merkle proofs straight off the ``encode_tree`` stream.

``persist/store.py`` serializes window states as root-deduped subtree
streams: LEAF/ZERO/PACKED/BRANCH records with every root written inline
and REF records pointing backward into the shared emission order.  That
layout means a proof does not need the state at all — one linear parse
turns the stream into an **entry table** of offsets (no node objects,
no root copies), and a generalized-index walk descends entry to entry
reading sibling roots out of the buffer, synthesizing the only roots
the stream omits (packed interiors, zero subtrees) from the raw bytes.
The buffer can be (and in the engine is) the live mmap of a verified
artifact: proving one validator out of a 400k registry touches a few
pages, never the registry.

Entry kinds (tuples, index-aligned with ``encode_tree``'s dedup order
so REFs resolve by table position):

* ``(LEAF, root_off)`` — 32 content bytes at ``root_off``;
* ``(ZERO, depth)`` — the shared zero subtree;
* ``(PACKED, depth, data_off, data_len, root_off)`` — a packed column's
  raw bytes; descent halves the byte range exactly like
  ``PackedLazySubtree._child`` and hashes sibling halves with
  ``packed_subtree_root``;
* ``(BRANCH, root_off, left_id, right_id)`` — root plus child entries.

Proof ordering matches ``ssz.gindex.build_proof`` byte for byte:
sibling hashes leaf-side first, verifiable with ``verify_proof`` (the
``is_valid_merkle_branch`` fold) against the stored root.
"""
from __future__ import annotations

from hashlib import sha256
from typing import List, Optional, Tuple

from consensus_specs_tpu_torch.persist.store import CheckpointError
from consensus_specs_tpu_torch.ssz.hashing import ZERO_HASHES
from consensus_specs_tpu_torch.ssz.node import packed_subtree_root

_TAG_LEAF = 0x01
_TAG_ZERO = 0x02
_TAG_PACKED = 0x03
_TAG_BRANCH = 0x04
_TAG_REF = 0x05

LEAF = 0
ZERO = 1
PACKED = 2
BRANCH = 3


def parse_tree(buf, off: int, entries: List[Optional[tuple]]) -> Tuple[int, int]:
    """Parse one tree from ``buf`` at ``off`` into ``entries`` (the
    shared REF table, same emission order as ``encode_tree``'s index);
    returns ``(entry_id, next_off)``.  Structure only — no node objects,
    no root copies; a malformed stream raises ``CheckpointError`` (one
    more rung of the corruption ladder, never a crash)."""
    tag = buf[off]
    off += 1
    if tag == _TAG_REF:
        ref = int.from_bytes(buf[off:off + 4], "little")
        if ref >= len(entries) or entries[ref] is None:
            raise CheckpointError(f"forward tree ref {ref}")
        return ref, off + 4
    slot = len(entries)
    entries.append(None)
    if tag == _TAG_ZERO:
        entry = (ZERO, buf[off])
        off += 1
    elif tag == _TAG_LEAF:
        entry = (LEAF, off)
        off += 32
    elif tag == _TAG_PACKED:
        depth = buf[off]
        n = int.from_bytes(buf[off + 1:off + 9], "little")
        off += 9
        entry = (PACKED, depth, off, n, off + n)
        off += n + 32
    elif tag == _TAG_BRANCH:
        root_off = off
        off += 32
        left, off = parse_tree(buf, off, entries)
        right, off = parse_tree(buf, off, entries)
        entry = (BRANCH, root_off, left, right)
    else:
        raise CheckpointError(f"unknown tree tag {tag:#x} at {off - 1}")
    if off > len(buf):
        raise CheckpointError("tree stream truncated")
    entries[slot] = entry
    return slot, off


def entry_root(buf, entries: List[tuple], entry_id: int) -> bytes:
    """The 32-byte root of ``entry_id``, read (not computed) from the
    stream — integrity is the artifact digest's job."""
    e = entries[entry_id]
    kind = e[0]
    if kind == ZERO:
        return ZERO_HASHES[e[1]]
    if kind == LEAF:
        return bytes(buf[e[1]:e[1] + 32])
    if kind == PACKED:
        return bytes(buf[e[4]:e[4] + 32])
    return bytes(buf[e[1]:e[1] + 32])  # BRANCH


# -- descent cursors -----------------------------------------------------------
#
# Proofs walk VIRTUAL nodes: an entry, or a position inside a packed
# byte region, or a zero subtree — ('e', id) | ('p', depth, start, len)
# | ('z', depth).  Packed halving mirrors PackedLazySubtree._child.


def _children(buf, entries, cur):
    kind = cur[0]
    if kind == "e":
        e = entries[cur[1]]
        ek = e[0]
        if ek == BRANCH:
            return ("e", e[2]), ("e", e[3])
        if ek == ZERO:
            d = e[1] - 1
            return ("z", d), ("z", d)
        if ek == PACKED:
            return _packed_children(e[1], e[2], e[3])
        raise CheckpointError("proof path descends past a leaf")
    if kind == "z":
        d = cur[1] - 1
        if d < 0:
            raise CheckpointError("proof path descends past a leaf")
        return ("z", d), ("z", d)
    # packed region
    return _packed_children(cur[1], cur[2], cur[3])


def _packed_children(depth, start, length):
    d = depth - 1
    if d < 0:
        raise CheckpointError("proof path descends past a leaf")
    half = 32 << d
    left = ("p", d, start, min(length, half))
    right_len = length - half
    right = ("p", d, start + half, right_len) if right_len > 0 else ("z", d)
    return left, right


def _cursor_root(buf, cur) -> bytes:
    kind = cur[0]
    if kind == "z":
        return ZERO_HASHES[cur[1]]
    # packed region: synthesize the root from the raw bytes (the stream
    # only stores the region's TOP root); all-zero folds to ZERO_HASHES
    # inside packed_subtree_root
    _k, d, start, length = cur
    if length <= 0:
        return ZERO_HASHES[d]
    return packed_subtree_root(bytes(buf[start:start + length]), d)


def _resolve_root(buf, entries, cur) -> bytes:
    if cur[0] == "e":
        return entry_root(buf, entries, cur[1])
    return _cursor_root(buf, cur)


def node_root_at(buf, entries, root_id: int, gindex: int) -> bytes:
    """Root of the node addressed by ``gindex`` under entry ``root_id``.
    For chunk-level gindices this IS the chunk's 32 content bytes (a
    leaf's root is its content; a depth-0 packed slice pads raw data) —
    the balance/status read path."""
    depth = gindex.bit_length() - 1
    index = gindex - (1 << depth)
    cur = ("e", root_id)
    for k in range(depth - 1, -1, -1):
        left, right = _children(buf, entries, cur)
        cur = right if (index >> k) & 1 else left
    return _resolve_root(buf, entries, cur)


def proof_at(buf, entries, root_id: int, gindex: int) -> Tuple[bytes, List[bytes]]:
    """(leaf, branch) for ``gindex`` under entry ``root_id``: the
    addressed node's root plus sibling hashes leaf-side first — exactly
    ``ssz.gindex.build_proof`` over the materialized tree, generated off
    stream offsets instead."""
    depth = gindex.bit_length() - 1
    index = gindex - (1 << depth)
    branch: List[bytes] = []
    cur = ("e", root_id)
    for k in range(depth - 1, -1, -1):
        left, right = _children(buf, entries, cur)
        if (index >> k) & 1:
            branch.append(_resolve_root(buf, entries, left))
            cur = right
        else:
            branch.append(_resolve_root(buf, entries, right))
            cur = left
    return _resolve_root(buf, entries, cur), list(reversed(branch))


def verify_proof(leaf: bytes, branch, gindex: int, root: bytes) -> bool:
    """The ``is_valid_merkle_branch`` fold (leaf-side-first branch):
    True iff ``leaf`` at ``gindex`` plus ``branch`` hashes to ``root``."""
    depth = gindex.bit_length() - 1
    index = gindex - (1 << depth)
    if len(branch) != depth:
        return False
    value = bytes(leaf)
    for k, sib in enumerate(branch):
        sib = bytes(sib)
        if (index >> k) & 1:
            value = sha256(sib + value).digest()
        else:
            value = sha256(value + sib).digest()
    return value == bytes(root)
