"""Flat proto-array LMD-GHOST.

The spec's ``get_head`` (specs/src/phase0.py:1490) re-walks the block
tree and re-sums every validator's latest message on every call —
O(blocks × validators) per head query.  Production clients replaced that
with a *proto-array*: blocks in an append-only flat array with parent
indices, per-node subtree weights maintained incrementally from vote
deltas, so a head query is one O(blocks) pass and ingesting a vote batch
is one segment-sum plus one reverse scan.

Behavioral pin: ``find_head`` reproduces the spec walk *exactly* —

* viability is evaluated at leaves only (``filter_block_tree`` checks the
  leaf state's justified/finalized checkpoints against the store's) and
  propagated to ancestors, not re-checked per node as some clients do;
* a vote for block X counts toward node R iff R is an ancestor-or-self of
  X (the ``get_ancestor(X, R.slot) == R`` condition collapses to subtree
  membership because slots strictly increase along a chain), which is
  exactly the incremental subtree-weight invariant;
* proposer boost is added to a child during the walk iff the child lies
  on the boost root's ancestor chain;
* ties break on the lexicographically larger root.

The node axis (blocks) stays in Python — it is small and append-only.
The validator axis (400k+) is the vectorized one: votes and balances are
dense int64 arrays and every delta reduction goes through
``ops/segment.py``.  Equivalence with the spec ``Store`` is pinned by
tests/test_torch_forkchoice.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from consensus_specs_tpu_torch.ops.segment import segment_sum

Checkpoint = Tuple[int, bytes]  # (epoch, root) snapshot, hashable + comparable


class ProtoArray:
    """Append-only block array with incrementally maintained LMD weights."""

    def __init__(self) -> None:
        self.indices: Dict[bytes, int] = {}
        self.roots: List[object] = []        # node -> Root (spec object)
        self.parents: List[int] = []         # node -> parent index or -1
        self.slots: List[int] = []
        self.justified: List[Checkpoint] = []  # block state's checkpoints
        self.finalized: List[Checkpoint] = []
        self.children: List[List[int]] = []
        self.weights: List[int] = []         # attestation subtree weights
        # validator axis (dense, grown on demand)
        self.vote_node = np.empty(0, dtype=np.int64)   # -1 = no message
        self.vote_epoch = np.empty(0, dtype=np.int64)
        self.balances = np.empty(0, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.roots)

    def __contains__(self, root) -> bool:
        return bytes(root) in self.indices

    def ensure_validators(self, n: int) -> None:
        if n <= len(self.vote_node):
            return
        grow = n - len(self.vote_node)
        self.vote_node = np.concatenate(
            [self.vote_node, np.full(grow, -1, dtype=np.int64)])
        self.vote_epoch = np.concatenate(
            [self.vote_epoch, np.zeros(grow, dtype=np.int64)])
        self.balances = np.concatenate(
            [self.balances, np.zeros(grow, dtype=np.int64)])

    # -- block axis ----------------------------------------------------------

    def insert(self, root, parent_root, slot: int,
               justified: Checkpoint, finalized: Checkpoint) -> int:
        """Append a block node; parents must be inserted before children
        (guaranteed by ``on_block``'s parent-known assert), so a child's
        index is always greater than its parent's."""
        key = bytes(root)
        if key in self.indices:
            return self.indices[key]
        idx = len(self.roots)
        self.indices[key] = idx
        self.roots.append(root)
        self.parents.append(self.indices.get(bytes(parent_root), -1))
        self.slots.append(int(slot))
        self.justified.append(justified)
        self.finalized.append(finalized)
        self.children.append([])
        self.weights.append(0)
        if self.parents[idx] != -1:
            self.children[self.parents[idx]].append(idx)
        return idx

    def node_index(self, root) -> int:
        """Index of ``root``, or -1 when unknown/pruned (a vote there can
        never influence a head walk rooted under the finalized block)."""
        return self.indices.get(bytes(root), -1)

    # -- weight maintenance --------------------------------------------------

    def _apply_deltas(self, deltas: np.ndarray) -> None:
        """One reverse scan: each node absorbs its delta and forwards it to
        its parent — children always have larger indices, so a single
        descending pass settles every subtree sum."""
        acc = deltas.astype(object)  # python ints: no int64 overflow window
        weights, parents = self.weights, self.parents
        for i in range(len(weights) - 1, -1, -1):
            d = acc[i]
            if d:
                weights[i] += d
                p = parents[i]
                if p != -1:
                    acc[p] += d
    # -- vote ingestion ------------------------------------------------------

    def apply_vote_changes(self, validators: np.ndarray,
                           new_nodes: np.ndarray,
                           new_epochs: np.ndarray) -> None:
        """Move each validator's latest message to ``new_nodes`` (index -1 =
        vote for an unknown/pruned block, tracked but weightless) and update
        subtree weights by the balance deltas (one segment-sum per side)."""
        if len(validators) == 0:
            return
        n_nodes = len(self.roots)
        deltas = np.zeros(n_nodes, dtype=np.int64)
        old_nodes = self.vote_node[validators]
        bal = self.balances[validators]
        rem = old_nodes >= 0
        if rem.any():
            deltas -= segment_sum(bal[rem], old_nodes[rem], n_nodes)
        add = new_nodes >= 0
        if add.any():
            deltas += segment_sum(bal[add], new_nodes[add], n_nodes)
        self.vote_node[validators] = new_nodes
        self.vote_epoch[validators] = new_epochs
        self._apply_deltas(deltas)

    def clear_votes(self, validators: np.ndarray) -> None:
        """Equivocation discard: remove the validators' weight and bar the
        slots from ever re-entering the walk (mirror of the spec excluding
        ``equivocating_indices`` from ``get_latest_attesting_balance``)."""
        if len(validators) == 0:
            return
        n_nodes = len(self.roots)
        old_nodes = self.vote_node[validators]
        bal = self.balances[validators]
        rem = old_nodes >= 0
        if rem.any():
            self._apply_deltas(-segment_sum(bal[rem], old_nodes[rem], n_nodes))
        self.vote_node[validators] = -1

    def set_balances(self, balances: np.ndarray) -> None:
        """Swap in the justified-checkpoint state's effective balances and
        rebuild every subtree weight from the standing votes (justified
        changes are rare — at most once per epoch)."""
        self.ensure_validators(len(balances))
        self.balances[:len(balances)] = balances
        self.balances[len(balances):] = 0
        n_nodes = len(self.roots)
        voted = self.vote_node >= 0
        own = segment_sum(self.balances[voted], self.vote_node[voted], n_nodes) \
            if voted.any() else np.zeros(n_nodes, dtype=np.int64)
        self.weights = [0] * n_nodes
        self._apply_deltas(own)

    # -- head selection ------------------------------------------------------

    def _viable(self, store_justified: Checkpoint,
                store_finalized: Checkpoint, genesis_epoch: int) -> List[bool]:
        """Spec ``filter_block_tree`` flags: a leaf is viable iff its block
        state agrees with the store's justified/finalized checkpoints (or
        those are still at genesis); an interior node is viable iff any
        descendant leaf is."""
        n = len(self.roots)
        viable = [False] * n
        check_j = store_justified[0] != genesis_epoch
        check_f = store_finalized[0] != genesis_epoch
        for i in range(n - 1, -1, -1):
            kids = self.children[i]
            if kids:
                viable[i] = any(viable[c] for c in kids)
            else:
                viable[i] = (
                    (not check_j or self.justified[i] == store_justified)
                    and (not check_f or self.finalized[i] == store_finalized))
        return viable

    def _boost_path(self, boost_root: bytes) -> set:
        """Indices on the proposer-boost root's ancestor chain (the nodes
        the spec credits the boost to during the walk)."""
        idx = self.indices.get(boost_root, -1)
        path = set()
        while idx != -1:
            path.add(idx)
            idx = self.parents[idx]
        return path

    def find_head(self, justified_root, store_justified: Checkpoint,
                  store_finalized: Checkpoint, genesis_epoch: int,
                  boost_root: Optional[bytes] = None,
                  boost_score: int = 0):
        """The spec head walk over the flat array: start at the justified
        root, repeatedly descend to the viable child maximizing
        ``(weight + boost, root)``; O(blocks) total."""
        start = self.indices.get(bytes(justified_root))
        assert start is not None, "justified root missing from proto-array"
        viable = self._viable(store_justified, store_finalized, genesis_epoch)
        boosted = self._boost_path(boost_root) if boost_root and boost_score \
            else set()
        head = start
        while True:
            best = -1
            best_key = None
            for c in self.children[head]:
                if not viable[c]:
                    continue
                score = self.weights[c] + (boost_score if c in boosted else 0)
                key = (score, bytes(self.roots[c]))
                if best == -1 or key > best_key:
                    best, best_key = c, key
            if best == -1:
                return self.roots[head]
            head = best

    # -- pruning -------------------------------------------------------------

    def prune(self, finalized_root) -> int:
        """Drop every node outside the finalized root's subtree and remap.
        Kept weights are untouched: a vote for a dropped node only ever
        contributed to dropped subtrees (the finalized root's own subtree
        never contains a dropped descendant).  Returns nodes dropped."""
        fin = self.indices.get(bytes(finalized_root))
        assert fin is not None, "finalized root missing from proto-array"
        if fin == 0 and self.parents[0] == -1:
            return 0
        n = len(self.roots)
        keep = [False] * n
        keep[fin] = True
        for i in range(fin + 1, n):
            p = self.parents[i]
            keep[i] = p != -1 and keep[p]
        remap = np.full(n, -1, dtype=np.int64)
        kept = [i for i in range(n) if keep[i]]
        for new, old in enumerate(kept):
            remap[old] = new
        self.roots = [self.roots[i] for i in kept]
        self.slots = [self.slots[i] for i in kept]
        self.justified = [self.justified[i] for i in kept]
        self.finalized = [self.finalized[i] for i in kept]
        self.weights = [self.weights[i] for i in kept]
        self.parents = [
            int(remap[self.parents[i]]) if self.parents[i] != -1 else -1
            for i in kept]
        self.children = [
            [int(remap[c]) for c in self.children[i] if remap[c] != -1]
            for i in kept]
        self.indices = {bytes(r): i for i, r in enumerate(self.roots)}
        voted = self.vote_node >= 0
        self.vote_node[voted] = remap[self.vote_node[voted]]
        return n - len(kept)
