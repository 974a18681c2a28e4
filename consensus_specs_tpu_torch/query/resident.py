"""Store-backed eviction for materialized states.

The resident set is the only place a materialized historical state
lives: a bounded LRU keyed by state root.  Spilling an entry is FREE —
the mmap'd artifact is the source of truth, so eviction just drops the
reference — and a miss re-faults lazily through the engine's decode
path (``persist.refault`` is the chaos probe on that seam).  A refault
is only admitted if the decoded state's root equals the requested key
(memoized from the stream — a field read), so an injected fault or a
rotten artifact can fail a query but can never leave the set
incoherent.

Not a lock owner: the engine calls every method under its own lock
(declared via ``lock_holders`` in the concurrency registry).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.persist.store import CheckpointError

from . import stats

_SITE_REFAULT = faults.site("persist.refault")


class ResidentStates:
    """Bounded root-keyed LRU of materialized window states."""

    def __init__(self, cap: int = 2):
        if cap < 1:
            raise ValueError(f"resident cap must be >= 1, got {cap}")
        self._cap = cap
        self._states: "OrderedDict[bytes, object]" = OrderedDict()

    @property
    def cap(self) -> int:
        return self._cap

    def size(self) -> int:
        return len(self._states)

    def roots(self):
        return list(self._states)

    def get(self, root: bytes, loader: Callable):
        """The resident state for ``root``, re-faulting through
        ``loader`` on a miss.  The entry lands only after the coherence
        check — a loader that raises (the refault probe, a damaged
        artifact) leaves the set exactly as it was."""
        root = bytes(root)
        state = self._states.get(root)
        if state is not None:
            self._states.move_to_end(root)
            return state
        _SITE_REFAULT()
        stats["refaults"] += 1
        state = loader()
        if bytes(state.hash_tree_root()) != root:
            raise CheckpointError(
                "refaulted state root mismatch: artifact served the "
                "wrong tree")
        self._states[root] = state
        while len(self._states) > self._cap:
            self._states.popitem(last=False)
            stats["spills"] += 1
        return state

    def clear(self) -> None:
        """Drop every resident state (the registered CC01 invalidation;
        entries rebuild lazily and honestly through ``get``)."""
        self._states.clear()
