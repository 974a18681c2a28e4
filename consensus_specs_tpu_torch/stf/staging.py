"""Block-scoped transactional cache commits for the stf fast path.

The fast path populates process-global memos mid-block (committee
contexts, proposer walks, sync seat rows, affine matrices, the
verified-triple memo).  Before this module, an insert landed the moment
it was computed — so a fault between the insert and the block settling
could strand an entry whose value a corruption fault had just poisoned,
and every later block would consume it (the engine would silently replay
forever, or worse).  The chaos suite (tests/chaos/) makes that scenario
a tested path; this module makes it impossible:

* **visible inserts with an undo log** — caches the block itself re-reads
  (committee contexts are probed per attestation) insert immediately, but
  the owning module records each (cache, key) with ``note_insert``;
  if the block fails, ``rollback`` pops exactly those entries, so a
  failed block leaves every memo as it found it;
* **deferred commits** — inserts nothing re-reads within the block (the
  verified-triple memo keys) are staged with ``defer`` and applied only
  after the block fully settles — including the post-state root check —
  so a triple can never enter the memo on the strength of a block that
  then failed.

The engine opens one transaction per block (``block_transaction`` in
the synchronous path); with no transaction active (literal replays,
direct helper use, tests poking the memos), ``note_insert`` is a no-op
and ``defer`` runs the commit immediately — the memos behave as plain
memos.

**Overlapped pipeline:** the cross-block pipeline keeps block
N's transaction OPEN (verdict outstanding) while block N+1's host phases
run under their own transaction.  The explicit split API —
``begin_block`` / ``deactivate`` / ``commit_block`` / ``rollback_block``
— supports that: ``begin_block`` makes a fresh transaction current,
``deactivate`` detaches it (it stays open, later inserts route to the
successor's transaction), and settlement happens through
``commit_block``/``rollback_block`` on the detached handle.
``commit_block`` runs the deferred queue with NO transaction current, so
a deferred commit's own cache inserts can never leak into the
*successor's* undo log.  ``block_transaction`` is the same machinery as
a context manager.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from consensus_specs_tpu_torch.telemetry import recorder

_TXN: Optional["CacheTransaction"] = None


class CacheTransaction:
    """Undo log for visible inserts + queue of deferred commits, scoped to
    one block of ``apply_signed_blocks``."""

    __slots__ = ("_undo", "_deferred")

    def __init__(self):
        self._undo = []      # (cache_dict, key): pop on rollback
        self._deferred = []  # (fn, args): run on commit

    def note_insert(self, cache: dict, key) -> None:
        self._undo.append((cache, key))

    def defer(self, fn, *args) -> None:
        self._deferred.append((fn, args))

    def commit(self) -> None:
        """Apply deferred commits; on any failure mid-commit, undo the
        block's visible inserts too and re-raise (already-applied deferred
        entries are content-addressed facts — safe to keep)."""
        n_deferred, n_visible = len(self._deferred), len(self._undo)
        try:
            while self._deferred:
                fn, args = self._deferred.pop(0)
                fn(*args)
        except BaseException:
            self.rollback()
            raise
        self._undo.clear()
        # the event fires only after every deferred commit landed — a
        # torn commit takes the rollback branch and logs honestly
        recorder.record("cache_commit", deferred=n_deferred,
                        visible=n_visible)

    def rollback(self) -> None:
        """Pop every visible insert this block made (newest first) and
        drop the deferred queue: the memos read as if the block never
        ran.  Removal-only, so concurrent FIFO evictions stay safe."""
        n_undo, n_deferred = len(self._undo), len(self._deferred)
        while self._undo:
            cache, key = self._undo.pop()
            cache.pop(key, None)
        self._deferred.clear()
        recorder.record("cache_rollback", undone=n_undo,
                        deferred_dropped=n_deferred)


def current() -> Optional[CacheTransaction]:
    return _TXN


def note_insert(cache: dict, key) -> None:
    """Record a visible insert with the active transaction (no-op when
    none is active — non-engine callers keep the old immediate
    semantics)."""
    txn = _TXN
    if txn is not None:
        txn.note_insert(cache, key)


def defer(fn, *args) -> None:
    """Stage a commit for block settlement, or run it now when no
    transaction is active."""
    txn = _TXN
    if txn is not None:
        txn.defer(fn, *args)
    else:
        fn(*args)


def begin_block() -> CacheTransaction:
    """Open a fresh block transaction and make it current.  The caller
    owns settlement: ``deactivate`` when the block's host phases are done
    (the transaction stays open for the pipeline's speculation window),
    then ``commit_block`` or ``rollback_block``.  Must not be called with
    a transaction already current (the engine guards; re-entrant callers
    use ``block_transaction``)."""
    global _TXN
    assert _TXN is None, "begin_block with a transaction already current"
    txn = _TXN = CacheTransaction()
    return txn


def deactivate(txn: CacheTransaction) -> None:
    """Detach ``txn`` from the current slot (it stays open — its undo log
    and deferred queue settle later via commit_block/rollback_block)."""
    global _TXN
    if _TXN is txn:
        _TXN = None


def commit_block(txn: CacheTransaction) -> None:
    """Settle a (possibly detached) block transaction.  Runs with NO
    transaction current: a deferred commit's own inserts apply
    immediately instead of leaking into whatever successor transaction
    happens to be current (the pipeline's overlap window)."""
    global _TXN
    outer = _TXN
    _TXN = None
    try:
        txn.commit()
    finally:
        _TXN = outer if outer is not txn else None


def rollback_block(txn: CacheTransaction) -> None:
    """Roll back a (possibly detached) block transaction; pops exactly
    the entries that block inserted, drops its deferred queue."""
    global _TXN
    txn.rollback()
    if _TXN is txn:
        _TXN = None


@contextlib.contextmanager
def block_transaction():
    """One block's cache transaction: commit on clean exit, roll back on
    any exception (then re-raise into the engine's replay contract).
    Re-entrant use joins the outer transaction."""
    global _TXN
    if _TXN is not None:
        yield _TXN
        return
    txn = begin_block()
    try:
        yield txn
    except BaseException:
        rollback_block(txn)
        raise
    else:
        commit_block(txn)
    finally:
        deactivate(txn)
