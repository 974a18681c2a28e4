"""The node: one servable pipeline over the two engines.

Eleven PRs built two fast libraries — the proto-array fork-choice engine
(``forkchoice/engine.py``) and the batched stf engine
(``stf/engine.py``) — but ``on_block`` still replayed blocks through the
literal ``spec.state_transition``.  This module composes them into ONE
pipeline:

* **engine-backed ``on_block``** — ``engine_backed_on_block`` is the
  spec handler (specs/src/phase0.py:1602-1641; bellatrix adds the
  merge-transition check) with the state transition routed through
  ``stf.apply_signed_blocks``: the block's signature batch dispatches to
  the pipeline worker, attestations apply vectorized, slot roots ride
  the resident merkle path — and the stf engine's rollback contract,
  literal-replay fallback, and circuit breaker carry over UNCHANGED
  (``apply_signed_blocks`` is semantically identical to
  ``state_transition``, same post-state, same exception at the same
  point).  A ``Node``'s fork-choice engine gets this handler installed
  at construction (the ``block_handler`` seam), so head tracking, block
  verification, and state transition are one pipeline.

* **single-writer apply loop over a bounded multi-producer queue** —
  fork choice is single-writer by contract; producers (gossip readers,
  block fetchers, the clock) enqueue into ``node/ingest.py``'s bounded
  FIFO and ``run_apply_loop`` drains it on ONE thread.  A non-blocking
  writer lock enforces the contract (a second concurrent writer raises
  instead of corrupting the store).  The ``node.apply`` fault probe
  fires before any store/proto mutation so an injected failure leaves
  both untouched (tests/test_torch_node.py).

* **adaptive micro-batching** — the loop drains the WHOLE
  queue in one lock acquisition (waking every blocked producer at
  once), partitions the batch into strict-order items (blocks, ticks,
  slashings — the full rollback contract, unchanged) and consecutive
  gossip **runs** that land through ONE staged-commit
  ``forkchoice.batch.ingest_attestations`` each, and flushes the
  admission gate's back-pressure aggregation buffer into the same
  drain.  The journal keeps per-item provenance (one entry per original
  gossip batch, in arrival order), so replay parity and ``recover_node``
  hold byte-identically.  A spec-rejected run BISECTS to its poison
  item (``stf/verify.py``'s ``first_invalid`` pattern at the node
  layer, fault site ``node.batch_bisect``): the clean remainder lands,
  exactly the poison producer is charged.

* **the survival layer** — every loop item passes the
  admission gate (``node/admission.py``: content-root dedup, orphan
  pool, future parking, malformed rejection, peer quarantine) before a
  spec handler sees it, and the loop CONTAINS failure instead of
  halting: a spec rejection (``AssertionError``) is counted, charged to
  the producer, and dropped; any other failure re-queues at the head
  with exponential backoff up to ``max_item_retries`` total attempts
  (the ingest queue's per-item ``attempts`` count), then quarantines to
  the bounded dead-letter ring (``node_quarantine`` flight-recorder
  event) while serving continues.  Only a real kill
  (``BaseException``) propagates — with the item back at the head, so
  the journal stays a true history for recovery.

* **parity journal + crash recovery** — every applied item lands in
  ``node.journal`` in apply order, so a concurrent run's end state is
  exactly replayable through the literal spec handlers (the firehose's
  head/root parity leg replays the journal, making
  byte-identical-state assertions meaningful under nondeterministic
  producer interleaving) — and ``recover_node`` rebuilds a crashed
  node byte-identically from the same journal.

Observability: ``node_block``/``node_gossip`` flight-recorder events
(recorded only after the engine call settled — OB01's commit
discipline), ``node/apply`` timeline spans carrying the enqueue-time
causality link (Perfetto shows the producer → apply-loop handoff), and a
``node`` snapshot provider on the telemetry bus (queue depth,
applied/rejected counters, producer stats).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Optional, Sequence

from consensus_specs_tpu_torch import faults, telemetry
from consensus_specs_tpu_torch.forkchoice import ForkChoiceEngine
from consensus_specs_tpu_torch.forkchoice import batch as fc_batch
from consensus_specs_tpu_torch.persist import store as persist_store
from consensus_specs_tpu_torch.query.engine import QueryEngine
from consensus_specs_tpu_torch.stf import apply_signed_blocks
from consensus_specs_tpu_torch.telemetry import histogram, recorder, timeline

from . import admission, ingest

# probed at the top of every apply (direct handler or loop item), BEFORE
# the engine dispatch: an injected failure leaves store + proto-array
# exactly as they were and the dequeued item back at the queue head
_SITE_APPLY = faults.site("node.apply")
# probed BEFORE a journal replay begins: an injected recovery failure
# leaves the half-built node discarded and nothing global touched — a
# retried recovery starts clean (tests/test_torch_node.py)
_SITE_RECOVER = faults.site("node.recover")
# probed at each bisection step of a spec-rejected gossip run: an
# injected failure abandons the bisection machinery and falls back to
# item-at-a-time apply — containment degrades, never breaks
_SITE_BISECT = faults.site("node.batch_bisect")

# total apply ATTEMPTS a poison item gets before the loop quarantines it
# to the dead-letter ring (the containment contract: the node keeps
# serving; the item keeps its evidence)
DEFAULT_MAX_ITEM_RETRIES = 3
DEFAULT_RETRY_BACKOFF_S = 0.01

stats = {
    "blocks_applied": 0,
    "ticks_applied": 0,
    "attestation_batches_applied": 0,
    "attestations_applied": 0,
    "slashings_applied": 0,
    "rejected_batches": 0,
    "rejected_attestations": 0,
    "rejected_blocks": 0,
    "rejected_slashings": 0,
    "rejected_ticks": 0,
    "retried_items": 0,
    "quarantined_items": 0,
    "requeued_items": 0,
    "recoveries": 0,
    "checkpoint_recoveries": 0,
    "checkpoints_scheduled": 0,
    "checkpoint_gather_failures": 0,
    "apply_loop_runs": 0,
    "batches_applied": 0,      # drained micro-batches
    "runs_coalesced": 0,       # multi-item gossip runs landed as one ingest
    "batch_bisections": 0,     # spec-rejected runs bisected to the poison
}


def reset_stats() -> None:
    """Zero the node counters AND the ingest queue's and admission
    gate's (they attribute one pipeline; a firehose run must not inherit
    a previous run's counts)."""
    for k in stats:
        stats[k] = 0
    ingest.reset_stats()
    admission.reset_stats()


def _telemetry_provider() -> dict:
    return {**stats, "queue": ingest.snapshot()}


telemetry.register_provider("node", _telemetry_provider, replace=True)


def engine_backed_on_block(spec, store, signed_block) -> None:
    """``spec.on_block`` with the state transition routed through the
    batched stf engine — same store mutations, same exceptions at the
    same points (``apply_signed_blocks`` is differentially pinned to
    ``state_transition``), so this is a drop-in for the fork-choice
    engine's ``block_handler`` seam."""
    block = signed_block.message
    # Parent block must be known
    assert block.parent_root in store.block_states
    pre_state = store.block_states[block.parent_root].copy()
    # Blocks cannot be in the future
    assert spec.get_current_slot(store) >= block.slot
    # Block must be later than the finalized epoch slot, on its chain
    finalized_slot = spec.compute_start_slot_at_epoch(
        store.finalized_checkpoint.epoch)
    assert block.slot > finalized_slot
    assert spec.get_ancestor(store, block.parent_root, finalized_slot) == \
        store.finalized_checkpoint.root

    # the one substitution: the batched engine instead of the literal
    # spec.state_transition (rollback/breaker/replay semantics inside)
    state = pre_state.copy()
    apply_signed_blocks(spec, state, (signed_block,), True)

    # [New in Bellatrix] merge-transition validation, against the
    # untransitioned pre-state exactly as the spec orders it
    is_mtb = getattr(spec, "is_merge_transition_block", None)
    if is_mtb is not None and is_mtb(pre_state, block.body):
        spec.validate_merge_block(block)

    root = spec.hash_tree_root(block)
    store.blocks[root] = block
    store.block_states[root] = state

    time_into_slot = ((store.time - store.genesis_time)
                      % spec.config.SECONDS_PER_SLOT)
    is_before_attesting_interval = (
        time_into_slot
        < spec.config.SECONDS_PER_SLOT // spec.INTERVALS_PER_SLOT)
    if spec.get_current_slot(store) == block.slot \
            and is_before_attesting_interval:
        store.proposer_boost_root = root

    if state.current_justified_checkpoint.epoch > \
            store.justified_checkpoint.epoch:
        if state.current_justified_checkpoint.epoch > \
                store.best_justified_checkpoint.epoch:
            store.best_justified_checkpoint = \
                state.current_justified_checkpoint
        if spec.should_update_justified_checkpoint(
                store, state.current_justified_checkpoint):
            store.justified_checkpoint = state.current_justified_checkpoint

    if state.finalized_checkpoint.epoch > store.finalized_checkpoint.epoch:
        store.finalized_checkpoint = state.finalized_checkpoint
        store.justified_checkpoint = state.current_justified_checkpoint


def default_anchor_block(spec, anchor_state):
    """The anchor block a state implies: its ``latest_block_header`` with
    the state root filled — valid whenever the header's body root is the
    empty body's (genesis states; firehose-prepared anchors)."""
    header = anchor_state.latest_block_header
    return spec.BeaconBlock(
        slot=header.slot, proposer_index=header.proposer_index,
        parent_root=header.parent_root,
        state_root=anchor_state.hash_tree_root())


class Node:
    """A servable consensus node: fork choice + batched state transition
    behind one single-writer handler surface and one ingest queue."""

    def __init__(self, spec, anchor_state, anchor_block=None,
                 queue_cap: int = ingest.DEFAULT_CAP, journal: bool = True,
                 admission_gate: bool = True,
                 max_item_retries: int = DEFAULT_MAX_ITEM_RETRIES,
                 retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
                 adopt_admission: bool = True,
                 checkpoint_store=None,
                 checkpoint_interval_epochs: int = 1,
                 _warm_store=None):
        self.spec = spec
        if _warm_store is not None:
            # checkpoint recovery: a spec Store rebuilt from a
            # restored checkpoint — the engine's warm-store path seeds the
            # proto-array, votes, and checkpoint sync from it
            store = _warm_store
        else:
            if anchor_block is None:
                anchor_block = default_anchor_block(spec, anchor_state)
            store = spec.get_forkchoice_store(anchor_state, anchor_block)
        self.engine = ForkChoiceEngine(
            spec, store, block_handler=self._on_block_stf)
        self.queue = ingest.IngestQueue(cap=queue_cap)
        # apply-order journal: the literal-spec parity replay's script.
        # Owner-mutated only (analyzer-registered next to the queue).
        self._journal = [] if journal else None
        self._journal_last_block = None
        self._writer_lock = threading.Lock()
        self._clock_cond = threading.Condition()
        self._clock_slot = int(spec.get_current_slot(store))
        # the survival layer: the admission gate judges every
        # LOOP item before a spec handler sees it; direct handler calls
        # (the differential mirrors') bypass it by design — they want
        # the spec's exact accept/reject verdicts.  A fresh node adopts
        # the process-wide admission surface (pools reset);
        # ``recover_node`` opts out — recovery must PRESERVE the crashed
        # surface's dead letters, peer scores, and quarantine set (the
        # post-mortem evidence and the shed protection both outlive the
        # crash)
        self._admission = admission_gate
        self._max_item_retries = max(1, int(max_item_retries))
        self._retry_backoff_s = float(retry_backoff_s)
        # durable checkpoint cadence: the apply loop writes a
        # checkpoint whenever the store clock crosses an epoch boundary
        # (the fence) — gathering is cheap reference-taking under the
        # single writer; serialization + the atomic write happen on the
        # store's background writer thread, off the serving hot path
        self._ckpt_store = checkpoint_store
        self._ckpt_interval = max(1, int(checkpoint_interval_epochs))
        self._spe = int(spec.SLOTS_PER_EPOCH)
        self._ckpt_epoch_seen = \
            int(spec.get_current_slot(store)) // self._spe
        # the historical read path: a query engine over the
        # same store's artifacts, exposed beside the apply loop —
        # reader threads serve off verified artifact mmaps and
        # engine-owned caches, never off this node's fork-choice store
        # (the TH01 "query-reader" role wall)
        self.query_engine = (QueryEngine(spec, checkpoint_store)
                             if checkpoint_store is not None else None)
        if adopt_admission:
            admission.reset_state()

    def _on_block_stf(self, store, signed_block) -> None:
        """The ``block_handler`` installed on the fork-choice engine:
        the spec handler shape with the batched stf transition."""
        engine_backed_on_block(self.spec, store, signed_block)

    # -- single-writer contract ----------------------------------------------

    @contextlib.contextmanager
    def _single_writer(self):
        # thread-safe: a deliberately NON-blocking probe — contention
        # means a second writer, which must raise, not wait; released
        # in the finally below (the with-form cannot express try-acquire)
        if not self._writer_lock.acquire(blocking=False):
            raise RuntimeError(
                "concurrent node apply: fork choice is single-writer — "
                "producers must enqueue, only the apply loop applies")
        try:
            yield
        finally:
            self._writer_lock.release()

    def _journal_append(self, kind: str, payload) -> None:
        if self._journal is not None:
            self._journal.append((kind, payload))
            if kind == "block":
                # the checkpoint's content-bound journal anchor (root is
                # memoized — on_block already hashed the message)
                self._journal_last_block = (
                    len(self._journal) - 1,
                    bytes(payload.message.hash_tree_root()).hex())

    def _note_clock(self) -> None:
        slot = int(self.spec.get_current_slot(self.engine.store))
        if slot != self._clock_slot:
            with self._clock_cond:
                self._clock_slot = slot
                self._clock_cond.notify_all()

    def wait_for_clock(self, slot: int,
                       timeout: Optional[float] = None) -> bool:
        """Block until the store clock reaches ``slot`` (producers pace
        themselves against the apply loop with this — e.g. gossip for
        slot N enqueues only once the clock passed N, so the votes are
        mature on arrival)."""
        with self._clock_cond:
            return self._clock_cond.wait_for(
                lambda: self._clock_slot >= slot, timeout)

    # -- handlers (the single writer's API) ----------------------------------

    def on_tick(self, time) -> None:
        with self._single_writer():
            _SITE_APPLY()
            self.engine.on_tick(time)
            stats["ticks_applied"] += 1
            self._journal_append("tick", int(time))
        self._note_clock()

    def on_block(self, signed_block) -> None:
        with self._single_writer():
            _SITE_APPLY()
            self.engine.on_block(signed_block)
            stats["blocks_applied"] += 1
            self._journal_append("block", signed_block)
            if recorder.enabled():
                recorder.record("node_block",
                                slot=int(signed_block.message.slot))

    def on_attestations(self, attestations: Sequence,
                        is_from_block: bool = False) -> None:
        with self._single_writer():
            _SITE_APPLY()
            self.engine.on_attestations(list(attestations),
                                        is_from_block=is_from_block)
            stats["attestation_batches_applied"] += 1
            stats["attestations_applied"] += len(attestations)
            self._journal_append("attestations", tuple(attestations))
            if recorder.enabled():
                recorder.record("node_gossip", n=len(attestations))

    def on_attestation(self, attestation, is_from_block: bool = False) -> None:
        self.on_attestations([attestation], is_from_block=is_from_block)

    def on_attester_slashing(self, attester_slashing) -> None:
        with self._single_writer():
            _SITE_APPLY()
            self.engine.on_attester_slashing(attester_slashing)
            stats["slashings_applied"] += 1
            self._journal_append("attester_slashing", attester_slashing)

    def get_head(self):
        return self.engine.get_head()

    @property
    def store(self):
        return self.engine.store

    @property
    def journal(self) -> list:
        return list(self._journal or ())

    # -- producer surface ----------------------------------------------------

    def enqueue_tick(self, time, timeout: Optional[float] = None) -> None:
        self.queue.put("tick", int(time), timeout=timeout)

    def enqueue_block(self, signed_block,
                      timeout: Optional[float] = None) -> None:
        self.queue.put("block", signed_block, timeout=timeout)

    def enqueue_attestations(self, attestations: Sequence,
                             timeout: Optional[float] = None) -> None:
        payload = tuple(attestations)
        if self._admission:
            # back-pressure becomes aggregation work: when
            # the queue sits at cap, the batch goes to the admission
            # gate's staging buffer instead of blocking the producer;
            # the apply loop flushes the buffer into its next drain.
            # Refused stagings (buffer at cap, undecodable payload,
            # quarantined producer) fall through to the blocking put —
            # the original back-pressure contract
            if self.queue.try_put("attestations", payload):
                return
            link = timeline.next_link() if timeline.enabled() else None
            if admission.aggregate_gossip(
                    payload, threading.current_thread().name, link):
                if link is not None:
                    with timeline.span("node/enqueue", link=link,
                                       kind="attestations", aggregated=True):
                        pass
                return
        self.queue.put("attestations", payload, timeout=timeout)

    def enqueue_attester_slashing(self, attester_slashing,
                                  timeout: Optional[float] = None) -> None:
        self.queue.put("attester_slashing", attester_slashing,
                       timeout=timeout)

    # -- the apply loop ------------------------------------------------------

    def apply_item(self, item: ingest.WorkItem) -> None:
        """Dispatch one work item to its handler, raising on any failure
        (a spec rejection raises the spec's ``AssertionError``).  The
        verdict/containment policy — admission, rejection counting,
        retries, quarantine — is ``_process_item``'s job; this is the
        raw apply."""
        with timeline.span("node/apply", link=item.link, kind=item.kind):
            if item.kind == "tick":
                self.on_tick(item.payload)
            elif item.kind == "block":
                self.on_block(item.payload)
            elif item.kind == "attestations":
                self.on_attestations(item.payload)
            elif item.kind == "attester_slashing":
                self.on_attester_slashing(item.payload)
            else:
                raise ValueError(f"unknown work item kind {item.kind!r}")

    # -- containment: the loop never halts on a poison item --------

    def _count_rejected(self, item: ingest.WorkItem) -> None:
        """A spec-invalid item (``AssertionError`` out of the handler):
        production-shaped load, counted + charged + dropped."""
        if item.kind == "attestations":
            stats["rejected_batches"] += 1
            stats["rejected_attestations"] += len(item.payload)
            if recorder.enabled():
                recorder.record("node_gossip_rejected", n=len(item.payload))
        elif item.kind == "block":
            stats["rejected_blocks"] += 1
            if recorder.enabled():
                recorder.record("node_block_rejected",
                                slot=int(item.payload.message.slot))
        elif item.kind == "attester_slashing":
            stats["rejected_slashings"] += 1
        else:
            stats["rejected_ticks"] += 1
        admission.charge(item.producer, admission.CHARGE_REJECTED)
        # a rejection is a verdict on CURRENT store state (an unknown
        # root can arrive later): forget the dedup key so an honest
        # re-delivery is re-judged instead of dying as a duplicate
        admission.forget(item)

    def _contain_failure(self, item: ingest.WorkItem,
                         exc: Exception) -> None:
        """Bounded per-item retries with backoff, then quarantine to the
        dead-letter ring — the poison-pill contract: the loop keeps
        serving.  A failing quarantine (its own fault site) propagates
        un-handled: the CALLER re-queues the item ahead of any pending
        followups (exact order restored) — containment of last resort
        must fail loudly, never half-record."""
        if item.attempts + 1 >= self._max_item_retries:
            admission.dead_letter(item, exc)
            stats["quarantined_items"] += 1
        else:
            stats["retried_items"] += 1
            if self._retry_backoff_s > 0:
                time.sleep(self._retry_backoff_s * (2 ** item.attempts))
            self.queue.requeue_front(item)
            stats["requeued_items"] += 1

    def _process_item(self, item: ingest.WorkItem, readmit: bool = False,
                      tail: tuple = (), admitted: bool = False) -> bool:
        """One dequeued item through the survival layer: admission
        verdict, apply, containment, and the follow-ups a success
        unlocks (orphan re-links after a block, parked releases after a
        tick) — processed iteratively so a long re-link chain cannot
        recurse.

        ``tail`` is the drained micro-batch's unprocessed remainder
       : a containment re-queue puts it back BEHIND the
        retried item — exact pre-drain order — and the method returns
        False so the batch stops and the loop re-drains.  ``admitted``
        marks an item already past the gate this drain (a gossip-run
        member falling back to item-at-a-time apply); its verdict is
        not re-judged."""
        stop = False
        work = collections.deque([(item, readmit, admitted)])
        while work:
            it, re, adm = work.popleft()
            clock_before = self._clock_slot
            try:
                # admission runs INSIDE containment: a fault at the gate
                # is an infrastructure failure, not a verdict — the item
                # re-queues and the retry re-judges it (nothing is lost).
                # A retried item (attempts > 0) already passed the dedup
                # check once and sits in the seen-set: it re-enters as a
                # re-admission, not a duplicate.
                if self._admission and not adm:
                    verdict, it = admission.admit(
                        self.spec, self.store, it, self._clock_slot,
                        readmit=re or it.attempts > 0 or it.readmit)
                    if verdict != admission.VERDICT_ADMIT:
                        continue
                self.apply_item(it)
            except AssertionError:
                self._count_rejected(it)
            except Exception as exc:
                will_retry = it.attempts + 1 < self._max_item_retries
                if will_retry and tail:
                    # the retried item lands FIRST (inside
                    # _contain_failure below), the batch tail right
                    # behind it — exact pre-drain order
                    for rest in reversed(tail):
                        self.queue.requeue_front(rest, count_attempt=False)
                    tail = ()
                try:
                    self._contain_failure(it, exc)
                except BaseException:
                    # containment itself failed (e.g. a quarantine
                    # fault): restore the queue in EXACT order — the
                    # in-flight item first, its pending followups right
                    # behind, then any batch tail not yet returned —
                    # and propagate loudly
                    for rest in reversed(tail):
                        self.queue.requeue_front(rest, count_attempt=False)
                    tail = ()
                    for rest, _re, _adm in reversed(work):
                        self.queue.requeue_front(
                            rest._replace(readmit=True),
                            count_attempt=False)
                    work.clear()
                    self.queue.requeue_front(it)
                    stats["requeued_items"] += 1
                    raise
                if will_retry:
                    stop = True
            except BaseException:
                # a real kill (KeyboardInterrupt, SystemExit): crash
                # semantics — the item back at the head, the journal a
                # true history, recovery's replay picks up from here.
                # Pending followups were already POPPED from the
                # admission pools: re-queue them behind the in-flight
                # item (in order) or they would vanish unaccounted, and
                # the batch tail behind THEM (exact pre-drain order).
                # Neither they nor the interrupted item FAILED — the
                # kill is not a poison signal, so no attempt is charged
                for rest in reversed(tail):
                    self.queue.requeue_front(rest, count_attempt=False)
                tail = ()
                for rest, _re, _adm in reversed(work):
                    self.queue.requeue_front(rest._replace(readmit=True),
                                             count_attempt=False)
                work.clear()
                self.queue.requeue_front(it._replace(readmit=True),
                                         count_attempt=False)
                stats["requeued_items"] += 1
                raise
            else:
                if not self._admission:
                    continue
                if it.kind == "block":
                    root = bytes(it.payload.message.hash_tree_root())
                    work.extend((child, True, False)
                                for child in admission.pop_children(root))
                elif it.kind == "tick":
                    released = admission.on_clock(
                        self._clock_slot,
                        self._clock_slot - clock_before)
                    work.extend((r, True, False) for r in released)
        return not stop

    # -- the micro-batcher ----------------------------------------

    def _drain_aggregated(self, max_items: Optional[int] = None) -> list:
        """Flush the admission gate's back-pressure aggregation buffer
        into the current drain (gate off: nothing ever staged)."""
        if not self._admission:
            return []
        return admission.drain_aggregated(max_items)

    def _process_batch(self, batch: list) -> int:
        """Partition one drained micro-batch: blocks, ticks, and
        slashings stay strict-order item-at-a-time through the full
        rollback contract; maximal consecutive gossip slices become
        runs.  Returns the number of batch items consumed before the
        batch completed or stopped (a containment re-queue returned the
        remainder to the real queue)."""
        pending = collections.deque(batch)
        consumed = 0
        while pending:
            if (pending[0].kind == "attestations" and len(pending) > 1
                    and pending[1].kind == "attestations"):
                run = []
                while pending and pending[0].kind == "attestations":
                    run.append(pending.popleft())
                consumed += len(run)
                if not self._process_gossip_run(run, tuple(pending)):
                    return consumed
            else:
                it = pending.popleft()
                consumed += 1
                if not self._process_item(it, tail=tuple(pending)):
                    return consumed
                # the epoch fence must fire PER settled item, not per
                # drained batch: one bulk drain can carry ticks crossing
                # several epoch boundaries, and each crossing owes its
                # own checkpoint (only ticks move the clock, so gossip
                # runs never need the check)
                if self._ckpt_store is not None:
                    self._maybe_checkpoint()
        return consumed

    def _process_gossip_run(self, run: list, tail: tuple) -> bool:
        """A maximal consecutive slice of gossip items from one drain:
        judge each at the gate in FIFO order, then land every admitted
        batch through ONE staged-commit fork-choice ingest
        (``_commit_run``).  Returns False when items went back to the
        real queue (the batch stops and the loop re-drains)."""
        admitted = []
        pending = collections.deque(run)
        while pending:
            it = pending.popleft()
            if not self._admission:
                admitted.append(it)
                continue
            try:
                verdict, judged = admission.admit(
                    self.spec, self.store, it, self._clock_slot,
                    readmit=it.attempts > 0 or it.readmit)
            except Exception as exc:
                # infrastructure failure at the gate mid-run: the
                # admitted prefix keeps its place (marked readmit — its
                # seen-keys are in), the failing item gets the per-item
                # containment verdict, the unjudged rest and the batch
                # tail line up behind — exact pre-drain order
                will_retry = it.attempts + 1 < self._max_item_retries
                if will_retry:
                    for rest in reversed(tail):
                        self.queue.requeue_front(rest, count_attempt=False)
                    for rest in reversed(pending):
                        self.queue.requeue_front(rest, count_attempt=False)
                try:
                    self._contain_failure(it, exc)
                except BaseException:
                    if not will_retry:
                        for rest in reversed(tail):
                            self.queue.requeue_front(rest,
                                                     count_attempt=False)
                        for rest in reversed(pending):
                            self.queue.requeue_front(rest,
                                                     count_attempt=False)
                    self.queue.requeue_front(it)
                    stats["requeued_items"] += 1
                    for rest in reversed(admitted):
                        self.queue.requeue_front(rest, count_attempt=False)
                    raise
                if will_retry:
                    for rest in reversed(admitted):
                        self.queue.requeue_front(rest, count_attempt=False)
                    return False
                continue
            if verdict == admission.VERDICT_ADMIT:
                # marked readmit: from here on the item is past the
                # gate — any later re-queue must skip the dedup check
                admitted.append(judged._replace(readmit=True))
        if not admitted:
            return True
        return self._commit_run(admitted, tail)

    def _commit_run(self, items: list, tail: tuple) -> bool:
        """Land an admitted gossip run as one combined ingest, with the
        containment ladder batching adds: a spec rejection anywhere in
        the combined batch bisects to the poison item; an infrastructure
        failure falls back to item-at-a-time apply (one retry event for
        the run); a kill restores exact order and propagates."""
        try:
            self._apply_gossip_run(items)
            return True
        except AssertionError:
            return self._bisect_run(items, tail)
        except Exception:
            stats["retried_items"] += 1
            return self._apply_items_individually(items, tail)
        except BaseException:
            for rest in reversed(tail):
                self.queue.requeue_front(rest, count_attempt=False)
            for rest in reversed(items):
                self.queue.requeue_front(rest, count_attempt=False)
            stats["requeued_items"] += 1
            raise

    def _apply_gossip_run(self, items: Sequence) -> None:
        """Land admitted gossip items as ONE staged-commit fork-choice
        ingest — ``batch.ingest_attestations`` validates the whole
        combined batch before a single vote lands, so a failure leaves
        vote state untouched — while the journal keeps per-item
        provenance: one entry per original batch, in arrival order, so
        journal-replay parity and ``recover_node`` stay
        byte-identical."""
        combined = [a for it in items for a in it.payload]
        with timeline.span("node/apply", link=items[0].link,
                           kind="attestations", run=len(items)):
            with self._single_writer():
                _SITE_APPLY()
                self.engine.on_attestations(combined)
                for it in items:
                    stats["attestation_batches_applied"] += 1
                    stats["attestations_applied"] += len(it.payload)
                    self._journal_append("attestations", tuple(it.payload))
        if recorder.enabled():
            for it in items:
                recorder.record("node_gossip", n=len(it.payload))
        if timeline.enabled():
            # the coalesced items' causality links still need an apply
            # edge each, or Perfetto shows orphaned enqueue arrows
            for it in items[1:]:
                with timeline.span("node/apply", link=it.link,
                                   kind="attestations", coalesced=True):
                    pass
        if len(items) > 1:
            stats["runs_coalesced"] += 1
        histogram.observe("gossip_run", float(len(items)))

    def _probe_run(self, items: Sequence) -> bool:
        """Validation-only probe of a candidate slice: stage through the
        batch ingest and DISCARD — ``forkchoice/batch`` validates every
        attestation before staging and commits nothing until
        ``commit_votes``, so a probe's only store touch is the
        idempotent target-checkpoint-state cache the spec handler would
        populate anyway."""
        combined = [a for it in items for a in it.payload]
        try:
            with self._single_writer():
                fc_batch.ingest_attestations(self.spec, self.engine.store,
                                             combined)
        except AssertionError:
            return False
        return True

    def _bisect_run(self, items: list, tail: tuple) -> bool:
        """The combined commit was spec-rejected: bisect to the poison
        item (``stf/verify.py``'s ``first_invalid`` pattern at the node
        layer) with validation-only probes, land every clean slice as a
        run, hand exactly the poison item to the per-item containment
        core (charged + forgotten there), and continue with the rest.
        The ``node.batch_bisect`` probe fires once per bisection step;
        any machinery failure degrades to item-at-a-time apply."""
        stats["batch_bisections"] += 1
        pending = list(items)
        known_bad = True
        while pending:
            try:
                if not known_bad:
                    if self._probe_run(pending):
                        self._apply_gossip_run(pending)
                        return True
                if len(pending) == 1:
                    lo = 0
                else:
                    # invariant: pending[:lo] verifies; a failure sits
                    # in pending[lo:hi] (the stf first_invalid loop)
                    lo, hi = 0, len(pending)
                    while hi - lo > 1:
                        _SITE_BISECT()
                        mid = (lo + hi) // 2
                        if self._probe_run(pending[lo:mid]):
                            lo = mid
                        else:
                            hi = mid
                    if lo > 0:
                        self._apply_gossip_run(pending[:lo])
            except Exception:
                # the bisection machinery itself died (an injected
                # node.batch_bisect fault, a probe infrastructure
                # error): item-at-a-time fallback keeps every
                # containment guarantee for what is left
                stats["retried_items"] += 1
                return self._apply_items_individually(pending, tail)
            except BaseException:
                for rest in reversed(tail):
                    self.queue.requeue_front(rest, count_attempt=False)
                for rest in reversed(pending):
                    self.queue.requeue_front(rest, count_attempt=False)
                stats["requeued_items"] += 1
                raise
            poison, pending = pending[lo], pending[lo + 1:]
            if not self._process_item(poison, tail=tuple(pending) + tail,
                                      admitted=True):
                return False
            known_bad = False
        return True

    def _apply_items_individually(self, items: Sequence,
                                  tail: tuple) -> bool:
        """Fallback from a failed combined commit: every run item
        through the per-item containment core.  Admission is not
        re-judged (the run already passed the gate); rejection counting,
        retry/backoff, quarantine, and crash ordering all apply
        unchanged."""
        pending = collections.deque(items)
        while pending:
            it = pending.popleft()
            if not self._process_item(it, tail=tuple(pending) + tail,
                                      admitted=True):
                return False
        return True

    # -- durable checkpoints --------------------------------------

    def _maybe_checkpoint(self) -> None:
        """Epoch-fenced checkpoint cadence, called by the apply loop
        after every settled item.  A failure gathering or (synchronous
        store) writing is counted and contained — persistence trouble
        must never halt serving; the atomic layer guarantees it also
        never leaves a torn artifact behind."""
        # the clock the node already tracks (every tick updates
        # _clock_slot in _note_clock) — zero spec calls per settled item
        epoch = self._clock_slot // self._spe
        if epoch < self._ckpt_epoch_seen + self._ckpt_interval:
            return
        self._ckpt_epoch_seen = epoch
        if self._journal is None or not self._journal:
            return  # a journal-less node has nothing a restore can resume
        try:
            payload = self._gather_checkpoint()
            if payload is not None:
                self._ckpt_store.submit(self.spec, payload)
                stats["checkpoints_scheduled"] += 1
        except Exception:
            stats["checkpoint_gather_failures"] += 1

    def _gather_checkpoint(self):
        """Snapshot the fork-choice world under the single writer: the
        finalized anchor, every block/state descending from it (the
        since-finality window), and the store extras — all as references
        to immutable views and shallow copies of the small maps, so the
        gather costs milliseconds and the writer thread serializes from
        a frozen picture."""
        spec, store = self.spec, self.engine.store
        fin_root = bytes(store.finalized_checkpoint.root)
        if fin_root not in store.blocks:
            return None
        window = []
        descend = {fin_root}
        for root, block in sorted(store.blocks.items(),
                                  key=lambda kv: int(kv[1].slot)):
            rb = bytes(root)
            if rb == fin_root or bytes(block.parent_root) in descend:
                descend.add(rb)
                state = store.block_states[root]
                # memoize every root in the loop thread (a no-op after
                # the block's own state-root check) so the writer
                # thread's tree walk is purely read-only
                state.hash_tree_root()
                window.append((rb, block, state))
        if not window:
            return None
        return persist_store.CheckpointPayload(
            journal_pos=len(self._journal),
            trigger=_journal_token(self._journal[-1]),
            time=int(store.time),
            justified=_cp_pair(store.justified_checkpoint),
            best_justified=_cp_pair(store.best_justified_checkpoint),
            finalized=_cp_pair(store.finalized_checkpoint),
            proposer_boost_root=bytes(store.proposer_boost_root),
            latest_messages=dict(store.latest_messages),
            equivocating=frozenset(store.equivocating_indices),
            anchor_root=fin_root,
            window=tuple(window),
            head_state_root=bytes(window[-1][2].hash_tree_root()),
            last_block=self._journal_last_block)

    def run_apply_loop(self, timeout: Optional[float] = None,
                       max_items: Optional[int] = None) -> int:
        """Drain the queue until it is closed and empty (or ``timeout``
        elapses waiting for work).  Returns the number of items
        processed.  This is THE single writer: run it on one thread.
        A poison item never halts the loop — it is retried up to the
        node's cap with backoff, then quarantined to the dead-letter
        ring (``node_quarantine`` flight-recorder event) while serving
        continues.  ``max_items`` stops the loop after that many items —
        the crash-drill hook the recovery tests kill the loop with.

        The drain is an adaptive micro-batcher: one bulk
        ``drain`` pulls everything queued — waking every blocked
        producer with a single ``notify_all`` — the admission gate's
        back-pressure aggregation buffer flushes into the same batch,
        and ``_process_batch`` partitions it into strict-order items
        and coalesced gossip runs."""
        stats["apply_loop_runs"] += 1
        processed = 0
        while max_items is None or processed < max_items:
            limit = None if max_items is None else max_items - processed
            batch = self.queue.drain(timeout=timeout, max_items=limit)
            if batch is None:
                # end of stream (or timeout): whatever back-pressure
                # staged in the aggregation buffer still owes an apply
                batch = self._drain_aggregated(limit)
                if not batch:
                    return processed
            else:
                room = None if limit is None else limit - len(batch)
                if room is None or room > 0:
                    batch.extend(self._drain_aggregated(room))
            histogram.observe("drain_batch", float(len(batch)))
            stats["batches_applied"] += 1
            processed += self._process_batch(batch)
        return processed


def _journal_token(entry) -> tuple:
    """A content-bound identity token for one journal entry — what a
    checkpoint records about the entry it was written after, and what
    recovery compares before trusting that a checkpoint belongs to THIS
    journal.  Tick tokens alone would collide across any two runs on
    the same slot schedule, so attestation tokens bind content (first/
    last data roots) and the checkpoint ALSO records the newest block
    entry's (position, root) — see ``_recover_from_checkpoint``: a
    checkpoint directory from a different run must degrade to a stale
    miss, never splice a foreign suffix onto a restored store."""
    kind, payload = entry
    if kind == "block":
        return ("block", bytes(payload.message.hash_tree_root()).hex())
    if kind == "tick":
        return ("tick", int(payload))
    if kind == "attestations":
        if not payload:
            return ("attestations", 0)
        return ("attestations", len(payload),
                bytes(payload[0].hash_tree_root()).hex(),
                bytes(payload[-1].hash_tree_root()).hex())
    if kind == "attester_slashing":
        return ("attester_slashing", bytes(payload.hash_tree_root()).hex())
    return (kind, None)


def _cp_pair(checkpoint) -> tuple:
    return (int(checkpoint.epoch), bytes(checkpoint.root))


def _last_block_matches(journal, last_block, pos: int) -> bool:
    """The checkpoint's content-bound journal anchor: the newest block
    entry it recorded must sit at the same position with the same root
    in THIS journal.  Tick/gossip trigger tokens repeat across runs on
    the same slot schedule; a block root cannot — so a foreign-run
    checkpoint directory fails here and degrades to a stale miss."""
    if last_block is None:
        return True  # a pre-first-block checkpoint has no anchor to pin
    lbp, lbroot = int(last_block[0]), last_block[1]
    if not 0 <= lbp < pos or lbp >= len(journal):
        return False
    kind, payload = journal[lbp]
    return (kind == "block"
            and bytes(payload.message.hash_tree_root()).hex() == lbroot)


def _replay_journal(node: Node, journal) -> None:
    for kind, payload in journal:
        if kind == "tick":
            node.on_tick(payload)
        elif kind == "block":
            node.on_block(payload)
        elif kind == "attestations":
            node.on_attestations(payload)
        elif kind == "attester_slashing":
            node.on_attester_slashing(payload)
        else:
            raise ValueError(f"unknown journal kind {kind!r}")


def _recover_from_checkpoint(spec, journal, checkpoint_store,
                             node_kwargs) -> Optional[Node]:
    """The checkpoint fast path: walk candidates newest-first, restore
    the first one that is intact AND belongs to this journal, then
    replay only the suffix.  Every rung of the ladder — damaged
    artifact, stale tag, foreign journal — moves to the next candidate;
    None (the caller falls back to full replay) only when all are
    exhausted."""
    journal = list(journal)
    for path in checkpoint_store.candidates():
        try:
            restored = checkpoint_store.restore(spec, path)
        except persist_store.CheckpointError:
            continue  # quarantined + counted + flight-recorded inside
        pos = restored.journal_pos
        if not (1 <= pos <= len(journal)) or tuple(
                _journal_token(journal[pos - 1])) != tuple(restored.trigger):
            # an intact checkpoint from another journal/run: a stale
            # miss, not damage — the artifact survives for ITS journal
            persist_store.stats["stale_artifacts"] += 1
            continue
        if not _last_block_matches(journal,
                                   restored.meta.get("last_block"), pos):
            persist_store.stats["stale_artifacts"] += 1
            continue
        store = restored.as_store(spec)
        node = Node(spec, None, checkpoint_store=checkpoint_store,
                    _warm_store=store, **node_kwargs)
        _SITE_RECOVER()
        with timeline.span("node/recover", items=len(journal) - pos,
                           checkpoint=pos):
            # seed the journal with the covered prefix so the recovered
            # node's history is the crashed node's, then replay the
            # suffix through the engine-backed handlers (which append)
            if node._journal is not None:
                node._journal = journal[:pos]
            _replay_journal(node, journal[pos:])
        stats["checkpoint_recoveries"] += 1
        if recorder.enabled():
            recorder.record("checkpoint_restored", journal_pos=pos,
                            suffix_items=len(journal) - pos,
                            epoch=restored.meta["finalized"][0])
        return node
    return None


def recover_node(spec, anchor_state, anchor_block=None, journal=(),
                 checkpoint_store=None, **node_kwargs) -> Node:
    """Crash recovery: rebuild a ``Node`` whose store is byte-identical to the crashed one's.

    With a ``checkpoint_store``, recovery first tries the durable fast
    path: restore the newest valid checkpoint and replay only the
    journal suffix after its recorded position — O(since-the-last-
    epoch-fence) instead of O(history).  A truncated, bit-flipped,
    stale-tagged, or foreign-journal artifact is detected at load,
    quarantined, counted, flight-recorded (``store_corrupt``), and the
    ladder moves on; exhausting every candidate falls back to the full
    journal replay below — recovery never crashes on disk damage and
    never serves a state the journal doesn't vouch for.

    The full-replay path is unchanged: fresh node from the
    anchor, the whole journal through the engine-backed handlers.
    Either way the admission surface is PRESERVED (dead letters, peer
    scores, quarantine outlive the crash; only the transient seen-keys
    reset), the ``node.recover`` probe fires after construction and
    before the replay, and ``node_recovered`` is emitted only once the
    replay fully settles."""
    node_kwargs.setdefault("adopt_admission", False)
    if node_kwargs.get("adopt_admission") is False:
        # clear the TRANSIENT surface only: seen-keys for items that
        # never applied (the in-flight item at the kill, pooled
        # orphans) must not judge the mesh's re-delivery a duplicate —
        # but dead letters, scores, and quarantine survive
        admission.reset_transient()
    node = None
    if checkpoint_store is not None:
        node = _recover_from_checkpoint(spec, journal, checkpoint_store,
                                        node_kwargs)
        if node is None:
            persist_store.stats["restore_fallbacks"] += 1
    if node is None:
        node = Node(spec, anchor_state, anchor_block,
                    checkpoint_store=checkpoint_store, **node_kwargs)
        _SITE_RECOVER()
        with timeline.span("node/recover", items=len(journal)):
            _replay_journal(node, journal)
    stats["recoveries"] += 1
    if recorder.enabled():
        recorder.record("node_recovered", items=len(journal))
    return node
