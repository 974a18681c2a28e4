"""Fork-choice engine: a real spec ``Store`` + a proto-array, kept in
lockstep behind an ``on_tick / on_block / on_attestations / get_head``
API.

The engine *wraps* a spec ``Store`` (never forks its semantics): block,
tick and slashing handling delegate to the spec handlers on that store,
attestation batches go through the vectorized path in ``batch.py`` (which
updates ``store.latest_messages`` with the spec's exact fold), and the
proto-array mirrors the store's block tree and votes so ``get_head`` is
one O(blocks) array walk instead of the spec's O(blocks × validators)
recursive re-walk.

Invariants (pinned by tests/test_torch_forkchoice.py):

* ``engine.get_head()`` is byte-identical to ``spec.get_head(store)`` at
  every point in any handler sequence, as are the justified/finalized
  checkpoints (read straight off the wrapped store);
* the wrapped store remains a spec-true ``Store`` — any spec function may
  be applied to it at any time.  The one liberty taken: the justified
  checkpoint's state is materialized eagerly (with the spec's own
  ``store_target_checkpoint_state``) when the justified checkpoint moves,
  where the spec materializes it lazily on the first matching
  attestation; head behavior is identical.
* the head is cached and invalidated on every write (any handler call);
* on finalization the proto-array prunes to the finalized subtree; votes
  for pruned branches keep their latest-message entries (as in the spec)
  but carry no weight — the spec walk, rooted under the finalized block,
  can never count them either.

Effective balances and the proposer-boost score are snapshots of the
justified checkpoint state, refreshed only when the justified checkpoint
moves (at most once per epoch), via the same cached registry columns the
epoch kernels use (``ops/epoch.registry_columns``).
"""
from __future__ import annotations

import numpy as np

from consensus_specs_tpu_torch import faults, telemetry, tracing
from consensus_specs_tpu_torch.telemetry import recorder, timeline

from . import batch
from .proto_array import ProtoArray

_ZERO32 = b"\x00" * 32

# handler/cache activity counters: the engine's health was
# previously visible only through tracing spans; these feed the telemetry
# bus so a soak run can watch ingest volume, head-cache effectiveness,
# and prune/refresh cadence over time
stats = {
    "on_block": 0,
    "on_tick": 0,
    "on_attestations": 0,
    "attestations_ingested": 0,
    "on_attester_slashing": 0,
    "head_cache_hits": 0,
    "head_recomputes": 0,
    "prunes": 0,
    "justified_refreshes": 0,
}


def reset_stats() -> None:
    """Zero the handler counters (they are module-wide like the stf
    engine's — one process may run several engines, the counters read as
    node-level activity)."""
    for k in stats:
        stats[k] = 0


def _telemetry_provider() -> dict:
    return dict(stats)


telemetry.register_provider("forkchoice.engine", _telemetry_provider,
                            replace=True)

# fault probes: each fires BEFORE its handler's first
# mutation, so an injected failure leaves the wrapped store and the
# proto-array exactly as they were — head parity with the spec walk is
# asserted across the fault in the chaos suite
_SITE_ON_BLOCK = faults.site("forkchoice.on_block")
_SITE_BATCH_APPLY = faults.site("forkchoice.batch.apply")
_SITE_PRUNE = faults.site("forkchoice.prune")


def _cp(checkpoint) -> tuple:
    return (int(checkpoint.epoch), bytes(checkpoint.root))


class ForkChoiceEngine:
    """Proto-array LMD-GHOST over a wrapped spec ``Store``."""

    def __init__(self, spec, store, block_handler=None):
        self.spec = spec
        self.store = store
        # the on_block seam: a drop-in replacement for
        # ``spec.on_block(store, signed_block)`` with the SAME contract —
        # same store mutations on success, the spec's exact exception and
        # partial store on failure.  The node subsystem installs its
        # engine-backed handler here (node/service.py routes the state
        # transition through the batched stf engine); None keeps the
        # literal spec handler.
        self._block_handler = block_handler
        self.proto = ProtoArray()
        self._head = None
        self._justified_seen = None
        self._finalized_seen = _cp(store.finalized_checkpoint)
        self._proposer_score = 0
        self._equivocating_seen = set(store.equivocating_indices)
        for root, block in sorted(store.blocks.items(),
                                  key=lambda kv: int(kv[1].slot)):
            self._insert_block(root)
        # a warm store may already carry latest messages: seed the votes
        # BEFORE the checkpoint sync so the balance refresh's full weight
        # rebuild counts them (spec parity holds from the first get_head)
        if store.latest_messages:
            self.proto.ensure_validators(
                int(max(store.latest_messages)) + 1)
            for v, message in store.latest_messages.items():
                if v in store.equivocating_indices:
                    continue
                self.proto.vote_node[int(v)] = \
                    self.proto.node_index(message.root)
                self.proto.vote_epoch[int(v)] = int(message.epoch)
        self._sync_checkpoints()

    # -- store mirroring -----------------------------------------------------

    def _insert_block(self, root) -> None:
        block = self.store.blocks[root]
        state = self.store.block_states[root]
        self.proto.insert(
            root, block.parent_root, int(block.slot),
            _cp(state.current_justified_checkpoint),
            _cp(state.finalized_checkpoint))

    def _refresh_justified(self) -> None:
        """Justified checkpoint moved: snapshot its state's active
        effective balances + proposer-boost score, rebuild weights."""
        spec, store = self.spec, self.store
        jc = store.justified_checkpoint
        spec.store_target_checkpoint_state(store, jc)
        state = store.checkpoint_states[jc]
        from consensus_specs_tpu_torch.ops.epoch import active_mask, registry_columns

        cols = registry_columns(state)
        epoch = int(spec.get_current_epoch(state))
        active = active_mask(cols, epoch)
        balances = np.where(active, cols["effective_balance"], 0)
        self.proto.set_balances(balances)
        num = int(active.sum())
        if num == 0:
            self._proposer_score = 0
            return
        total = max(int(spec.EFFECTIVE_BALANCE_INCREMENT),
                    int(balances.sum(dtype=np.uint64)))
        avg = total // num
        committee_weight = (num // int(spec.SLOTS_PER_EPOCH)) * avg
        self._proposer_score = (
            committee_weight * int(spec.config.PROPOSER_SCORE_BOOST) // 100)

    def _sync_checkpoints(self) -> None:
        jc = _cp(self.store.justified_checkpoint)
        if jc != self._justified_seen:
            # seen-marker moves only after the refresh succeeds: a failure
            # mid-refresh must retry on the next handler call, not leave
            # stale balances behind a marker that says they're fresh.
            # Counter + event move with it — a failed refresh must not be
            # logged as if it happened (same placement as the prune below)
            self._refresh_justified()
            self._justified_seen = jc
            stats["justified_refreshes"] += 1
            recorder.record("fc_justified_refresh", epoch=jc[0])
        fc = _cp(self.store.finalized_checkpoint)
        if fc != self._finalized_seen:
            with tracing.span("forkchoice/prune"):
                # probe before the prune mutates the proto-array; the seen
                # marker moves only after success, so an injected failure
                # here retries the prune on the next handler call
                _SITE_PRUNE()
                self.proto.prune(self.store.finalized_checkpoint.root)
            self._finalized_seen = fc
            stats["prunes"] += 1
            recorder.record("fc_prune", epoch=fc[0])

    # -- handlers ------------------------------------------------------------

    def on_tick(self, time) -> None:
        stats["on_tick"] += 1
        with tracing.span("forkchoice/on_tick"):
            try:
                self.spec.on_tick(self.store, time)
                self._sync_checkpoints()
            finally:
                # invalidate even on a failure part-way: the spec handler
                # may already have moved the store under the cached head
                self._head = None

    def on_block(self, signed_block) -> None:
        stats["on_block"] += 1
        if recorder.enabled():
            recorder.record("fc_on_block",
                            slot=int(signed_block.message.slot))
        # the tracing span auto-emits a timeline event; the explicit span
        # adds the slot field so a Perfetto read can line the fork-choice
        # track up against the stf block flow
        with timeline.span("fc/on_block",
                           slot=int(signed_block.message.slot)), \
                tracing.span("forkchoice/on_block"):
            _SITE_ON_BLOCK()  # pre-mutation: a fault leaves store + proto as-is
            try:
                (self._block_handler or self.spec.on_block)(
                    self.store, signed_block)
                self._insert_block(
                    self.spec.hash_tree_root(signed_block.message))
                self._sync_checkpoints()
            finally:
                self._head = None

    def on_attestations(self, attestations, is_from_block: bool = False) -> None:
        """Batched ``on_attestation``: the whole batch is validated AND
        staged before any vote lands (batch.py), then the store fold and
        the proto-array weight update commit together in a region with no
        failure modes — a fault anywhere up to the commit leaves no
        partially-applied vote deltas."""
        stats["on_attestations"] += 1
        stats["attestations_ingested"] += len(attestations)
        with timeline.span("fc/on_attestations", n=len(attestations)), \
                tracing.span("forkchoice/on_attestations"):
            try:
                staged = batch.ingest_attestations(
                    self.spec, self.store, attestations, is_from_block)
                if staged is not None:
                    self.proto.ensure_validators(
                        int(staged.validators.max()) + 1)
                    nodes = np.fromiter(
                        (self.proto.node_index(staged.block_roots[a])
                         for a in staged.att_ids.tolist()),
                        dtype=np.int64, count=len(staged.att_ids))
                    _SITE_BATCH_APPLY()  # last probed point before the commit
                    batch.commit_votes(self.store, staged)
                    with tracing.span("forkchoice/apply_votes"):
                        self.proto.apply_vote_changes(
                            staged.validators, nodes, staged.epochs)
            finally:
                self._head = None

    def on_attestation(self, attestation, is_from_block: bool = False) -> None:
        self.on_attestations([attestation], is_from_block=is_from_block)

    def on_attester_slashing(self, attester_slashing) -> None:
        stats["on_attester_slashing"] += 1
        with tracing.span("forkchoice/on_attester_slashing"):
            try:
                self.spec.on_attester_slashing(self.store, attester_slashing)
                fresh = self.store.equivocating_indices - self._equivocating_seen
                if fresh:
                    eq = np.fromiter((int(i) for i in fresh), dtype=np.int64)
                    self.proto.ensure_validators(int(eq.max()) + 1)
                    self.proto.clear_votes(eq)
                    # seen-marker moves only after the votes cleared, like
                    # the justified/prune markers: a failure here retries
                    self._equivocating_seen |= fresh
            finally:
                self._head = None

    # -- queries -------------------------------------------------------------

    def get_head(self):
        if self._head is not None:
            stats["head_cache_hits"] += 1
            return self._head
        stats["head_recomputes"] += 1
        with tracing.span("forkchoice/find_head"):
            store = self.store
            boost_root = bytes(store.proposer_boost_root)
            boost = self._proposer_score if boost_root != _ZERO32 else 0
            self._head = self.proto.find_head(
                store.justified_checkpoint.root,
                _cp(store.justified_checkpoint),
                _cp(store.finalized_checkpoint),
                int(self.spec.GENESIS_EPOCH),
                boost_root=boost_root if boost else None,
                boost_score=boost)
        return self._head

    @property
    def justified_checkpoint(self):
        return self.store.justified_checkpoint

    @property
    def finalized_checkpoint(self):
        return self.store.finalized_checkpoint
