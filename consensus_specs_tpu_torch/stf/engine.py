"""Batched block-transition engine: ``apply_signed_blocks``.

Port of ``consensus_specs_tpu/stf/engine.py``: the phase0 lineage and
the altair lineage (participation flags, sync aggregates), bellatrix's
execution payload included.  Every other fork (capella: withdrawals and
BLS-to-execution changes) replays through the literal spec.

Replays a sequence of signed blocks through the spec state transition with
three fused optimizations:

1. **one BLS batch per block** — the proposer signature, the RANDAO
   reveal, and every aggregate attestation settle in a single
   ``BatchFastAggregateVerify`` multi-pairing (stf/verify.py), with
   cross-block dedup of already-verified triples;
2. **vectorized attestation application** — committees and attester sets
   resolve off the cached whole-epoch shuffle permutation as numpy
   gathers, participation counts reduce through ``ops/segment.py``
   (stf/attestations.py), and only the spec-mandated tree writes
   (pending-attestation appends, or one packed participation write per
   dirtied column and the sync aggregate's net balance deltas) touch the
   state;
3. **cheap per-slot roots** — ``process_slots`` runs with dirty packed
   balance subtrees routed through the resident merkle path on the
   spec's device (stf/slot_roots.py; K2 on CUDA).

Failure contract — differential-exact by construction: the fast path is
optimistic; on ANY trouble (a structural check, a failed signature batch,
a fork or backend the fast path does not cover) the block's pre-state is
restored from its O(1) backing snapshot and the block replays through the
literal ``spec.state_transition``, which raises the spec's exact exception
type/message at the spec's exact point and leaves the state exactly as
poisoned as the sequential path would have.  Valid blocks therefore land
byte-identical post-states, and invalid blocks are indistinguishable from
the spec path (pinned by tests/test_torch_stf_engine.py,
tests/test_torch_stf_engine_altair.py and
tests/test_torch_stf_engine_bellatrix.py).  The one
exception is a failing kernel (``ops.sha256.KernelError``): the block's
pre-state is restored and the error raised to the caller, with no replay
and no breaker accounting, so a broken device path never hides behind the
host path.

Cross-block overlapped pipeline: with ``pipeline.ENABLED`` (the
default), a multi-block call overlaps block N's native signature
batch with the next block(s)' host phases — the batch is dispatched
through ``stf/pipeline.py`` and its verdict awaited only after
``_WINDOW_DEPTH`` successors' host work (2; the extra block of slack
absorbs per-block jitter).  The rollback
contract makes the speculation safe by construction: each block's cache
transaction stays open (and its verified-triple commit deferred) until
its verdict lands, so a failed verdict, a breaker trip, native
degradation, or any fault in the window drains the pipeline — the
successor's inserts and state writes unwind first (LIFO), the failing
block restores its own backing snapshot, and the literal replay raises
the spec's exception with the existing bisection naming the original
entry.  Results are byte-identical pipeline ON or OFF.
"""
from __future__ import annotations

import hashlib
import sys
import time

from consensus_specs_tpu_torch import faults, telemetry, tracing
from consensus_specs_tpu_torch.ops.sha256 import KernelError
from consensus_specs_tpu_torch.telemetry import histogram, recorder, timeline

from . import columns, pipeline, slot_roots, staging, sync, verify
from .attestations import (
    FastPathViolation,
    affine_rows,
    beacon_proposer_index,
    resolve_block_attestations,
)

# the fork families the fast path covers: phase0's pending-attestation
# shape, and the altair lineage (participation flags + sync aggregates;
# bellatrix adds the execution payload, run literally in the snapshot
# region).  capella+ (withdrawals, bls_to_execution_changes) replay
# through the literal spec until the engine grows those operations.
FAST_FORKS = ("phase0", "altair", "bellatrix")

# circuit breaker: after BREAKER_THRESHOLD CONSECUTIVE unexpected
# fast-path errors (not FastPathViolations — those are the contract
# working) the engine stops attempting the fast path and replays every
# block literally; while open, every BREAKER_PROBE_INTERVAL-th block is
# a recovery probe (i.e. INTERVAL-1 literal replays between probes), and
# a successful probe closes the breaker.  Failure containment for a systematically broken fast path
# (poisoned build, sick native library): correctness never depended on
# the fast path, but paying a doomed attempt + rollback per block would
# double the work exactly when the node is least healthy.
BREAKER_THRESHOLD = 3
BREAKER_PROBE_INTERVAL = 8

# the speculation window: how many blocks may hold an outstanding verdict
# while the next block's host phases run (in flight at once: these plus
# the current block's batch)
_WINDOW_DEPTH = 2

_breaker = {"consecutive_errors": 0, "open": False, "since_skipped": 0}

# fault probes: each fast-path phase fails into the
# rollback contract; the gate and the post-settlement cache commit are
# probed as well so degraded-availability and torn-commit scenarios are
# tested paths
_SITE_HEADER = faults.site("stf.engine.header")
_SITE_RANDAO = faults.site("stf.engine.randao")
_SITE_OPERATIONS = faults.site("stf.engine.operations")
_SITE_STATE_ROOT = faults.site("stf.engine.state_root")
_SITE_NATIVE_GATE = faults.site("stf.engine.native_gate")
_SITE_CACHE_COMMIT = faults.site("stf.engine.cache_commit")
_SITE_MIRROR_READ = faults.site("stf.engine.mirror_read")
_SITE_MIRROR_FLUSH = faults.site("stf.engine.mirror_flush")

stats = {
    "fast_blocks": 0,
    "replayed_blocks": 0,
    "fast_path_errors": 0,
    "breaker_trips": 0,
    "breaker_probes": 0,
    "breaker_skipped": 0,
    "breaker_state": "closed",
    "replay_reasons": {},
    "sig_verify_s": 0.0,
    "attestation_apply_s": 0.0,
    # attestation_apply_s attributed: plan resolution (memo probes + cold
    # committee gathers), the state-application loop, and the
    # participation mirror flush — a regression names its phase instead
    # of moving one opaque number
    "resolve_s": 0.0,
    "apply_s": 0.0,
    "mirror_flush_s": 0.0,
    "sync_apply_s": 0.0,
    "slot_roots_s": 0.0,
    "other_s": 0.0,
    # of other_s: bellatrix's literal process_execution_payload (the
    # payload's header cached, its transactions hashed)
    "execution_payload_s": 0.0,
}


def reset_stats() -> None:
    """Zero ALL engine counters — the per-block phase/fallback dict here,
    the signature-settlement counters in stf/verify.py, and the pipeline's
    overlap accounting (one call, so bench rows can't accidentally report
    cumulative halves) — and re-arm the circuit breaker (counters and
    live state reset together, so a bench leg can't inherit the previous
    leg's open breaker)."""
    for k in stats:
        if isinstance(stats[k], float):
            stats[k] = 0.0
        elif isinstance(stats[k], dict):
            stats[k] = {}
        elif isinstance(stats[k], int):
            stats[k] = 0
    _breaker.update(consecutive_errors=0, open=False, since_skipped=0)
    stats["breaker_state"] = "closed"
    verify.reset_stats()
    pipeline.reset_stats()
    # per-phase latency distributions reset with the counters they
    # attribute, so a bench pass's p50/p99 describe exactly that pass
    histogram.reset()


def _count_reason(reason: str) -> None:
    reasons = stats["replay_reasons"]
    reasons[reason] = reasons.get(reason, 0) + 1


def _native_available() -> bool:
    try:
        from consensus_specs_tpu_torch.crypto.bls import native  # noqa: F401
        return True
    except ImportError:
        return False


def _fast_path_ready(spec) -> bool:
    """The gate: covered fork family, native backend importable AND not
    degraded (a crashed backend demotes every block to the literal
    replay — see stf/verify._degrade)."""
    ok = (getattr(spec, "fork", None) in FAST_FORKS
          and _native_available() and not verify.native_degraded())
    return bool(_SITE_NATIVE_GATE(ok))


# -- circuit breaker -----------------------------------------------------------

def _breaker_note_success() -> None:
    _breaker["consecutive_errors"] = 0
    if _breaker["open"]:
        _breaker["open"] = False
        _breaker["since_skipped"] = 0
        stats["breaker_state"] = "closed"
        tracing.count("stf.breaker_closed")
        recorder.record("breaker_close")


def _breaker_note_error() -> None:
    _breaker["consecutive_errors"] += 1
    if _breaker["open"]:
        # a failed recovery probe: stay open, restart the skip countdown
        _breaker["since_skipped"] = 0
        recorder.record("breaker_probe_failed")
        return
    if _breaker["consecutive_errors"] >= BREAKER_THRESHOLD:
        _breaker["open"] = True
        _breaker["since_skipped"] = 0
        stats["breaker_trips"] += 1
        stats["breaker_state"] = "open"
        tracing.count("stf.breaker_tripped")
        recorder.record("breaker_open",
                        consecutive_errors=_breaker["consecutive_errors"])


def _breaker_allows_attempt() -> bool:
    """False while the breaker is open and this block is not a probe."""
    if not _breaker["open"]:
        return True
    _breaker["since_skipped"] += 1
    if _breaker["since_skipped"] % BREAKER_PROBE_INTERVAL == 0:
        stats["breaker_probes"] += 1
        tracing.count("stf.breaker_probe")
        recorder.record("breaker_probe")
        return True
    return False


def apply_signed_blocks(spec, state, signed_blocks, validate_result: bool = True):
    """Apply ``signed_blocks`` to ``state`` in place, semantically
    identical to ``for sb in signed_blocks: spec.state_transition(state,
    sb, validate_result)`` — same post-states on success, same exception
    and partial state on the first invalid block.

    With the overlapped pipeline enabled (``pipeline.ENABLED``, the
    default) and no cache transaction already open (a re-entrant call
    joins the caller's block and must stay synchronous), blocks run
    through the speculative cross-block path; otherwise the serial
    one-block-at-a-time path.  Both land byte-identical results."""
    if pipeline.ENABLED and staging.current() is None:
        return _apply_pipelined(spec, state, signed_blocks, validate_result)
    for signed_block in signed_blocks:
        _apply_one(spec, state, signed_block, validate_result)
    return state


def _replay_breaker_open(spec, state, signed_block, validate_result: bool,
                         rec: bool) -> None:
    """The open-breaker skip: accounting + literal replay, shared by the
    serial and pipelined paths so their stats can never drift."""
    stats["replayed_blocks"] += 1
    stats["breaker_skipped"] += 1
    _count_reason("breaker_open")
    tracing.count("stf.replayed_block")
    if rec:
        recorder.record("block_replayed",
                        slot=int(signed_block.message.slot),
                        reason="breaker_open")
    spec.state_transition(state, signed_block, validate_result)


def _apply_one(spec, state, signed_block, validate_result: bool) -> None:
    # flight-recorder + timeline gates hoisted once per block: per-event
    # field computation (slot reads, stats deltas, link ids) is paid only
    # while an observer is armed
    rec = recorder.enabled()
    link = timeline.next_link() if timeline.enabled() else None
    if not _breaker_allows_attempt():
        _replay_breaker_open(spec, state, signed_block, validate_result, rec)
        return
    pre_backing = state.get_backing()
    snap = _block_snapshot() if rec else None
    try:
        if not _fast_path_ready(spec):
            # uncovered forks keep their own kernel substitutions + the
            # facade's deferred per-block batch
            raise FastPathViolation(
                "fast path covers phase0/altair/bellatrix + native BLS")
        with staging.block_transaction():
            _fast_transition(spec, state, signed_block, validate_result,
                             link=link)
            # the commit itself is a probed seam: a torn commit rolls the
            # staged entries back and the block replays literally
            _SITE_CACHE_COMMIT()
        stats["fast_blocks"] += 1
        _breaker_note_success()
        tracing.count("stf.fast_block")
        if rec:
            # after the transaction settled (OB01 discipline: a rolled
            # back block must never log a fast application)
            recorder.record("block_fast",
                            slot=int(signed_block.message.slot),
                            **_block_delta(snap))
    except Exception as exc:
        state.set_backing(pre_backing)
        # the fast-path spans describe work that just rolled back: mark
        # the block's flow cancelled before the literal replay re-does it
        timeline.cancel_link(link)
        if isinstance(exc, KernelError):
            raise
        _replay_literal(spec, state, signed_block, validate_result, exc, rec)


# phase attribution captured per block by the flight recorder (deltas of
# the cumulative stats above, plus the plan/h2c cache movement)
_PHASE_KEYS = ("slot_roots_s", "sig_verify_s", "attestation_apply_s",
               "sync_apply_s", "other_s")


def _h2c_stats():
    """The native hash_to_g2 cache counters, via sys.modules so a block
    applied without the native backend never imports it as a side effect."""
    native = sys.modules.get("consensus_specs_tpu_torch.crypto.bls.native")
    if native is None:
        return None
    try:
        return native.h2c_cache_stats()
    except Exception:  # counter read must never fail a block
        return None


def _block_snapshot() -> dict:
    """Pre-block counter snapshot (recorder-enabled path only)."""
    from . import attestations

    snap = {k: stats[k] for k in _PHASE_KEYS}
    snap["plan_hits"] = attestations.stats["plan_hits"]
    snap["plan_misses"] = attestations.stats["plan_misses"]
    h2c = _h2c_stats()
    if h2c is not None:
        snap["h2c_hits"] = h2c["hits"]
        snap["h2c_misses"] = h2c["misses"]
    return snap


def _block_delta(snap: dict) -> dict:
    """This block's phase timings and cache movement, as deltas of the
    cumulative counters against the pre-block snapshot."""
    from . import attestations

    out = {k: round(stats[k] - snap[k], 6) for k in _PHASE_KEYS}
    out["plan_hits"] = attestations.stats["plan_hits"] - snap["plan_hits"]
    out["plan_misses"] = (attestations.stats["plan_misses"]
                          - snap["plan_misses"])
    if "h2c_hits" in snap:
        h2c = _h2c_stats()
        if h2c is not None:
            out["h2c_hits"] = h2c["hits"] - snap["h2c_hits"]
            out["h2c_misses"] = h2c["misses"] - snap["h2c_misses"]
    return out


def _collect_block(spec, state, signed_block, validate_result: bool,
                   spec_keys, link=None) -> tuple:
    """One block's host phases: slot advancement, header/RANDAO/eth1,
    operations with the vectorized attestation path, sync aggregate —
    every state mutation of the fast path, with the block's signature
    checks collected (not settled) as materialized batch entries.
    Returns ``(entries, keys, t_host_done)``; both settlement styles
    (serial ``_fast_transition``, pipelined ``_begin_block``) build on
    it.  ``spec_keys`` is the pending predecessor's dispatched key set —
    triples it is already verifying are skipped speculatively
    (verify.note_speculative_hit; safe because any predecessor failure
    drains this block too).  ``link`` is the block's timeline causality
    id: every host-phase span carries it, so the Chrome-trace export can
    chain this block's flow across threads (None with the timeline
    off)."""
    from consensus_specs_tpu_torch.crypto import bls

    block = signed_block.message
    altair_lineage = spec.fork != "phase0"
    t0 = time.perf_counter()
    with timeline.span("host/slot_roots", link=link, slot=int(block.slot)):
        slot_roots.process_slots(spec, state, block.slot)
    t1 = time.perf_counter()
    stats["slot_roots_s"] += t1 - t0
    histogram.observe("slot_roots", t1 - t0)

    bls_on = bls.bls_active
    entries, keys = [], []

    def collect(members_id, count, flat, message, signature):
        key = verify.triple_key(members_id, message, signature)
        if verify.is_verified(key):
            return
        if spec_keys is not None and key in spec_keys:
            verify.note_speculative_hit()
            return
        entries.append((count, flat(), message, signature))
        keys.append(key)

    if validate_result and bls_on:
        _proposer_entry(spec, state, signed_block, collect)
    t2 = time.perf_counter()

    # process_block shape of the block's own fork (phase0.py:1149-1154,
    # altair.py:405-410, bellatrix.py:242-249): header/RANDAO/attestations/
    # sync aggregate run the vectorized or collect-don't-verify variants
    # below; the remaining operations are the spec's own functions
    with timeline.span("host/operations", link=link):
        _header(spec, state, block)
        if spec.fork == "bellatrix" and spec.is_execution_enabled(state, block.body):
            # [New in Bellatrix] — literal, inside the snapshot-protected
            # region: payload checks raise straight into the replay
            # contract; its seconds land in other_s
            t_payload = time.perf_counter()
            spec.process_execution_payload(
                state, block.body.execution_payload, spec.EXECUTION_ENGINE)
            stats["execution_payload_s"] += time.perf_counter() - t_payload
        _randao_collect(spec, state, block.body, collect, bls_on)
        spec.process_eth1_data(state, block.body)
        t3 = time.perf_counter()
        # _attestations times itself into attestation_apply_s; the remaining
        # operations (slashings, deposits, exits) belong to other_s so a
        # regression in e.g. process_deposit localizes honestly
        apply_before = stats["attestation_apply_s"]
        _operations(spec, state, block.body, collect, bls_on, altair_lineage)
        t4 = time.perf_counter()
    non_attestation_ops = (t4 - t3) - (stats["attestation_apply_s"] - apply_before)
    if altair_lineage:
        with timeline.span("host/sync_aggregate", link=link):
            sync.process_sync_aggregate(
                spec, state, block.body.sync_aggregate, collect, bls_on)
    t4s = time.perf_counter()
    stats["sync_apply_s"] += t4s - t4
    if altair_lineage:
        histogram.observe("sync_apply", t4s - t4)
    stats["sig_verify_s"] += t2 - t1
    stats["other_s"] += (t3 - t2) + non_attestation_ops
    return entries, keys, t4s


def _fast_transition(spec, state, signed_block, validate_result: bool,
                     link=None) -> None:
    """Serial settlement (pipeline OFF / re-entrant calls): host phases,
    then the one synchronous multi-pairing, then the post-state root."""
    entries, keys, t4s = _collect_block(
        spec, state, signed_block, validate_result, None, link=link)
    bad = verify.settle(entries, keys, link=link)
    if bad is not None:
        raise FastPathViolation(f"invalid signature (batch entry {bad})")
    t5 = time.perf_counter()
    histogram.observe("sig_verify", t5 - t4s)
    if validate_result:
        with timeline.span("host/state_root", link=link):
            computed = _SITE_STATE_ROOT(
                bytes(slot_roots.state_root(spec, state)))
        if bytes(signed_block.message.state_root) != computed:
            raise FastPathViolation("state root mismatch")
    t6 = time.perf_counter()
    stats["sig_verify_s"] += t5 - t4s
    stats["other_s"] += t6 - t5


# -- cross-block overlapped pipeline ------------------------------------------


class _Speculation:
    """One block whose host phases are applied and whose signature batch
    is in flight: everything needed to settle it (commit + memo keys) or
    unwind it (open transaction + backing snapshot + literal replay)."""

    __slots__ = ("signed_block", "slot", "index", "pre_backing", "txn",
                 "handle", "keys_set", "rec_delta", "link")

    def __init__(self, signed_block, pre_backing, txn, handle, keys_set,
                 link=None):
        self.signed_block = signed_block
        self.slot = int(signed_block.message.slot)
        self.index = -1  # position in the call's block list (set by the loop)
        self.pre_backing = pre_backing
        self.txn = txn
        self.handle = handle
        self.keys_set = keys_set
        self.rec_delta = None
        self.link = link  # timeline causality id (None with timeline off)


def _begin_block(spec, state, signed_block, validate_result: bool,
                 spec_keys, rec: bool, link=None) -> _Speculation:
    """Apply one block's host phases under a fresh (open) cache
    transaction and dispatch its signature batch; the post-state root is
    checked here (its inputs are complete — only the verdict is
    outstanding).  On any exception the partial work is fully unwound —
    own batch discarded, transaction rolled back, backing restored —
    before the exception propagates into the caller's replay handling."""
    pre_backing = state.get_backing()
    snap = _block_snapshot() if rec else None
    txn = staging.begin_block()
    handle = None
    try:
        entries, keys, t4s = _collect_block(
            spec, state, signed_block, validate_result, spec_keys, link=link)
        if entries:
            handle = pipeline.dispatch(entries, link=link)
            # the memo commit stays deferred through the block's own
            # transaction: it runs only at commit_block, after the
            # verdict — speculated verification never leaks into a
            # rolled-back block (EF01/OB01 discipline)
            verify.stage_commit(keys)
        t5 = time.perf_counter()
        stats["sig_verify_s"] += t5 - t4s
        if validate_result:
            with timeline.span("host/state_root", link=link):
                computed = _SITE_STATE_ROOT(
                    bytes(slot_roots.state_root(spec, state)))
            if bytes(signed_block.message.state_root) != computed:
                raise FastPathViolation("state root mismatch")
            stats["other_s"] += time.perf_counter() - t5
    except BaseException:
        pipeline.discard(handle)
        staging.rollback_block(txn)
        state.set_backing(pre_backing)
        timeline.cancel_link(link)
        raise
    finally:
        staging.deactivate(txn)
    pend = _Speculation(signed_block, pre_backing, txn, handle,
                        frozenset(keys) if keys else frozenset(),
                        link=link)
    if rec:
        # host-phase attribution captured NOW (the block's own work);
        # the settlement await is added at finish so the recorded block
        # never charges the successor's host phases to this block
        pend.rec_delta = _block_delta(snap)
    return pend


def _finish_speculation(pend: _Speculation, rec: bool):
    """Await ``pend``'s verdict and settle its transaction.  Returns None
    on success (fast-block bookkeeping done) or the exception that must
    drive the literal replay — the CALLER unwinds state, successor first
    (LIFO), because blocks may already be speculated on top."""
    a0 = pipeline.stats["await_s"]
    try:
        with timeline.span("host/await_verdict", link=pend.link):
            bad = (pipeline.wait(pend.handle)
                   if pend.handle is not None else None)
    except Exception as exc:
        return exc
    finally:
        awaited = pipeline.stats["await_s"] - a0
        stats["sig_verify_s"] += awaited
        histogram.observe("pipeline_await", awaited)
        if pend.handle is not None:
            # the sig_verify DISTRIBUTION keeps one meaning pipeline ON
            # or OFF: the batch's true wall time on the native backend
            # (the worker span), not the non-overlapped remainder the
            # cumulative sig_verify_s counter attributes
            ws = pend.handle.worker_span
            histogram.observe("sig_verify", max(0.0, ws[1] - ws[0]))
        if pend.rec_delta is not None:
            pend.rec_delta["sig_verify_s"] = round(
                pend.rec_delta["sig_verify_s"] + awaited, 6)
    if bad is not None:
        return FastPathViolation(f"invalid signature (batch entry {bad})")
    try:
        # the commit itself is a probed seam (same as the serial path): a
        # torn commit rolls the staged entries back and the block replays
        _SITE_CACHE_COMMIT()
        staging.commit_block(pend.txn)
    except Exception as exc:
        return exc
    stats["fast_blocks"] += 1
    _breaker_note_success()
    tracing.count("stf.fast_block")
    timeline.instant("commit", link=pend.link, slot=pend.slot)
    if rec and pend.rec_delta is not None:
        recorder.record("block_fast", slot=pend.slot, **pend.rec_delta)
    return None


def _account_failure(exc: BaseException) -> None:
    """The serial except-branch bookkeeping, shared with the pipeline."""
    if not isinstance(exc, FastPathViolation):
        stats["fast_path_errors"] += 1
        _breaker_note_error()
    _count_reason(type(exc).__name__)
    stats["replayed_blocks"] += 1
    tracing.count("stf.replayed_block")


def _replay_literal(spec, state, signed_block, validate_result: bool,
                    exc: BaseException, rec: bool) -> None:
    """Account a fast-path failure and replay the block through the
    literal spec (raising the spec's own exception, or succeeding)."""
    _account_failure(exc)
    if rec:
        recorder.record("block_replayed",
                        slot=int(signed_block.message.slot),
                        reason=type(exc).__name__,
                        detail=str(exc)[:160])
    spec.state_transition(state, signed_block, validate_result)


def _unwind_pending(state, pend: _Speculation) -> None:
    """Roll a failed pending block back: any still-unconsumed batch
    drained and discarded (a drain-seam fault can leave one), the open
    transaction popped, and the backing restored to its pre-block
    snapshot (also erasing any successor host mutations stacked on top —
    the caller unwound the successor's own transaction first)."""
    pipeline.discard(pend.handle)
    staging.rollback_block(pend.txn)
    state.set_backing(pend.pre_backing)


def _apply_pipelined(spec, state, signed_blocks, validate_result: bool):
    """The overlapped engine loop: begin block i (host phases + async
    dispatch), then settle the window down to ``_WINDOW_DEPTH``
    outstanding verdicts — so speculated blocks' native pairings run
    concurrently with up to ``_WINDOW_DEPTH`` later blocks' host work
    (the extra slack absorbs per-block jitter a one-deep window leaks as
    await time).  Any failure drains LIFO — newer speculations unwound first,
    then the failing block restores its snapshot and replays literally —
    and the loop resumes at the block after the failure, so recovery
    re-runs everything whose host phases rode the dead state.  The
    pipeline always drains before returning (no verdict outlives a
    call).  A ``KernelError`` in a block's host phases settles the blocks
    before it and is then raised, leaving the state after the last of
    them, as the serial path does."""
    blocks = list(signed_blocks)
    window = []  # oldest-first _Speculations with verdicts outstanding

    def settle(target_len: int, drain_reason, rec: bool):
        """Settle the window (oldest first) down to ``target_len``.
        Returns None when every settled block committed, else the index
        to resume the main loop at (the failed block replayed literally
        — raising the spec's exception unless the replay recovered —
        and every NEWER speculation unwound LIFO first, its host phases
        having ridden a state that no longer exists)."""
        if drain_reason is not None and window:
            pipeline.note_drain(drain_reason)
            timeline.instant("pipeline_drain", link=window[0].link,
                             reason=drain_reason)
            if rec:
                recorder.record("pipeline_drain", reason=drain_reason,
                                slot=window[0].slot)
        while len(window) > target_len:
            pend = window[0]
            fail = _finish_speculation(pend, rec)
            if fail is None:
                window.pop(0)
                continue
            if drain_reason is None:
                pipeline.note_drain("verdict_failed")
                timeline.instant("pipeline_drain", link=pend.link,
                                 reason="verdict_failed")
                if rec:
                    recorder.record("pipeline_drain",
                                    reason="verdict_failed",
                                    slot=pend.slot)
            for newer in reversed(window[1:]):
                pipeline.discard(newer.handle)
                staging.rollback_block(newer.txn)
            # one ring pass marks the WHOLE drained window cancelled —
            # the failing block included (_unwind_pending no longer
            # rescans for it)
            timeline.cancel_links([n.link for n in window])
            del window[:]
            _unwind_pending(state, pend)
            _replay_literal(spec, state, pend.signed_block,
                            validate_result, fail, rec)
            return pend.index + 1
        return None

    i = 0

    def settle_then_replay(reason: str, exc, rec: bool):
        """The shared ineligible/failed-block shape: settle the whole
        window (drain-tagged when one was open), then — unless a window
        failure rewound the loop — replay the current block literally.
        Returns the next loop index."""
        resume = settle(0, reason if window else None, rec)
        if resume is not None:
            return resume
        _replay_literal(spec, state, blocks[i], validate_result, exc, rec)
        return i + 1

    while True:
        if i >= len(blocks):
            if not window:
                break
            resume = settle(0, None, recorder.enabled())
            if resume is not None:
                i = resume
            continue
        signed_block = blocks[i]
        rec = recorder.enabled()
        if not _breaker_allows_attempt():
            resume = settle(0, "breaker_open" if window else None, rec)
            if resume is not None:
                i = resume
                continue
            _replay_breaker_open(spec, state, signed_block, validate_result,
                                 rec)
            i += 1
            continue
        try:
            ready = _fast_path_ready(spec)
        except Exception as exc_gate:
            # the availability gate is a probed seam: a dying gate must
            # resolve like any fast-path error (serial-path parity)
            i = settle_then_replay("gate_failed", exc_gate, rec)
            continue
        if not ready:
            i = settle_then_replay(
                "fast_path_unready",
                FastPathViolation(
                    "fast path covers phase0/altair/bellatrix + native BLS"),
                rec)
            continue
        spec_keys = (frozenset().union(*(p.keys_set for p in window))
                     if window else None)
        link = timeline.next_link() if timeline.enabled() else None
        try:
            cur = _begin_block(spec, state, signed_block, validate_result,
                               spec_keys, rec, link=link)
        except KernelError:
            # the partial current block is already unwound; its
            # predecessors settle (a failed one rewinds the loop) before
            # the error is raised
            resume = settle(0, "kernel_error" if window else None, rec)
            if resume is None:
                raise
            i = resume
            continue
        except Exception as exc_begin:
            # the partial current block is already unwound; settle its
            # predecessors first (sequential order), then replay it
            i = settle_then_replay("begin_failed", exc_begin, rec)
            continue
        cur.index = i
        window.append(cur)
        i += 1
        resume = settle(_WINDOW_DEPTH, None, rec)
        if resume is not None:
            i = resume
    return state


def _proposer_entry(spec, state, signed_block, collect) -> None:
    """verify_block_signature (phase0.py:777-780) as one batch entry."""
    block = signed_block.message
    proposer = state.validators[block.proposer_index]
    signing_root = spec.compute_signing_root(
        block, spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER))
    pk = bytes(proposer.pubkey)
    collect(pk, 1, lambda: _single_affine(pk),
            bytes(signing_root), bytes(signed_block.signature))


def _single_affine(pubkey: bytes) -> bytes:
    from consensus_specs_tpu_torch.crypto.bls import native

    xy = native.pubkey_affine(pubkey)
    if xy is None:
        raise FastPathViolation("unverifiable pubkey")
    return xy


def _header(spec, state, block) -> None:
    """process_block_header (phase0.py:1156-1176) with the proposer check
    against the numpy-active fast proposer walk."""
    assert block.slot == state.slot
    assert block.slot > state.latest_block_header.slot
    assert block.proposer_index == beacon_proposer_index(spec, state)
    assert block.parent_root == spec.hash_tree_root(state.latest_block_header)
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=spec.Bytes32(),  # Overwritten in the next process_slot call
        body_root=spec.hash_tree_root(block.body),
    )
    proposer = state.validators[block.proposer_index]
    assert not proposer.slashed
    # probed AFTER the header write: a fault here proves the rollback
    # restores the mutated latest_block_header
    _SITE_HEADER()


def _randao_collect(spec, state, body, collect, bls_on) -> None:
    """process_randao (phase0.py:1179-1187) with the reveal's pairing
    check deferred into the block batch."""
    epoch = spec.get_current_epoch(state)
    proposer = state.validators[beacon_proposer_index(spec, state)]
    if bls_on:
        signing_root = spec.compute_signing_root(
            epoch, spec.get_domain(state, spec.DOMAIN_RANDAO))
        pk = bytes(proposer.pubkey)
        collect(pk, 1, lambda: _single_affine(pk),
                bytes(signing_root), bytes(body.randao_reveal))
    mix = spec.xor(spec.get_randao_mix(state, epoch),
                   spec.hash(body.randao_reveal))
    state.randao_mixes[epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR] = mix
    _SITE_RANDAO()  # post-mix-write: rollback must restore randao_mixes


def _operations(spec, state, body, collect, bls_on, altair_lineage) -> None:
    """process_operations (phase0.py:1196-1208; altair inherits the same
    dispatch shape) with the attestation loop replaced by the whole-block
    vectorized path of the block's fork family."""
    assert len(body.deposits) == min(
        spec.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index)

    for operation in body.proposer_slashings:
        spec.process_proposer_slashing(state, operation)
    for operation in body.attester_slashings:
        spec.process_attester_slashing(state, operation)
    _SITE_OPERATIONS()  # mid-operations: slashings applied, rest pending
    _attestations(spec, state, body.attestations, collect, bls_on,
                  altair_lineage)
    for operation in body.deposits:
        spec.process_deposit(state, operation)
    for operation in body.voluntary_exits:
        spec.process_voluntary_exit(state, operation)


def _attestations(spec, state, attestations, collect, bls_on,
                  altair_lineage) -> None:
    """The block's process_attestation loop, vectorized: one resolution
    pass, one bulk attester-set reduction, then the fork family's state
    application — pending-attestation appends (phase0.py:1249-1275) or
    participation-flag scatter (altair.py:413-446) — and one signature
    entry per aggregate."""
    if len(attestations) == 0:
        return
    t0 = time.perf_counter()
    try:
        if altair_lineage:
            _attestations_inner_altair(spec, state, attestations, collect,
                                       bls_on)
        else:
            _attestations_inner(spec, state, attestations, collect, bls_on)
    finally:
        dt = time.perf_counter() - t0
        stats["attestation_apply_s"] += dt
        histogram.observe("attestation_apply", dt)


def _attester_domains(spec, state, resolver) -> dict:
    """The (at most two) beacon-attester domains a block's attestations
    can sign under, computed once per block.  ``compute_signing_root`` of
    an attestation then reduces to one sha256 of (data root || domain) —
    the SigningData container's own merkleization shape — instead of a
    per-attestation container build."""
    return {
        epoch: bytes(spec.get_domain(
            state, spec.DOMAIN_BEACON_ATTESTER, spec.Epoch(epoch)))
        for epoch in {resolver.previous_epoch, resolver.current_epoch}
    }


def _attestations_inner(spec, state, attestations, collect, bls_on) -> None:
    t0 = time.perf_counter()
    resolver = resolve_block_attestations(spec, state)
    plans = resolver.resolve(attestations)
    t1 = time.perf_counter()
    stats["resolve_s"] += t1 - t0
    tracing.count("stf.attestations", len(plans))

    # identical for every attestation in the block: state.slot is fixed and
    # process_block_header already pinned it to the block's proposer.
    # Every loop-invariant view is hoisted — at 122 aggregates/block the
    # per-attestation SSZ field chains were a measurable apply_s share
    proposer_index = beacon_proposer_index(spec, state)
    current_epoch = resolver.current_epoch
    validators = state.validators
    registry_root = bytes(validators.hash_tree_root())
    domains = _attester_domains(spec, state, resolver) if bls_on else None
    state_slot = state.slot
    cur_justified = state.current_justified_checkpoint
    prev_justified = state.previous_justified_checkpoint
    cur_pendings = state.current_epoch_attestations
    prev_pendings = state.previous_epoch_attestations
    PendingAttestation = spec.PendingAttestation

    for att, plan in zip(attestations, plans):
        data = att.data
        pending = PendingAttestation(
            data=data,
            aggregation_bits=att.aggregation_bits,
            inclusion_delay=state_slot - data.slot,
            proposer_index=proposer_index,
        )
        if plan.target_epoch == current_epoch:
            if data.source != cur_justified:
                raise FastPathViolation("source != current justified")
            cur_pendings.append(pending)
        else:
            if data.source != prev_justified:
                raise FastPathViolation("source != previous justified")
            prev_pendings.append(pending)
        if bls_on:
            attesters = plan.attesters
            signing_root = hashlib.sha256(
                plan.data_root + domains[plan.target_epoch]).digest()
            collect(registry_root + attesters.tobytes(), len(attesters),
                    lambda a=attesters: affine_rows(validators, a),
                    signing_root, bytes(att.signature))
    stats["apply_s"] += time.perf_counter() - t1


class _FlagMaskContext:
    """Per-block context for ``get_attestation_participation_flag_indices``
    (altair.py:303-330) as a bit mask, with the spec's ``assert
    is_matching_source`` mapped to the replay contract.  Everything
    loop-invariant — the justified checkpoints, the spec constants, and
    the (at most two) target-epoch block roots and (typically two)
    per-slot head roots — is computed once per block instead of once per
    attestation; the matching-target/head short-circuits and the
    ``get_block_root*`` raise points are preserved (memoized lookups
    raise at the same first-use point the spec's per-attestation call
    would, and a successful lookup would have re-succeeded identically)."""

    __slots__ = ("spec", "state", "state_slot", "cur_justified",
                 "prev_justified", "sqrt_spe", "spe", "min_delay",
                 "src_bit", "tgt_bit", "head_bit", "_target_roots",
                 "_head_roots")

    def __init__(self, spec, state, resolver):
        self.spec = spec
        self.state = state
        self.state_slot = resolver.state_slot
        self.cur_justified = state.current_justified_checkpoint
        self.prev_justified = state.previous_justified_checkpoint
        self.sqrt_spe = int(spec.integer_squareroot(spec.SLOTS_PER_EPOCH))
        self.spe = int(spec.SLOTS_PER_EPOCH)
        self.min_delay = int(spec.MIN_ATTESTATION_INCLUSION_DELAY)
        self.src_bit = 1 << int(spec.TIMELY_SOURCE_FLAG_INDEX)
        self.tgt_bit = 1 << int(spec.TIMELY_TARGET_FLAG_INDEX)
        self.head_bit = 1 << int(spec.TIMELY_HEAD_FLAG_INDEX)
        self._target_roots: dict = {}
        self._head_roots: dict = {}

    def mask(self, data, target_epoch: int, is_current: bool) -> int:
        justified = self.cur_justified if is_current else self.prev_justified
        if data.source != justified:
            raise FastPathViolation("source != justified checkpoint")
        slot = int(data.slot)
        inclusion_delay = self.state_slot - slot
        target_root = self._target_roots.get(target_epoch)
        if target_root is None:
            target_root = self._target_roots[target_epoch] = bytes(
                self.spec.get_block_root(self.state, data.target.epoch))
        is_matching_target = bytes(data.target.root) == target_root
        if is_matching_target:
            head_root = self._head_roots.get(slot)
            if head_root is None:
                head_root = self._head_roots[slot] = bytes(
                    self.spec.get_block_root_at_slot(self.state, data.slot))
            is_matching_head = bytes(data.beacon_block_root) == head_root
        else:
            is_matching_head = False
        mask = 0
        if inclusion_delay <= self.sqrt_spe:
            mask |= self.src_bit
        if is_matching_target and inclusion_delay <= self.spe:
            mask |= self.tgt_bit
        if is_matching_head and inclusion_delay == self.min_delay:
            mask |= self.head_bit
        return mask


def _attestations_inner_altair(spec, state, attestations, collect, bls_on) -> None:
    """The altair-lineage process_attestation loop (altair.py:413-446),
    vectorized: the same plan-cached whole-block resolution as phase0,
    then per attestation a participation-flag OR-scatter on a staged view
    of the resident epoch participation column (stf/columns.py — a dict
    probe after the first block, not a tree walk), the proposer-reward
    numerator as one masked increment sum per newly-set flag, and one
    signature entry per aggregate.  Staged views flush as ONE packed
    write per dirtied column (re-registered under the column's new root,
    so the NEXT block's read hits residency) and the proposer reward
    lands as one balance write (per-attestation floor division preserved
    — the spec divides before each increase)."""
    import numpy as np

    from consensus_specs_tpu_torch.ops.epoch import registry_columns

    t_res0 = time.perf_counter()
    resolver = resolve_block_attestations(spec, state)
    plans = resolver.resolve(attestations)
    t_res1 = time.perf_counter()
    stats["resolve_s"] += t_res1 - t_res0
    tracing.count("stf.attestations", len(plans))

    proposer_index = beacon_proposer_index(spec, state)
    current_epoch = resolver.current_epoch
    validators = state.validators
    registry_root = bytes(validators.hash_tree_root())
    domains = _attester_domains(spec, state, resolver) if bls_on else None

    # participation mirrors: staged views of the resident columns, read
    # lazily once per block, written back once per dirtied column after
    # the loop (deposits append only later in process_operations, so the
    # column length is stable here).  ``resident`` keeps the store's
    # readonly original so a column whose bits were all already set (a
    # block of re-carried aggregates) skips the flush AND the subtree
    # re-hash its packed write would force.
    staged, resident = {}, {}

    def column_for(is_current):
        col = staged.get(is_current)
        if col is None:
            resident[is_current] = columns.participation_column(
                state, is_current)
            # probed between read and use: a corrupted mirror must be
            # caught by the post-state root check, never flushed silently
            col = staged[is_current] = _SITE_MIRROR_READ(
                columns.staged_view(state, is_current))
        return col

    # exact get_base_reward column: effective // increment * per-increment
    # (both constant within a block — effective balances only move at the
    # epoch boundary)
    increments = (registry_columns(state)["effective_balance"]
                  // int(spec.EFFECTIVE_BALANCE_INCREMENT))
    per_increment = int(spec.get_base_reward_per_increment(state))
    weights = [int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS]
    weight_denominator = int(spec.WEIGHT_DENOMINATOR)
    proposer_weight = int(spec.PROPOSER_WEIGHT)
    denominator = ((weight_denominator - proposer_weight)
                   * weight_denominator // proposer_weight)
    proposer_reward_total = 0
    flag_ctx = _FlagMaskContext(spec, state, resolver)

    for att, plan in zip(attestations, plans):
        data = att.data
        attesters = plan.attesters
        is_current = plan.target_epoch == current_epoch
        mask = flag_ctx.mask(data, plan.target_epoch, is_current)
        column = column_for(is_current)
        held = column[attesters]
        numerator = 0
        for flag_index, weight in enumerate(weights):
            bit = 1 << flag_index
            if not mask & bit:
                continue
            newly = attesters[(held & bit) == 0]
            if len(newly):
                numerator += int(
                    np.sum(increments[newly], dtype=np.uint64)) * weight
        column[attesters] = held | np.uint8(mask)
        # the spec floors the division per attestation, then increases the
        # proposer balance; summing the floored rewards is exact
        proposer_reward_total += numerator * per_increment // denominator
        if bls_on:
            signing_root = hashlib.sha256(
                plan.data_root + domains[plan.target_epoch]).digest()
            collect(registry_root + attesters.tobytes(), len(attesters),
                    lambda a=attesters: affine_rows(validators, a),
                    signing_root, bytes(att.signature))
    t_apply = time.perf_counter()
    stats["apply_s"] += t_apply - t_res1

    _SITE_MIRROR_FLUSH()  # pre-flush: mirrors dirty, state still clean
    for is_current, col in staged.items():
        if not np.array_equal(col, resident[is_current]):
            columns.flush(state, is_current, col)
    if proposer_reward_total:
        # Gwei() raises on uint64 overflow exactly where the spec's
        # sequential += would have (increments are non-negative)
        state.balances[proposer_index] = spec.Gwei(
            int(state.balances[proposer_index]) + proposer_reward_total)
    dt_flush = time.perf_counter() - t_apply
    stats["mirror_flush_s"] += dt_flush
    histogram.observe("mirror_flush", dt_flush)


# -- telemetry ----------------------------------------------------------------


def _telemetry_provider() -> dict:
    """The engine's cumulative counters + the breaker's live internals
    (consecutive-error count and skip countdown — the two numbers that
    predict the NEXT transition, which the state string alone hides)."""
    return {
        **{k: v for k, v in stats.items() if k != "replay_reasons"},
        "replay_reasons": dict(stats["replay_reasons"]),
        "breaker": dict(_breaker),
    }


telemetry.register_provider("stf.engine", _telemetry_provider, replace=True)
