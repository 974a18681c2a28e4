"""Per-block signature settlement for the batched block-transition engine.

Port of ``consensus_specs_tpu/stf/verify.py``: host work only, on the
port's own copy of the native BLS library.

Every signature a block carries — proposer, RANDAO reveal, and each
aggregate attestation — asserts one pairing equation; the engine collects
them all and settles the block in ONE ``BatchFastAggregateVerify``
multi-pairing (crypto/bls/native.py: one random-linear-combination
pairing product, one shared final exponentiation).  Two accelerations on
top of the facade's deferred scope (crypto/bls/__init__.py):

* **preflattened members** — entries carry the member pubkeys as rows of
  the registry's affine-coordinate matrix (``stf/attestations.py``), so
  the native call skips the per-member ``bytes()`` + cache-dict walk the
  compressed path pays (~0.1 s/block at mainnet scale);
* **verified-triple memo** — verification is a pure function of
  ``(members, message, signature)``, so a triple that already settled in
  an earlier batch is dropped from later ones.  Mainnet blocks re-carry
  the previous slots' aggregates (the bench corpus includes every
  attestation in two consecutive blocks; gossip re-delivery does the same
  to a live node), making this worth ~2x pairing work across an epoch.

On batch failure ``first_invalid`` bisects with sub-batch calls —
O(log n) multi-pairings — to the leftmost failing entry; the engine then
rolls the block back and replays it through the literal spec path so the
offending signature raises exactly the spec's exception at exactly the
spec's point in processing (stf/engine.py).
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from consensus_specs_tpu_torch import faults, telemetry, tracing
from consensus_specs_tpu_torch.telemetry import recorder, timeline

from . import staging

# (count, flat affine members, message, signature): one pairing equation
SigEntry = Tuple[int, bytes, bytes, bytes]

_VERIFIED_MEMO: dict = {}
_VERIFIED_MEMO_MAX = 1 << 16

# fault probes: the native multi-pairing call, the
# MSM-folded interior it dispatches (probed separately so a crashed MSM is
# proven to ride the same degradation ladder as any other native death),
# the bisection walk, and the memo commit are the settlement path's
# fragile seams — each must fail into the engine's replay contract, never
# into a poisoned memo
_SITE_NATIVE_CALL = faults.site("stf.verify.native_call")
_SITE_MSM = faults.site("stf.verify.msm")
_SITE_BISECT = faults.site("stf.verify.bisect")
_SITE_MEMO_COMMIT = faults.site("stf.verify.memo_commit")

# degradation ladder: a native call that DIES (OSError/ctypes failure,
# not a clean False) marks the backend degraded — this batch settles
# through the pure-Python oracle, and the engine gates every later block
# to the literal replay until an operator resets
_NATIVE_DEGRADED = False
_DEGRADED_WARNED = False

stats = {
    "batches": 0,
    "entries": 0,
    "memo_hits": 0,
    "speculative_hits": 0,
    "bisections": 0,
    "memo_evictions": 0,
    "native_degraded": 0,
    "memo_cap": _VERIFIED_MEMO_MAX,
    # sig_verify_s split into attributable sub-phases: the native batch
    # call reports its interior (message hashing, the dual MSM folds, the
    # chunked Miller product + shared final exp) and the marshal covers
    # both C-side deserialization and the Python buffer packing, so a
    # pairing regression names its component instead of moving one opaque
    # number
    "hash_to_g2_s": 0.0,
    "msm_s": 0.0,
    "miller_s": 0.0,
    "marshal_s": 0.0,
}


def reset_stats() -> None:
    """Zero the settlement counters (``memo_cap`` is a constant readout,
    not a counter — it survives the reset; so does the degraded flag,
    which is operational state, reset via ``reset_degraded``)."""
    for k in stats:
        stats[k] = 0.0 if isinstance(stats[k], float) else 0
    stats["memo_cap"] = _VERIFIED_MEMO_MAX
    stats["native_degraded"] = int(_NATIVE_DEGRADED)


def native_degraded() -> bool:
    """True once a native batch call has crashed this process: the engine
    must stop routing blocks through the native fast path."""
    return _NATIVE_DEGRADED


def reset_degraded() -> None:
    """Clear the degraded mark (tests; an operator restoring the backend)."""
    global _NATIVE_DEGRADED, _DEGRADED_WARNED
    _NATIVE_DEGRADED = False
    _DEGRADED_WARNED = False
    stats["native_degraded"] = 0


def _degrade(exc: BaseException) -> None:
    """One-way degradation mark with a one-time traced warning: the run
    survives (pure-Python settles the in-flight batch, the engine falls
    back to literal replays) instead of dying mid-block."""
    global _NATIVE_DEGRADED, _DEGRADED_WARNED
    _NATIVE_DEGRADED = True
    stats["native_degraded"] = 1
    tracing.count("stf.native_degraded")
    recorder.record("native_degraded", error=f"{type(exc).__name__}: {exc}"[:200])
    if not _DEGRADED_WARNED:
        _DEGRADED_WARNED = True
        import warnings

        warnings.warn(
            f"native BLS batch backend crashed ({type(exc).__name__}: {exc}); "
            "degraded to pure-Python verification — fast path disabled until "
            "verify.reset_degraded()", RuntimeWarning)


def triple_key(members_id: bytes, message: bytes, signature: bytes) -> bytes:
    """Content address of one pairing equation.  ``members_id`` must bind
    the member set exactly (the engine uses registry root + the sorted
    attester-index buffer, or the raw pubkey for single-signer checks)."""
    return hashlib.sha256(members_id + message + signature).digest()


def is_verified(key: bytes) -> bool:
    """True when this triple already settled in an earlier successful
    batch — the caller may skip building (and verifying) the entry."""
    if key in _VERIFIED_MEMO:
        stats["memo_hits"] += 1
        return True
    return False


def note_speculative_hit() -> None:
    """Count a dedup hit against a PENDING (dispatched, unverdicted)
    batch's key set — the pipeline's speculative twin of a memo hit.
    Sound because the consuming block only survives if the providing
    block's batch verifies and commits: any failure drains the pipeline
    and replays both blocks literally (stf/engine.py).  Counted into
    ``memo_hits`` so the dedup ratio keeps one meaning pipeline ON or
    OFF, and separately so the overlap story is attributable."""
    stats["memo_hits"] += 1
    stats["speculative_hits"] += 1


def _verify_batch(entries: Sequence[SigEntry], seed: bytes = None) -> bool:
    """One RLC multi-pairing over ``entries`` (True iff every item holds).

    Containment: an ``InjectedFault`` (generic mid-phase error) propagates
    into the engine's replay contract; any OTHER exception out of the
    native call is a backend crash — the process marks itself degraded and
    this batch settles through the pure-Python oracle instead of dying."""
    if not entries:
        return True
    if _NATIVE_DEGRADED:
        # never re-enter a crashed backend — the bisection calls land
        # here too, so a mid-block crash stops touching native at once
        return _verify_batch_python(entries)
    from consensus_specs_tpu_torch.crypto.bls import native

    counts, flats, msgs, sigs = zip(*entries)
    try:
        _SITE_NATIVE_CALL()
        # the MSM-folded interior is probed as its own seam: a crash here
        # is indistinguishable from the bucketed fold dying inside the
        # native call, and must degrade through the same ladder
        _SITE_MSM()
        return native.BatchFastAggregateVerifyFlat(
            counts, b"".join(flats), msgs, sigs, seed=seed, stats=stats)
    except faults.InjectedFault:
        raise
    except Exception as exc:
        _degrade(exc)
        return _verify_batch_python(entries)


def _verify_batch_python(entries: Sequence[SigEntry]) -> bool:
    """Pure-Python settlement of a batch (degraded mode): each entry's
    affine members compress back to ZCash form and verify through the
    oracle ``FastAggregateVerify`` — slow, but the node stays alive and
    byte-exact while the native backend is gone."""
    from consensus_specs_tpu_torch.crypto.bls import ciphersuite
    from consensus_specs_tpu_torch.crypto.bls.curve import _HALF_P

    for count, flat, message, signature in entries:
        pks = []
        for i in range(count):
            xy = flat[96 * i: 96 * (i + 1)]
            x, y = int.from_bytes(xy[:48], "big"), int.from_bytes(xy[48:], "big")
            raw = bytearray(x.to_bytes(48, "big"))
            raw[0] |= 0x80 | (0x20 if y > _HALF_P else 0)
            pks.append(bytes(raw))
        # noqa-justified: this IS the no-native fallback — there is no
        # batch backend left to route through while degraded
        if not ciphersuite.FastAggregateVerify(pks, message, signature):  # noqa: ST01
            return False
    return True


def first_invalid(entries: Sequence[SigEntry], seed: bytes = None) -> Optional[int]:
    """Index of the FIRST failing entry, or None if the batch verifies.

    Mirrors the facade's deferred-scope bisection
    (crypto/bls/__init__.py:_first_invalid): O(log n) sub-batch
    multi-pairings, always landing on the leftmost failure so the engine's
    spec replay trips on the same signature the sequential path would
    have.

    Threading: with the overlapped pipeline ON this runs on the single
    ``stf/pipeline.py`` dispatch thread — entries are materialized (pure
    data), and the batch/entry/bisection/timing counters it touches have
    that thread as their only writer (memo hits/evictions stay
    host-side), so the stats dict needs no lock."""
    stats["batches"] += 1
    stats["entries"] += len(entries)
    if _verify_batch(entries, seed=seed):
        return None
    stats["bisections"] += 1
    lo, hi = 0, len(entries)
    # invariant: entries[:lo] all verify; at least one failure in [lo, hi)
    while hi - lo > 1:
        _SITE_BISECT()
        mid = (lo + hi) // 2
        if _verify_batch(entries[lo:mid], seed=seed):
            lo = mid
        else:
            hi = mid
    return lo


def settle(entries: List[SigEntry], keys: List[bytes],
           seed: bytes = None, link=None) -> Optional[int]:
    """Settle a block's collected signature checks; None on success, else
    the index (in call order) of the first invalid entry.

    The engine drops already-verified triples before building entries
    (``is_verified``); on success the settled triples join the memo —
    through the block's cache transaction when one is active, so the
    commit lands only after the WHOLE block settles (including the
    post-state root check), never on the strength of a block that then
    rolled back.  ``link`` is the block's timeline causality id: the
    serial path's native multi-pairing gets the same ``native/verify``
    span the pipelined worker emits, so traces read identically pipeline
    ON or OFF."""
    if not entries:
        return None
    tracing.count("stf.sig_batch")
    tracing.count("stf.sig_batch.entries", len(entries))
    with timeline.span("native/verify", link=link, entries=len(entries)):
        bad = first_invalid(entries, seed=seed)
    if bad is not None:
        return bad
    staging.defer(_commit_keys, keys)
    return None


def stage_commit(keys: List[bytes]) -> None:
    """Stage a batch's triple keys for settlement WITHOUT settling the
    batch — the overlapped pipeline's half of ``settle``: the engine
    dispatches the multi-pairing asynchronously (stf/pipeline.py) and
    stages the commit through the block's open cache transaction, so the
    keys join the memo only at ``commit_block`` — after the verdict — and
    a rolled-back speculation drops them with its transaction."""
    if keys:
        staging.defer(_commit_keys, keys)


def _commit_keys(keys: Sequence[bytes]) -> None:
    """Insert a settled block's triples (the deferred half of ``settle``;
    runs at block commit, or immediately when no transaction is active)."""
    _SITE_MEMO_COMMIT()
    for k in keys:
        _memo_put(k)


def _memo_put(key: bytes) -> None:
    """Insert one settled triple, bounding the memo at
    ``_VERIFIED_MEMO_MAX`` with FIFO eviction (dicts iterate in insertion
    order) — a long multi-epoch replay sheds its oldest triples instead of
    growing without limit, and the blocks re-carrying recent aggregates
    still hit.  Evictions are counted in ``stats`` next to the cap."""
    if key in _VERIFIED_MEMO:
        return
    while len(_VERIFIED_MEMO) >= _VERIFIED_MEMO_MAX:
        _VERIFIED_MEMO.pop(next(iter(_VERIFIED_MEMO)))
        stats["memo_evictions"] += 1
    _VERIFIED_MEMO[key] = True


def reset_memo() -> None:
    """Drop the verified-triple memo (tests; the memo is content-addressed
    so staleness is impossible, but deterministic timing runs want a cold
    start)."""
    _VERIFIED_MEMO.clear()


def _telemetry_provider() -> dict:
    """Settlement counters + the memo's live fill (the stats dict already
    carries the cap; size rides alongside so the soak harness can assert
    the bound holds)."""
    return {**stats, "memo_size": len(_VERIFIED_MEMO)}


telemetry.register_provider("stf.verify", _telemetry_provider, replace=True)
