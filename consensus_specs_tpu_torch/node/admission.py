"""Admission gate: the survival layer between ingest and apply.

An apply loop without it assumes a well-behaved mesh: every dequeued item went
straight to a spec handler, an unknown-parent block raised out of
``on_block``, and any non-gossip failure halted the loop.  Production
gossip is not well-behaved — blocks arrive before their parents,
duplicates arrive forever, payloads arrive malformed, and one flooding
peer can starve everyone.  This module classifies every dequeued item
BEFORE the spec sees it:

* **duplicate suppression** — content-root keyed, reusing the apply
  loop's dedup lesson (identity keys never fire on wire-decoded objects, so
  keys are content): blocks by ``hash_tree_root(block)`` (the same root
  ``on_block`` stores under, so the hash is computed once and cached on
  the backing node), attester slashings by their tree root, gossip
  batches by a *sketch* key — (first data root, last data root,
  first-attester bits, length).  The sketch is exact for verbatim
  re-delivery (the duplicate-flood shape) and collision-free for honest
  slot-sliced gossip (two batches from one committee differ in their
  first attester's bits); a crafted collision only sheds the crafter's
  own traffic.  Full per-attestation content roots would cost more than
  the duplicate apply they save — ``forkchoice/batch.py`` already
  content-dedups per data inside the batch.  The seen-set is a bounded
  FIFO (``SEEN_CAP``).

* **orphan pool** — an unknown-parent block parks under its parent root
  in a bounded, slot-expiring pool instead of raising out of
  ``on_block``.  When the parent arrives (``pop_children`` after every
  applied block) the orphans re-link and apply in arrival order —
  child-before-parent delivery converges to the same head/root as
  in-order delivery (tier-1 differential).  Orphans whose parent never
  arrives expire once the clock passes their slot by
  ``ORPHAN_EXPIRY_SLOTS`` (their votes would be outside the validity
  window anyway) and the producer is charged.  At ``ORPHAN_CAP`` the
  oldest-slot orphan is shed first (lowest re-link odds).

* **future-slot parking** — a block ahead of the store clock parks
  until a tick advances past its slot (``release_parked``), bounded at
  ``PARKED_CAP``.

* **malformed rejection** — undecodable bytes payloads (SSZ decode via
  the spec types), wrong-shaped objects, and unknown item kinds are
  rejected before any handler runs, charging the producer.

* **peer scoring + quarantine** — every rejection/expiry/duplicate
  charges the enqueuing producer (the thread name the ingest queue
  stamps on each item); scores decay multiplicatively per slot
  (``SCORE_DECAY``) so a peer that stops misbehaving drains back below
  the release threshold.  A producer over ``QUARANTINE_THRESHOLD`` is
  quarantined: its attestation gossip is SHED at admission (the
  cheapest place to shed) until the score decays under
  ``RELEASE_THRESHOLD``.  Blocks, ticks, and slashings are never shed —
  consensus-critical objects must survive a misbehaving relay, and a
  block's validity is its own gate.

* **back-pressure aggregation** — when the bounded ingest queue is full
  the producers used to sleep in ``put`` (37.8 s cumulative at 4
  firehose threads); now ``Node.enqueue_attestations`` routes the
  overflow here instead: ``aggregate_gossip`` files the batch
  into a bounded, content-root-grouped staging buffer (``_AGG``, keyed
  by the first attestation's data root so same-data batches sit
  adjacent), and the apply loop's micro-batcher pulls the groups back
  out with ``drain_aggregated`` as ready-to-coalesce runs.  Aggregated
  items never skipped admission — they are judged by ``admit`` like any
  dequeued item when the writer gets to them.  At ``AGG_CAP`` the
  buffer refuses and the producer falls back to the blocking ``put``,
  so back-pressure still bounds total memory.

* **dead-letter ring** — the apply loop's poison-pill containment
  (node/service.py) quarantines an item that keeps failing here: a
  bounded ring of (item kind, producer, error, attempts) records with a
  flight-recorder ``node_quarantine`` event per entry, so the node
  keeps serving and the post-mortem keeps the evidence.

All pools are module-level like the ingest counters (one admission
surface per process; a fresh ``Node`` resets them via ``reset_state``)
and analyzer-registered (CC01 "node orphan pool" / "node dead-letter
ring"): only this module mutates them, and every insert next to the
``node.admission`` / ``node.quarantine`` fault probes is wrapped in a
handler that pops the entry on failure (EF01's transactional-insert
discipline — an injected fault must not strand a half-admitted item).

The ``node.admission`` telemetry provider reports the orphan-pool depth
gauge, parked/expired/quarantined counters, per-producer scores, and
every ring's size against its cap — the soak harness and the
adversarial firehose sample them for the bounded-memory asserts.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from consensus_specs_tpu_torch import faults, telemetry
from consensus_specs_tpu_torch.telemetry import recorder

from .ingest import WorkItem

# bounds: every structure this module owns is capped; the caps are on
# the bus so soak/firehose flatness asserts can hold size <= cap
SEEN_CAP = 8192
ORPHAN_CAP = 256
ORPHAN_EXPIRY_SLOTS = 64        # two mainnet epochs: the vote window
PARKED_CAP = 128
DEAD_LETTER_CAP = 64
SCORE_CAP = 256                 # distinct producers tracked
AGG_CAP = 512                   # staged gossip batches during back-pressure

# peer-scoring charge schedule + decay (docs/architecture.md has the
# worked decay table): malformed junk is the strongest signal, a
# duplicate the weakest (honest meshes re-deliver occasionally)
CHARGE_MALFORMED = 4.0
CHARGE_REJECTED = 2.0
CHARGE_QUARANTINED_ITEM = 4.0
CHARGE_EXPIRED = 1.0
CHARGE_DUPLICATE = 0.25
SCORE_DECAY = 0.75              # multiplicative, per slot advanced
QUARANTINE_THRESHOLD = 8.0
RELEASE_THRESHOLD = 2.0

# probed BEFORE any pool/seen-set mutation: an injected admission fault
# leaves every structure exactly as it was and the item unjudged
_SITE_ADMISSION = faults.site("node.admission")
# probed BEFORE the dead-letter append: a dying quarantine must not
# half-record the poison item (the loop re-queues it and retries)
_SITE_QUARANTINE = faults.site("node.quarantine")

VERDICT_ADMIT = "admit"
VERDICT_DUPLICATE = "duplicate"
VERDICT_ORPHANED = "orphaned"
VERDICT_PARKED = "parked"
VERDICT_MALFORMED = "malformed"
VERDICT_STALE = "stale"
VERDICT_SHED = "shed"

_KNOWN_KINDS = ("tick", "block", "attestations", "attester_slashing")

stats = {
    "admitted": 0,
    "duplicates": 0,
    "orphaned": 0,
    "orphans_relinked": 0,
    "orphans_expired": 0,
    "orphans_shed": 0,          # pool at cap: oldest-slot orphan dropped
    "parked": 0,
    "parked_released": 0,
    "parked_shed": 0,
    "malformed": 0,
    "stale_blocks": 0,
    "stale_ticks": 0,           # backwards clock: the rewind attack
    "shed_items": 0,            # quarantined producers' gossip, dropped
    "quarantines": 0,           # producer entered quarantine
    "releases": 0,              # producer left quarantine (decay)
    "dead_lettered": 0,
    "aggregated": 0,            # gossip batches staged during back-pressure
    "agg_flushes": 0,           # drain_aggregated calls that returned work
    "agg_refusals": 0,          # buffer at cap: producer fell back to put
}

# guards stats + every pool below: admission runs on the single-writer
# apply loop, but the telemetry bus snapshots from arbitrary threads
_LOCK = threading.Lock()

_SEEN: "collections.OrderedDict[bytes, bool]" = collections.OrderedDict()
_ORPHANS: Dict[bytes, List[Tuple[int, WorkItem]]] = {}  # parent root -> [(expire_slot, item)]
_ORPHAN_COUNT = 0
_PARKED: List[Tuple[int, WorkItem]] = []                # (slot, item)
_DEAD_LETTERS: collections.deque = collections.deque(maxlen=DEAD_LETTER_CAP)
_SCORES: Dict[str, float] = {}
_QUARANTINED: set = set()
# back-pressure staging: first-data-root -> [WorkItem], insertion-ordered
# so the drain hands same-data batches back ADJACENT (maximal gossip runs
# for the micro-batcher); counted separately because groups hold lists
_AGG: "collections.OrderedDict[bytes, List[WorkItem]]" = \
    collections.OrderedDict()
_AGG_COUNT = 0


def reset_stats() -> None:
    with _LOCK:
        for k in stats:
            stats[k] = 0


def set_orphan_expiry(slots: int) -> int:
    """Re-tune the orphan validity window (owner API: the adversarial
    firehose and the chaos/differential suites shrink it to one epoch so
    expiry is an exercised path, not a theoretical one).  Returns the
    previous value so callers can restore it."""
    global ORPHAN_EXPIRY_SLOTS
    prev = ORPHAN_EXPIRY_SLOTS
    ORPHAN_EXPIRY_SLOTS = max(1, int(slots))
    return prev


def reset_transient() -> None:
    """Drop the seen-set and the orphan/parked pools but KEEP the
    dead-letter ring, peer scores, and quarantine set — the crash
    recovery shape: pooled items were never applied (the mesh
    re-delivers them, and their seen-keys must not suppress that
    re-delivery as 'duplicates'), while the post-mortem evidence and
    the shed protection outlive the crash."""
    global _ORPHAN_COUNT, _AGG_COUNT
    with _LOCK:
        _SEEN.clear()
        _ORPHANS.clear()
        _ORPHAN_COUNT = 0
        del _PARKED[:]
        _AGG.clear()
        _AGG_COUNT = 0


def reset_state() -> None:
    """Drop every pool, the seen-set, and all peer scores (a fresh
    ``Node`` adopting the process-wide admission surface)."""
    global _ORPHAN_COUNT, _AGG_COUNT
    with _LOCK:
        _SEEN.clear()
        _ORPHANS.clear()
        _ORPHAN_COUNT = 0
        del _PARKED[:]
        _DEAD_LETTERS.clear()
        _SCORES.clear()
        _QUARANTINED.clear()
        _AGG.clear()
        _AGG_COUNT = 0


# -- content keys --------------------------------------------------------------


def _block_key(signed_block) -> bytes:
    # the same root on_block stores the block under: the HTR caches on
    # the backing node, so admission pre-pays what the handler needs
    return b"B" + bytes(signed_block.message.hash_tree_root())


def _slashing_key(slashing) -> bytes:
    return b"S" + bytes(slashing.hash_tree_root())


def _gossip_key(batch) -> Optional[bytes]:
    """The batch sketch key (module docstring): exact for verbatim
    re-delivery, cheap enough for 100k-att firehose volume."""
    if not batch:
        return None
    first, last = batch[0], batch[-1]
    return (b"A" + bytes(first.data.hash_tree_root())
            + bytes(last.data.hash_tree_root())
            + bytes(first.aggregation_bits.encode_bytes())
            + len(batch).to_bytes(4, "little"))


def _content_key(item: WorkItem) -> Optional[bytes]:
    try:
        if item.kind == "block":
            return _block_key(item.payload)
        if item.kind == "attestations":
            return _gossip_key(item.payload)
        if item.kind == "attester_slashing":
            return _slashing_key(item.payload)
    except Exception:
        return None
    return None


def _forget_locked(item: WorkItem) -> None:
    key = _content_key(item)
    if key is not None:
        _SEEN.pop(key, None)


def forget(item: WorkItem) -> None:
    """Drop an item's dedup key so a later re-delivery is judged fresh.
    Called whenever admission sheds/expires a pooled item, or the loop
    rejects one on CURRENT store state (an unknown-root gossip batch, a
    not-yet-linkable block): the content may become valid later, and a
    seen-key left behind would make the honest re-delivery die as a
    duplicate — a crafted collision could even front-run honest traffic
    into permanent suppression."""
    with _LOCK:
        _forget_locked(item)


def _seen_before(key: Optional[bytes]) -> bool:
    """Probe-and-insert into the bounded FIFO seen-set.  Caller holds no
    lock; the insert is popped back out if anything below it raises (the
    EF01 discipline: a fault must not strand a half-judged key)."""
    if key is None:
        return False
    with _LOCK:
        if key in _SEEN:
            return True
        try:
            _SEEN[key] = True
            while len(_SEEN) > SEEN_CAP:
                _SEEN.popitem(last=False)
        except BaseException:
            _SEEN.pop(key, None)
            raise
        return False


# -- payload shape / decode ----------------------------------------------------


def _decode_payload(spec, kind: str, payload):
    """(ok, decoded) — bytes payloads SSZ-decode through the spec types
    (the wire shape); object payloads duck-type-check the fields the
    handlers will read.  Anything else is malformed."""
    try:
        if kind == "tick":
            return True, int(payload)
        if kind == "block":
            if isinstance(payload, (bytes, bytearray)):
                payload = spec.SignedBeaconBlock.decode_bytes(bytes(payload))
            m = payload.message
            int(m.slot), bytes(m.parent_root)  # noqa: B018 - shape probe
            # the content key IS the deep shape probe: junk that walks
            # like a block but cannot tree-hash must die HERE as
            # malformed, not raise out of the dedup check into the
            # retry/quarantine machinery (the root caches on the
            # backing node — admit's later use is free)
            _block_key(payload)
            return True, payload
        if kind == "attestations":
            if isinstance(payload, (bytes, bytearray)):
                return False, None  # gossip batches never arrive as one blob
            batch = tuple(payload)
            # the sketch key doubles as the shape probe of the batch
            # ENDS (SSZ field access materializes a child view ~10us, so
            # probing all 512 of a firehose batch would cost more than
            # the apply it guards); junk buried mid-batch still dies
            # safely at spec validation (AssertionError -> rejected)
            _gossip_key(batch)
            return True, batch
        if kind == "attester_slashing":
            if isinstance(payload, (bytes, bytearray)):
                payload = spec.AttesterSlashing.decode_bytes(bytes(payload))
            payload.attestation_1.attesting_indices  # noqa: B018
            payload.attestation_2.attesting_indices  # noqa: B018
            _slashing_key(payload)
            return True, payload
    except Exception:
        return False, None
    return False, None  # unknown kind


# -- peer scoring --------------------------------------------------------------


def _charge_locked(producer: str, points: float) -> None:
    """Charge ``producer`` (caller holds ``_LOCK``).  At ``SCORE_CAP``
    producers the lowest-scoring entry is evicted — the interesting
    peers are the misbehaving ones."""
    if not producer:
        return
    # _SCORES is a running-total accumulator, not a memo: the lookup
    # reads the prior total ON PURPOSE and the insert folds the charge
    # in — CC02's lookup-key coverage model doesn't apply
    score = _SCORES.get(producer, 0.0) + points  # noqa: CC02
    _SCORES[producer] = score
    if len(_SCORES) > SCORE_CAP:
        coldest = min(_SCORES, key=_SCORES.get)
        _SCORES.pop(coldest)
        if coldest in _QUARANTINED:
            # evicting a quarantined producer releases it: count it, or
            # quarantines/releases stop reconciling with the live set
            _QUARANTINED.discard(coldest)
            stats["releases"] += 1
    # the tracked-set membership guard keeps _QUARANTINED a subset of
    # _SCORES (bounded by SCORE_CAP): the eviction above may have just
    # removed THIS producer, and quarantining an untracked name would
    # leave a ghost no decay pass ever visits or releases
    if (score >= QUARANTINE_THRESHOLD and producer in _SCORES
            and producer not in _QUARANTINED):
        _QUARANTINED.add(producer)
        stats["quarantines"] += 1
        if recorder.enabled():
            recorder.record("node_producer_quarantined", producer=producer,
                            score=round(score, 2))


def charge(producer: str, points: float) -> None:
    with _LOCK:
        _charge_locked(producer, points)


def decay_scores(slots_advanced: int) -> None:
    """Multiplicative per-slot decay; producers under the release
    threshold leave quarantine (hysteresis: enter at 8, leave at 2)."""
    if slots_advanced <= 0:
        return
    factor = SCORE_DECAY ** slots_advanced
    with _LOCK:
        for producer in list(_SCORES):
            score = _SCORES[producer] * factor
            if score < 0.01:
                _SCORES.pop(producer)
                score = 0.0
            else:
                _SCORES[producer] = score
            if producer in _QUARANTINED and score < RELEASE_THRESHOLD:
                _QUARANTINED.discard(producer)
                stats["releases"] += 1


def is_quarantined(producer: str) -> bool:
    with _LOCK:
        return producer in _QUARANTINED


# -- the gate ------------------------------------------------------------------


def admit(spec, store, item: WorkItem, current_slot: int,
          readmit: bool = False):
    """Judge one dequeued item.  Returns ``(verdict, item)`` — the item
    comes back with a decoded payload when admission had to decode it.
    Only ``VERDICT_ADMIT`` items may reach the spec handlers; every
    other verdict was counted (and charged) here.  Pool inserts are
    transactional: a fault mid-admission leaves no half-parked entry.
    ``readmit`` marks an item coming back from the orphan pool or the
    parked ring: it is already in the seen-set, so the dedup check is
    skipped (every other check still runs — a released block whose
    parent is STILL unknown goes to the orphan pool, not the spec)."""
    _SITE_ADMISSION()
    kind = item.kind
    if kind not in _KNOWN_KINDS:
        _reject_malformed(item)
        return VERDICT_MALFORMED, item
    ok, decoded = _decode_payload(spec, kind, item.payload)
    if not ok:
        _reject_malformed(item)
        return VERDICT_MALFORMED, item
    if decoded is not item.payload:
        item = item._replace(payload=decoded)

    if kind == "tick":
        # the spec's on_tick trusts the local clock and would REWIND
        # store.time on a smaller value — a backwards tick from a hostile
        # producer must die here (equal is idempotent and allowed)
        if int(item.payload) < int(store.time):
            with _LOCK:
                stats["stale_ticks"] += 1
                _charge_locked(item.producer, CHARGE_REJECTED)
            return VERDICT_STALE, item
        with _LOCK:
            stats["admitted"] += 1
        return VERDICT_ADMIT, item

    if kind == "attestations":
        # the quarantine shed runs BEFORE the dedup insert: a shed batch
        # must not leave a seen-key behind, or an honest re-delivery of
        # the same votes after the producer's release would die as a
        # duplicate (blocks/ticks/slashings are never shed)
        if is_quarantined(item.producer):
            with _LOCK:
                stats["shed_items"] += 1
            return VERDICT_SHED, item
        if not readmit and _seen_before(_gossip_key(item.payload)):
            _count_duplicate(item)
            return VERDICT_DUPLICATE, item
        with _LOCK:
            stats["admitted"] += 1
        return VERDICT_ADMIT, item

    if kind == "attester_slashing":
        if not readmit and _seen_before(_slashing_key(item.payload)):
            _count_duplicate(item)
            return VERDICT_DUPLICATE, item
        with _LOCK:
            stats["admitted"] += 1
        return VERDICT_ADMIT, item

    # blocks: dedup, stale/finality floor, future parking, orphan pool
    block = item.payload.message
    root = bytes(block.hash_tree_root())
    if root in store.blocks or (not readmit
                                and _seen_before(_block_key(item.payload))):
        _count_duplicate(item)
        return VERDICT_DUPLICATE, item
    finalized_slot = int(spec.compute_start_slot_at_epoch(
        store.finalized_checkpoint.epoch))
    if int(block.slot) <= finalized_slot:
        with _LOCK:
            stats["stale_blocks"] += 1
            _charge_locked(item.producer, CHARGE_REJECTED)
        return VERDICT_STALE, item
    if int(block.slot) > current_slot:
        return _park(item, int(block.slot))
    if bytes(block.parent_root) not in store.block_states:
        return _pool_orphan(item, int(block.slot), bytes(block.parent_root),
                            current_slot)
    with _LOCK:
        stats["admitted"] += 1
    return VERDICT_ADMIT, item


def _reject_malformed(item: WorkItem) -> None:
    with _LOCK:
        stats["malformed"] += 1
        _charge_locked(item.producer, CHARGE_MALFORMED)
    if recorder.enabled():
        recorder.record("node_malformed", item_kind=str(item.kind)[:32],
                        producer=item.producer)


def _count_duplicate(item: WorkItem) -> None:
    with _LOCK:
        stats["duplicates"] += 1
        _charge_locked(item.producer, CHARGE_DUPLICATE)


def _park(item: WorkItem, slot: int):
    """Future-slot parking, bounded: at cap the FARTHEST-future block is
    shed (least likely to matter before shutdown) — charging THAT
    block's producer and forgetting its dedup key so a re-delivery
    nearer its slot gets judged fresh."""
    with _LOCK:
        try:
            _PARKED.append((slot, item))
            _PARKED.sort(key=lambda e: e[0])
            if len(_PARKED) > PARKED_CAP:
                _shed_slot, shed = _PARKED.pop()
                stats["parked_shed"] += 1
                _charge_locked(shed.producer, CHARGE_EXPIRED)
                _forget_locked(shed)
                if shed is item:
                    # the newcomer WAS the farthest-future entry: it
                    # never parked — telling the caller PARKED would
                    # claim a block is waiting that is already gone
                    return VERDICT_STALE, item
            stats["parked"] += 1
        except BaseException:
            _PARKED[:] = [e for e in _PARKED if e[1] is not item]
            raise
    return VERDICT_PARKED, item


def _pool_orphan(item: WorkItem, slot: int, parent: bytes,
                 current_slot: int):
    global _ORPHAN_COUNT
    # expiry is SLOT-relative, not arrival-relative: the window models
    # the vote-validity horizon of the block's own slot, so an orphan
    # that was already ancient when it arrived expires at the next
    # housekeeping tick instead of camping a fresh window
    expire_at = slot + ORPHAN_EXPIRY_SLOTS
    if expire_at <= current_slot:
        # already past its window on arrival: expire NOW instead of
        # pooling an entry no later housekeeping may ever visit (the
        # clock only advances on ticks; after the last one, a pooled
        # corpse would sit out the shutdown uncounted)
        with _LOCK:
            stats["orphans_expired"] += 1
            _charge_locked(item.producer, CHARGE_EXPIRED)
            _forget_locked(item)
        return VERDICT_STALE, item
    with _LOCK:
        try:
            _ORPHANS.setdefault(parent, []).append((expire_at, item))
            _ORPHAN_COUNT += 1
            stats["orphaned"] += 1
        except BaseException:
            # surgical rollback: only THIS item leaves; pooled siblings
            # under the same parent keep their entries and their count
            bucket = _ORPHANS.get(parent)
            if bucket is not None:
                bucket[:] = [e for e in bucket if e[1] is not item]
                if not bucket:
                    _ORPHANS.pop(parent, None)
            raise
        if _ORPHAN_COUNT > ORPHAN_CAP:
            _shed_oldest_orphan_locked()
    return VERDICT_ORPHANED, item


def _shed_oldest_orphan_locked() -> None:
    global _ORPHAN_COUNT
    oldest_parent, oldest_i, oldest_slot = None, -1, None
    for parent, entries in _ORPHANS.items():
        for i, (_expire, it) in enumerate(entries):
            s = int(it.payload.message.slot)
            if oldest_slot is None or s < oldest_slot:
                oldest_parent, oldest_i, oldest_slot = parent, i, s
    if oldest_parent is None:
        return
    entries = _ORPHANS[oldest_parent]
    _expire, shed = entries.pop(oldest_i)
    if not entries:
        _ORPHANS.pop(oldest_parent)
    _ORPHAN_COUNT -= 1
    stats["orphans_shed"] += 1
    _charge_locked(shed.producer, CHARGE_EXPIRED)
    _forget_locked(shed)  # a re-delivery after the parent links is fresh


def pop_children(parent_root: bytes) -> List[WorkItem]:
    """Orphans waiting on a just-applied block, in arrival order — the
    re-link path.  The caller (the apply loop) re-admits each."""
    global _ORPHAN_COUNT
    with _LOCK:
        entries = _ORPHANS.pop(bytes(parent_root), None)
        if not entries:
            return []
        _ORPHAN_COUNT -= len(entries)
        stats["orphans_relinked"] += len(entries)
    return [item for _expire, item in entries]


def release_parked(current_slot: int) -> List[WorkItem]:
    """Parked blocks whose slot the clock has reached, in slot order."""
    with _LOCK:
        due = [item for slot, item in _PARKED if slot <= current_slot]
        if due:
            _PARKED[:] = [e for e in _PARKED if e[0] > current_slot]
            stats["parked_released"] += len(due)
    return due


def expire_orphans(current_slot: int) -> int:
    """Drop orphans whose expiry slot has passed, charging producers.
    Returns the number expired."""
    global _ORPHAN_COUNT
    expired = 0
    with _LOCK:
        for parent in list(_ORPHANS):
            keep = []
            for expire_at, item in _ORPHANS[parent]:
                if expire_at <= current_slot:
                    expired += 1
                    _charge_locked(item.producer, CHARGE_EXPIRED)
                    # the block may still become linkable (expiry is a
                    # vote-window heuristic): a later honest re-delivery
                    # must be judged fresh, not a duplicate
                    _forget_locked(item)
                else:
                    keep.append((expire_at, item))
            if keep:
                _ORPHANS[parent] = keep
            else:
                _ORPHANS.pop(parent)
        _ORPHAN_COUNT -= expired
        stats["orphans_expired"] += expired
    return expired


def on_clock(current_slot: int, slots_advanced: int) -> List[WorkItem]:
    """The per-tick admission housekeeping bundle: decay scores, expire
    orphans, release due parked blocks (returned for re-admission)."""
    decay_scores(slots_advanced)
    expire_orphans(current_slot)
    return release_parked(current_slot)


# -- back-pressure aggregation --------------------------------------


def aggregate_gossip(payload, producer: str,
                     link: Optional[int] = None) -> bool:
    """Stage a gossip batch a full ingest queue refused (``try_put``
    returned False): filed under the batch's first attestation-data root
    so same-data batches come back out adjacent — ready-made gossip runs
    for the micro-batcher.  Returns False (producer falls back to the
    blocking ``put``) at ``AGG_CAP`` or for a batch whose first entry
    cannot tree-hash (junk routes through normal admission so it is
    charged, never silently staged)."""
    global _AGG_COUNT
    try:
        key = bytes(payload[0].data.hash_tree_root())
    except Exception:
        return False
    item = WorkItem("attestations", payload, link, producer)
    with _LOCK:
        if producer in _QUARANTINED:
            # a quarantined peer's gossip must meet the shed check in
            # FIFO order with the charges that quarantined it — staging
            # would delay the judgment past the decay window
            return False
        if _AGG_COUNT >= AGG_CAP:
            stats["agg_refusals"] += 1
            return False
        try:
            _AGG.setdefault(key, []).append(item)
            _AGG_COUNT += 1
            stats["aggregated"] += 1
        except BaseException:
            bucket = _AGG.get(key)
            if bucket is not None:
                bucket[:] = [e for e in bucket if e is not item]
                if not bucket:
                    _AGG.pop(key, None)
            raise
    return True


def drain_aggregated(max_items: Optional[int] = None) -> List[WorkItem]:
    """Hand staged batches to the apply loop, group by group in staging
    order (items inside a group keep arrival order).  The items were
    never judged — the micro-batcher routes each through ``admit`` like
    any dequeued work.  A ``max_items`` bound may split a group; the
    remainder stays staged at the front."""
    global _AGG_COUNT
    out: List[WorkItem] = []
    with _LOCK:
        while _AGG and (max_items is None or len(out) < max_items):
            key, bucket = next(iter(_AGG.items()))
            room = None if max_items is None else max_items - len(out)
            if room is None or len(bucket) <= room:
                out.extend(bucket)
                _AGG.pop(key)
            else:
                out.extend(bucket[:room])
                bucket[:] = bucket[room:]
        # one recount beats per-branch bookkeeping under the lock
        _AGG_COUNT = sum(len(b) for b in _AGG.values())
        if out:
            stats["agg_flushes"] += 1
    return out


def aggregation_depth() -> int:
    with _LOCK:
        return _AGG_COUNT


# -- dead-letter ring ----------------------------------------------------------


def dead_letter(item: WorkItem, error: BaseException) -> dict:
    """Quarantine a poison item: the apply loop exhausted its retry cap
    and the node keeps serving.  Appends a bounded dead-letter record,
    charges the producer, and emits the ``node_quarantine`` event —
    AFTER the append settled (OB01's commit discipline)."""
    _SITE_QUARANTINE()
    record = {
        "item_kind": item.kind,
        "producer": item.producer,
        "attempts": int(item.attempts) + 1,
        "error": repr(error)[:200],
        "summary": _item_summary(item),
    }
    with _LOCK:
        try:
            _DEAD_LETTERS.append(record)
            stats["dead_lettered"] += 1
        except BaseException:
            if _DEAD_LETTERS and _DEAD_LETTERS[-1] is record:
                _DEAD_LETTERS.pop()
            raise
        _charge_locked(item.producer, CHARGE_QUARANTINED_ITEM)
    if recorder.enabled():
        try:
            recorder.record("node_quarantine", **record)
        except BaseException:
            # never half-record: a dying event emission rolls the ring
            # entry back out, or the caller's retry would dead-letter
            # the same poison item twice
            with _LOCK:
                if _DEAD_LETTERS and _DEAD_LETTERS[-1] is record:
                    _DEAD_LETTERS.pop()
                    stats["dead_lettered"] -= 1
            raise
    return record


def _item_summary(item: WorkItem) -> str:
    try:
        if item.kind == "block":
            return f"slot={int(item.payload.message.slot)}"
        if item.kind == "attestations":
            return f"n={len(item.payload)}"
        if item.kind == "tick":
            return f"time={int(item.payload)}"
    except Exception:
        pass
    return ""


def dead_letters() -> List[dict]:
    with _LOCK:
        return [dict(r) for r in _DEAD_LETTERS]


# -- telemetry -----------------------------------------------------------------


def snapshot() -> dict:
    """The ``node.admission`` bus subtree: counters, the orphan-pool
    depth gauge, per-producer scores, and size/cap for every bounded
    structure (the soak + firehose flatness sample)."""
    with _LOCK:
        return {
            **stats,
            "orphan_pool_depth": _ORPHAN_COUNT,
            "orphan_pool_cap": ORPHAN_CAP,
            "parked_depth": len(_PARKED),
            "parked_cap": PARKED_CAP,
            "dead_letter_depth": len(_DEAD_LETTERS),
            "dead_letter_cap": DEAD_LETTER_CAP,
            "seen_size": len(_SEEN),
            "seen_cap": SEEN_CAP,
            "scores_size": len(_SCORES),
            "scores_cap": SCORE_CAP,
            "agg_depth": _AGG_COUNT,
            "agg_cap": AGG_CAP,
            "producer_scores": {p: round(s, 3)
                                for p, s in sorted(_SCORES.items())},
            "quarantined_producers": sorted(_QUARANTINED),
        }


telemetry.register_provider("node.admission", snapshot, replace=True)
