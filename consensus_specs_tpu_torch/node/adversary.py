"""Seeded deterministic adversarial corpora + the adversarial firehose:
reorgs, equivocation storms and finality stalls run THROUGH the firehose.

``firehose.py`` proves the node serves honest traffic; this module
proves it SURVIVES hostile traffic.  ``build_adversarial_corpus`` lays
four attack corpora over an honest chain, all derived from one seed:

* **finality-stall chain** — one epoch of the honest chain carries no
  block attestations, so justification stalls through that epoch and
  resumes after (the chain itself stays valid);
* **long-range reorg branch** — a valid side chain forked near the
  anchor (its first block is a PROPOSER EQUIVOCATION: same slot, same
  proposer, different content than the canonical block), delivered
  deepest-child-FIRST so every block but the last is an orphan-pool
  entry that re-links when its parent finally arrives;
* **equivocation storm** — seeded ``AttesterSlashing`` double-votes
  (distinct index sets, same target epoch, different data) that march
  through ``on_attester_slashing`` into ``store.equivocating_indices``,
  clearing those validators' fork-choice votes mid-serve;
* **junk + duplicate floods** — undecodable bytes, wrong-shaped
  objects, unknown item kinds, verbatim re-deliveries of honest gossip
  and blocks, never-linking orphan blocks (unknown parents that must
  expire), and honest blocks delivered AHEAD of their slot (the
  future-parking path) — plus a reserve of fresh gossip the flooding
  producer sends once quarantined, proving the shed path drops it.

``run_adversarial_firehose`` drives all of it concurrently through the
bounded ingest queue against the single-writer apply loop (honest chain
driver + gossip producers exactly like the honest firehose, plus an
``adv-chain`` and an ``adv-junk`` producer), and holds the survival
contract:

* **zero halts** — the apply loop runs to completion; poison/junk items
  are rejected, quarantined, or shed, never raised;
* **byte-identical head/root** — whatever the queue's interleaving, the
  node's apply journal replayed through the literal spec handlers
  reaches the same head, state root, checkpoints, and latest messages
  (``firehose.assert_parity``);
* **bounded memory** — every admission structure (orphan pool, parked
  ring, dead-letter ring, seen-set, score table, aggregation buffer)
  sits at or under its cap in the bus snapshot (``assert_bounded``).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, NamedTuple, Tuple

from consensus_specs_tpu_torch.testing.helpers.attestations import (
    build_attestation_data,
)

from . import admission, firehose
from .service import Node


class AdversarialCorpus(NamedTuple):
    """One seeded adversarial workload over an anchor state."""

    anchor_block: object
    chain: List[object]               # honest chain, chain order
    gossip: Dict[int, List[object]]   # slot -> honest gossip votes
    shed_gossip: Dict[int, List[object]]  # fresh votes the flooder sends
    stall_epochs: Tuple[int, ...]     # epochs with no block attestations
    fork_blocks: List[object]         # valid reorg branch, chain order
    orphan_blocks: List[object]       # unknown-parent blocks (never link)
    future_slots: Tuple[int, ...]     # honest slots pre-delivered early
    slashings: List[object]           # the equivocation storm
    junk: List[Tuple[str, object]]    # malformed/undecodable work items
    duplicate_slots: Tuple[int, ...]  # slots re-delivered verbatim


def _signed_copy(spec, signed_block):
    return spec.SignedBeaconBlock.decode_bytes(signed_block.encode_bytes())


def build_adversarial_corpus(spec, anchor_state, seed: int = 90013,
                             n_epochs: int = 3, gossip_target: int = 600,
                             fork_len: int = 5, n_orphans: int = 3,
                             n_slashings: int = 4, shed_per_slot: int = 4,
                             prebuilt=None) -> AdversarialCorpus:
    """Deterministic hostile workload: an ``n_epochs`` honest chain with
    its SECOND epoch attestation-free (the finality stall), a
    ``fork_len``-block reorg branch off the second canonical block, the
    slashing storm, junk items, and the duplicate/future/orphan
    schedules — all drawn from ``seed``.  Built BLS-off like the honest
    corpus (the firehose measures orchestration, not pairing).

    ``prebuilt`` short-circuits the expensive state walk with cached
    ``(chain, gossip, shed_gossip, fork_blocks)`` parts (a caller's disk
    cache); the seeded schedules are re-derived identically — the rng is
    only consumed AFTER the heavy build in both paths."""
    if prebuilt is not None:
        chain, gossip, shed_gossip, fork_blocks = prebuilt
        return _assemble(spec, anchor_state, seed, n_epochs, chain, gossip,
                         shed_gossip, fork_blocks, n_orphans, n_slashings)
    from consensus_specs_tpu_torch.crypto import bls

    anchor_block = firehose.default_anchor_block(spec, anchor_state)
    spe = int(spec.SLOTS_PER_EPOCH)
    n_slots = n_epochs * spe
    per_slot = max(1, -(-gossip_target // n_slots))
    was_active = bls.bls_active
    bls.bls_active = False
    try:
        build_st = anchor_state.copy()
        chain: List[object] = []
        gossip: Dict[int, List[object]] = {}
        shed_gossip: Dict[int, List[object]] = {}
        first_slot = int(build_st.slot) + 1
        first_epoch = first_slot // spe
        # the stall epoch: the corpus's second full epoch — late enough
        # that justification has something to stall, early enough that
        # the tail can show recovery
        stall_epochs = (first_epoch + 1,)
        # branch off the FOURTH block: strictly above the never-linking
        # orphans' slots (1-3), so the run's orphan-expiry window can be
        # tuned to expire the never-linkers by the final tick while the
        # fork branch cannot expire in-run under ANY delivery timing
        fork_base_slot = first_slot + 3
        fork_state = None
        for slot in range(first_slot, first_slot + n_slots):
            stub = build_st.copy()
            spec.process_slots(stub, slot)
            block = spec.BeaconBlock(
                slot=slot,
                proposer_index=spec.get_beacon_proposer_index(stub))
            block.body.eth1_data.deposit_count = stub.eth1_deposit_index
            header = build_st.latest_block_header.copy()
            if header.state_root == spec.Root():
                header.state_root = build_st.hash_tree_root()
            block.parent_root = header.hash_tree_root()
            att_slot = slot - 1
            in_stall = (att_slot // spe) in stall_epochs
            if att_slot >= first_slot and not in_stall:
                epoch = spec.compute_epoch_at_slot(att_slot)
                for index in range(int(
                        spec.get_committee_count_per_slot(stub, epoch))):
                    if len(block.body.attestations) >= int(
                            spec.MAX_ATTESTATIONS):
                        break
                    committee = spec.get_beacon_committee(
                        stub, att_slot, index)
                    block.body.attestations.append(spec.Attestation(
                        aggregation_bits=[True] * len(committee),
                        data=build_attestation_data(
                            spec, stub, att_slot, index)))
            spec.process_slots(build_st, slot)
            spec.process_block(build_st, block)
            block.state_root = build_st.hash_tree_root()
            chain.append(spec.SignedBeaconBlock(message=block))
            votes = firehose._gossip_for_slot(
                spec, build_st, slot, block.hash_tree_root(),
                per_slot + shed_per_slot)
            gossip[slot] = votes[:per_slot]
            shed_gossip[slot] = votes[per_slot:]
            if slot == fork_base_slot:
                fork_state = build_st.copy()

        fork_blocks = _build_fork_branch(spec, fork_state, fork_len)
        return _assemble(spec, anchor_state, seed, n_epochs, chain, gossip,
                         shed_gossip, fork_blocks, n_orphans, n_slashings)
    finally:
        bls.bls_active = was_active


def _assemble(spec, anchor_state, seed, n_epochs, chain, gossip,
              shed_gossip, fork_blocks, n_orphans,
              n_slashings) -> AdversarialCorpus:
    """The rng-driven half of the corpus: everything derivable from the
    (possibly cache-loaded) heavy parts, in one fixed draw order so cold
    and cached builds agree byte-for-byte."""
    rng = random.Random(seed)
    anchor_block = firehose.default_anchor_block(spec, anchor_state)
    spe = int(spec.SLOTS_PER_EPOCH)
    n_slots = n_epochs * spe
    first_slot = int(chain[0].message.slot)
    first_epoch = first_slot // spe
    stall_epochs = (first_epoch + 1,)
    # never-linkers come from the first three blocks only (slots 1-3):
    # strictly below the fork base, see build_adversarial_corpus
    orphan_blocks = _build_never_linking(spec, chain[:3], rng, n_orphans)
    slashings = _build_slashing_storm(
        spec, anchor_state, rng, n_slashings, first_epoch)
    junk = _build_junk(rng)
    # duplicates stay inside the first two epochs so the run has clock
    # left to process the re-deliveries; future pre-deliveries come from
    # the LAST epoch so they are guaranteed ahead of the clock at
    # enqueue (the parking path is deterministic, not a race with the
    # apply loop)
    dup_pool = sorted(gossip)[:2 * spe]
    duplicate_slots = tuple(sorted(rng.sample(
        dup_pool, min(4, len(dup_pool)))))
    last_epoch_start = first_slot + (n_epochs - 1) * spe
    future_slots = tuple(sorted(rng.sample(
        range(last_epoch_start + 1, first_slot + n_slots - 1),
        min(2, spe - 2))))
    return AdversarialCorpus(
        anchor_block, chain, gossip, shed_gossip, stall_epochs,
        fork_blocks, orphan_blocks, future_slots, slashings, junk,
        duplicate_slots)


def _build_fork_branch(spec, fork_state, fork_len: int) -> List[object]:
    """A valid empty-block side chain from ``fork_state`` (the canonical
    post-state at the fork base).  Its first block shares slot AND
    proposer with the canonical block built from the same pre-state —
    proposer equivocation by construction; graffiti disambiguates the
    content."""
    out: List[object] = []
    if fork_state is None or fork_len <= 0:
        return out
    st = fork_state.copy()
    # the branch's parent: the block whose post-state fork_state is
    header = st.latest_block_header.copy()
    if header.state_root == spec.Root():
        header.state_root = st.hash_tree_root()
    parent_root = header.hash_tree_root()
    for i in range(fork_len):
        slot = int(st.slot) + 1
        stub = st.copy()
        spec.process_slots(stub, slot)
        block = spec.BeaconBlock(
            slot=slot, proposer_index=spec.get_beacon_proposer_index(stub),
            parent_root=parent_root)
        block.body.eth1_data.deposit_count = stub.eth1_deposit_index
        block.body.graffiti = b"fork" + bytes([i]) + b"\x00" * 27
        spec.process_slots(st, slot)
        spec.process_block(st, block)
        block.state_root = st.hash_tree_root()
        out.append(spec.SignedBeaconBlock(message=block))
        parent_root = block.hash_tree_root()
    return out


def _build_never_linking(spec, chain, rng, n: int) -> List[object]:
    """Copies of early honest blocks re-parented onto roots no store
    will ever hold: orphan-pool entries whose only exit is expiry."""
    out = []
    for i in range(min(n, len(chain))):
        signed = _signed_copy(spec, chain[i])
        signed.message.parent_root = bytes(
            rng.getrandbits(8) for _ in range(32))
        out.append(signed)
    return out


def _build_slashing_storm(spec, anchor_state, rng, n: int,
                          epoch: int) -> List[object]:
    """Seeded double-vote ``AttesterSlashing`` objects: distinct sorted
    index sets, same target epoch, different vote data — exactly the
    shape ``is_slashable_attestation_data`` calls a double vote.  Valid
    BLS-off (``is_valid_indexed_attestation`` checks ordering and the
    aggregate signature; indices only need to exist in the registry)."""
    out = []
    n_validators = len(anchor_state.validators)
    root_a, root_b = b"\xaa" * 32, b"\xbb" * 32
    for i in range(n):
        k = min(4 + i, max(1, n_validators // 8))
        indices = sorted(rng.sample(range(n_validators), k))
        data_1 = spec.AttestationData(
            slot=spec.Slot(1), index=0,
            beacon_block_root=root_a,
            source=spec.Checkpoint(epoch=epoch, root=root_a),
            target=spec.Checkpoint(epoch=epoch + 1, root=root_a))
        data_2 = spec.AttestationData(
            slot=spec.Slot(1), index=0,
            beacon_block_root=root_b,
            source=spec.Checkpoint(epoch=epoch, root=root_b),
            target=spec.Checkpoint(epoch=epoch + 1, root=root_b))
        out.append(spec.AttesterSlashing(
            attestation_1=spec.IndexedAttestation(
                attesting_indices=indices, data=data_1),
            attestation_2=spec.IndexedAttestation(
                attesting_indices=indices, data=data_2)))
    return out


def _build_junk(rng) -> List[Tuple[str, object]]:
    """Malformed/undecodable work items: every admission rejection path
    gets traffic."""
    return [
        ("block", bytes(rng.getrandbits(8) for _ in range(17))),
        ("block", 42),
        ("block", object()),
        ("attestations", ("not-an-attestation",)),
        ("attestations", b"\x00\x01\x02"),
        ("attester_slashing", b"\xff" * 9),
        ("blob_sidecar", b"\x00" * 48),
        ("tick", "not-a-time"),
    ]


def assert_bounded(snap: dict = None) -> dict:
    """Every admission structure at or under its registered cap in the
    bus snapshot — the bounded-memory half of the survival contract."""
    snap = snap if snap is not None else admission.snapshot()
    for size_key, cap_key in (
            ("orphan_pool_depth", "orphan_pool_cap"),
            ("parked_depth", "parked_cap"),
            ("dead_letter_depth", "dead_letter_cap"),
            ("seen_size", "seen_cap"),
            ("scores_size", "scores_cap"),
            ("agg_depth", "agg_cap")):
        assert snap[size_key] <= snap[cap_key], (
            f"admission {size_key} {snap[size_key]} over its cap "
            f"{snap[cap_key]} — an unbounded survival structure")
    # the quarantine set is a subset of the tracked scores by invariant
    assert len(snap["quarantined_producers"]) <= snap["scores_cap"]
    return snap


def run_adversarial_firehose(spec, anchor_state, corpus: AdversarialCorpus,
                             n_gossip_producers: int = 2,
                             queue_cap: int = 64, gossip_batch: int = 256,
                             producer_timeout: float = 300.0,
                             junk_rounds: int = 2) -> dict:
    """Serve the hostile corpus through a fresh ``Node`` under
    concurrent load: the honest chain driver + gossip producers of the
    plain firehose, plus the ``adv-chain`` producer (future blocks, the
    reorg branch deepest-child-first, the slashing storm, never-linking
    orphans) and the ``adv-junk`` flood (malformed items, verbatim
    duplicates, then fresh gossip from inside quarantine).  The calling
    thread runs the apply loop; the run's survival asserts
    (zero-halt/bounded) live here, parity is the caller's leg like the
    honest harness."""
    spe = int(spec.SLOTS_PER_EPOCH)
    genesis_time = int(anchor_state.genesis_time)
    sps = int(spec.config.SECONDS_PER_SLOT)
    node = Node(spec, anchor_state, corpus.anchor_block,
                queue_cap=queue_cap)
    # orphan-expiry window derived from the corpus geometry (expiry is
    # slot-anchored): final_clock - max(never-linker slot) makes every
    # never-linking orphan expire AT OR BEFORE the final tick's
    # housekeeping (or expire-on-arrival if delivered later still),
    # while the fork branch — whose slots sit strictly higher — cannot
    # expire in-run under ANY thread-scheduling delay (restored on exit)
    final_clock = int(corpus.chain[-1].message.slot) + 1
    never_max = max((int(sb.message.slot) for sb in corpus.orphan_blocks),
                    default=int(corpus.chain[0].message.slot))
    prev_expiry = admission.set_orphan_expiry(final_clock - never_max)

    slots = sorted(corpus.gossip)
    remaining_by_epoch: Dict[int, int] = {}
    for s in slots:
        e = s // spe
        remaining_by_epoch[e] = remaining_by_epoch.get(e, 0) + 1
    fence = threading.Condition()
    abort = threading.Event()
    # the future blocks enter the queue before the chain's first tick, so
    # the clock is still at the anchor when they are admitted and they park
    # however the threads are scheduled (set also when adv-chain fails)
    future_sent = threading.Event()
    errors: List[BaseException] = []

    def _fail(exc: BaseException) -> None:
        errors.append(exc)
        abort.set()
        with fence:
            fence.notify_all()

    def _wait_clock(slot: int) -> bool:
        deadline = time.monotonic() + producer_timeout
        while not abort.is_set():
            if node.wait_for_clock(slot, timeout=0.5):
                return True
            if time.monotonic() > deadline:
                _fail(TimeoutError(
                    f"producer starved waiting for clock slot {slot}"))
                return False
        return False

    def gossip_producer(i: int) -> None:
        try:
            for s in slots[i::n_gossip_producers]:
                if not _wait_clock(s + 1):
                    return
                batch = corpus.gossip[s]
                for lo in range(0, len(batch), gossip_batch):
                    node.enqueue_attestations(
                        batch[lo:lo + gossip_batch],
                        timeout=producer_timeout)
                with fence:
                    remaining_by_epoch[s // spe] -= 1
                    fence.notify_all()
        except BaseException as exc:
            _fail(exc)

    def chain_driver() -> None:
        try:
            future_sent.wait(producer_timeout)
            seen_epoch = None
            for signed in corpus.chain:
                s = int(signed.message.slot)
                e = s // spe
                if e != seen_epoch:
                    with fence:
                        fence.wait_for(lambda: abort.is_set() or not any(
                            n > 0 for ep, n in remaining_by_epoch.items()
                            if ep <= e - 2))
                    if abort.is_set():
                        return
                    seen_epoch = e
                node.enqueue_tick(genesis_time + s * sps,
                                  timeout=producer_timeout)
                node.enqueue_block(signed, timeout=producer_timeout)
            last = int(corpus.chain[-1].message.slot)
            node.enqueue_tick(genesis_time + (last + 1) * sps,
                              timeout=producer_timeout)
        except BaseException as exc:
            _fail(exc)

    first_slot = int(corpus.chain[0].message.slot)
    by_slot = {int(sb.message.slot): sb for sb in corpus.chain}

    def adv_chain() -> None:
        """Future pre-delivery, the reorg branch child-first, the
        slashing storm, and the never-linking orphans."""
        try:
            # future blocks land while the clock still sits at the anchor
            try:
                for s in corpus.future_slots:
                    if s in by_slot:
                        node.enqueue_block(by_slot[s],
                                           timeout=producer_timeout)
            finally:
                future_sent.set()
            # the branch forks off block 2: deliver once the clock has
            # passed the DEEPEST fork slot (none of the branch can hit
            # the future-parking path and bypass the orphan pool),
            # deepest child first — every block but the last orphans,
            # then one cascade re-links the whole branch
            deepest = max((int(sb.message.slot)
                           for sb in corpus.fork_blocks),
                          default=first_slot + 2)
            if not _wait_clock(deepest + 1):
                return
            for signed in reversed(corpus.fork_blocks):
                node.enqueue_block(signed, timeout=producer_timeout)
            for slashing in corpus.slashings:
                node.enqueue_attester_slashing(
                    slashing, timeout=producer_timeout)
            for signed in corpus.orphan_blocks:
                node.enqueue_block(signed, timeout=producer_timeout)
        except BaseException as exc:
            _fail(exc)

    def adv_junk() -> None:
        """Malformed flood (until quarantined), verbatim duplicates
        (dedup), then fresh reserve gossip (shed while quarantined)."""
        try:
            # the clock-rewind attack: a backwards tick must die at
            # admission (the spec's on_tick would rewind store.time); sent
            # once the chain's first tick has moved the clock, so that it
            # is backwards however the threads are scheduled
            if not _wait_clock(first_slot):
                return
            node.enqueue_tick(1, timeout=producer_timeout)
            for _ in range(junk_rounds):
                for kind, payload in corpus.junk:
                    node.queue.put(kind, payload, timeout=producer_timeout)
            # wait until the loop has judged enough junk to quarantine
            deadline = time.monotonic() + producer_timeout
            while (not admission.is_quarantined("adv-junk")
                   and not abort.is_set()):
                if time.monotonic() > deadline:
                    _fail(TimeoutError("junk flood never quarantined"))
                    return
                time.sleep(0.01)
            for s in corpus.duplicate_slots:
                if not _wait_clock(s + 1):
                    return
                # a real flooder keeps flooding: three fresh malformed
                # items guarantee re-quarantine before the reserve
                # gossip below is judged, even with ticks interleaving
                # between the puts (3 x 4.0 with up to two slots of
                # decay: 4*0.75^2 + 4*0.75 + 4 = 9.25 >= the 8.0
                # threshold; FIFO orders the charges before the shed
                # check)
                for j in (0, 1, 2):
                    node.queue.put("block", b"\xfe%d@%d" % (j, s),
                                   timeout=producer_timeout)
                if s in by_slot:  # duplicate block re-delivery
                    node.enqueue_block(by_slot[s], timeout=producer_timeout)
                batch = corpus.gossip[s]
                for lo in range(0, len(batch), gossip_batch):
                    node.enqueue_attestations(
                        batch[lo:lo + gossip_batch],
                        timeout=producer_timeout)
                # fresh reserve votes: these are NOT duplicates, so the
                # only thing standing between them and the spec is the
                # quarantine shed
                fresh = corpus.shed_gossip.get(s, ())
                if fresh:
                    node.enqueue_attestations(
                        fresh, timeout=producer_timeout)
            # the flooder's last charge lands after the chain's final
            # tick, whose housekeeping runs the last score decay before
            # the loop judges any later item: its score is still tracked
            # when the run ends however early its schedule ran (its
            # charges decay 0.75 a slot and a score under 0.01 drops)
            if not _wait_clock(final_clock):
                return
            node.queue.put("block", b"\xfe@end", timeout=producer_timeout)
        except BaseException as exc:
            _fail(exc)

    producers = [
        threading.Thread(target=chain_driver, name="firehose-chain",
                         daemon=True),
        threading.Thread(target=adv_chain, name="adv-chain", daemon=True),
        threading.Thread(target=adv_junk, name="adv-junk", daemon=True),
    ]
    producers += [
        threading.Thread(target=gossip_producer, args=(i,),
                         name=f"firehose-gossip-{i}", daemon=True)
        for i in range(n_gossip_producers)]

    def closer() -> None:
        for t in producers:
            t.join()
        node.queue.close()

    closer_thread = threading.Thread(target=closer, name="firehose-closer",
                                     daemon=True)
    t0 = time.perf_counter()
    for t in producers:
        t.start()
    closer_thread.start()
    try:
        # the zero-halt contract: this drain completing IS the assert —
        # every poison path below it contains instead of raising
        processed = node.run_apply_loop()
    except BaseException as exc:
        _fail(exc)
        node.queue.close()
        raise
    finally:
        closer_thread.join(timeout=producer_timeout)
        admission.set_orphan_expiry(prev_expiry)
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]

    from . import ingest, service

    snap = assert_bounded()
    n_blocks = len(corpus.chain)
    n_gossip = sum(len(v) for v in corpus.gossip.values())
    return {
        "node": node,
        "elapsed_s": round(elapsed, 3),
        "blocks": n_blocks,
        "gossip_attestations": n_gossip,
        "fork_blocks": len(corpus.fork_blocks),
        "slashings": len(corpus.slashings),
        "blocks_per_s": round(n_blocks / elapsed, 1),
        "atts_per_s": round(n_gossip / elapsed, 1),
        "processed_items": processed,
        "producer_threads": 3 + n_gossip_producers,
        "queue": ingest.snapshot(),
        "service": dict(service.stats),
        "admission": snap,
    }
