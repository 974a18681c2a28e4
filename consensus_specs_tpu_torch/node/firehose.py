"""Concurrent gossip firehose: production-shaped load for the node.

The differential suites prove the node is CORRECT one handler call at a
time; this module proves it serves: N epochs of blocks interleaved with
≥100k-attestation gossip batches, enqueued by concurrent producer
threads against the bounded ingest queue while the single-writer apply
loop drains — then the node's end state is replayed item-for-item
through the literal spec handlers and head/root parity is asserted
byte-exactly.  Because the parity leg replays the node's own apply
JOURNAL, the assertion is meaningful under nondeterministic producer
interleaving: whatever order the queue settled on, the spec agrees on
the resulting head.

Shape of a run (``run_firehose``):

* **one chain driver** enqueues (tick, block) pairs in chain order.  It
  fences at epoch boundaries: the tick entering epoch E waits until all
  gossip for epochs ≤ E-2 is enqueued — FIFO then guarantees those
  votes apply before their target epochs age out of the spec's
  current/previous-epoch window, exactly the pacing a live node's
  gossip mesh exhibits;
* **K gossip producers** split the gossip corpus by slot; each waits
  for the apply loop's clock to pass its slot (``Node.wait_for_clock``
  — votes must be mature on arrival) and enqueues that slot's
  attestations in batches.  Back-pressure from the bounded queue is the
  flow control;
* **the caller's thread runs the apply loop** — it IS the single
  writer; a closer thread joins the producers and closes the queue so
  the loop's drain terminates.

The corpus builder (``build_corpus``) is seeded and deterministic: full
blocks (each carrying the previous slot's committees as aggregate
attestations, so justification/finalization advance and the fork-choice
prune path runs mid-firehose) plus per-slot single-attester gossip
votes for the block at that slot — the unaggregated shape a node
serving heavy traffic sees.  Construction runs with BLS off and the
harness measures orchestration throughput BLS-off (pairing cost is
gated by the e2e bench rows; what the firehose gates is the composition
— stf fast path engaged per block, batched fork-choice ingest, queue
discipline under concurrency).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

from consensus_specs_tpu_torch.testing.helpers.attestations import (
    build_attestation_data,
)

from .service import Node, default_anchor_block


class FirehoseCorpus(NamedTuple):
    """A prepared firehose workload: the anchor, the signed chain, and
    the per-slot gossip votes."""

    anchor_block: object
    chain: List[object]              # signed blocks, chain order
    gossip: Dict[int, List[object]]  # slot -> single-attester attestations


def prepare_anchor(spec, state) -> None:
    """Give a synthetic state a genesis-style ``latest_block_header`` (in
    place) so ``default_anchor_block`` hashes to the children's parent
    root — the same trick the fork-choice ingest inputs use."""
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=state.slot,
        body_root=spec.hash_tree_root(spec.BeaconBlockBody()))


def _gossip_for_slot(spec, state, slot, block_root, quota) -> list:
    """Up to ``quota`` single-attester attestations voting ``block_root``
    at ``slot``, spread across the slot's committees.  ``state`` is the
    block's post-state (slot == state.slot), so the helper's
    slot-==-state.slot path would rebuild the head root — we already
    hold it."""
    epoch = spec.compute_epoch_at_slot(slot)
    current_start = spec.compute_start_slot_at_epoch(epoch)
    if slot == current_start:
        target_root = block_root
    else:
        target_root = spec.get_block_root(state, epoch)
    source = state.current_justified_checkpoint
    out = []
    committees = int(spec.get_committee_count_per_slot(state, epoch))
    while len(out) < quota:
        made_any = False
        for index in range(committees):
            committee = spec.get_beacon_committee(state, slot, index)
            size = len(committee)
            data = spec.AttestationData(
                slot=slot, index=index, beacon_block_root=block_root,
                source=spec.Checkpoint(epoch=source.epoch, root=source.root),
                target=spec.Checkpoint(epoch=epoch, root=target_root))
            for member in range(size):
                bits = [False] * size
                bits[member] = True
                out.append(spec.Attestation(
                    aggregation_bits=bits, data=data))
                made_any = True
                if len(out) >= quota:
                    return out
        if not made_any:  # empty committees: nothing to vote with
            return out
    return out


def build_corpus(spec, anchor_state, n_epochs: int = 2,
                 gossip_target: int = 100_000) -> FirehoseCorpus:
    """Deterministic chain + gossip over ``anchor_state``: ``n_epochs``
    of full blocks (aggregate attestations of the preceding slot's
    committees, capped at MAX_ATTESTATIONS) and ~``gossip_target``
    single-attester votes spread evenly over the slots.  Built with BLS
    off (the firehose measures orchestration, not pairing)."""
    from consensus_specs_tpu_torch.crypto import bls

    anchor_block = default_anchor_block(spec, anchor_state)
    n_slots = n_epochs * int(spec.SLOTS_PER_EPOCH)
    per_slot = max(1, -(-gossip_target // n_slots))  # ceil division
    was_active = bls.bls_active
    bls.bls_active = False
    try:
        build_st = anchor_state.copy()
        chain, gossip = [], {}
        first_slot = int(build_st.slot) + 1
        for slot in range(first_slot, first_slot + n_slots):
            stub = build_st.copy()
            spec.process_slots(stub, slot)
            block = spec.BeaconBlock(
                slot=slot,
                proposer_index=spec.get_beacon_proposer_index(stub))
            # an honest eth1 vote (the helper-block shape): a winning
            # empty vote at the voting-period boundary would reset
            # eth1_data under the deposit-count check and underflow it
            block.body.eth1_data.deposit_count = stub.eth1_deposit_index
            header = build_st.latest_block_header.copy()
            if header.state_root == spec.Root():
                header.state_root = build_st.hash_tree_root()
            block.parent_root = header.hash_tree_root()
            att_slot = slot - 1
            if att_slot >= first_slot:
                # previous slot's committees, full participation: the
                # realistic block payload that moves justification
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
            signed = spec.SignedBeaconBlock(message=block)
            chain.append(signed)
            gossip[slot] = _gossip_for_slot(
                spec, build_st, slot, block.hash_tree_root(), per_slot)
        return FirehoseCorpus(anchor_block, chain, gossip)
    finally:
        bls.bls_active = was_active


def replay_journal_literal(spec, anchor_state, anchor_block, journal):
    """The parity leg: replay a node's apply journal item-for-item
    through the literal spec handlers on a fresh store.  Returns the
    replayed store."""
    ref = spec.get_forkchoice_store(anchor_state, anchor_block)
    for kind, payload in journal:
        if kind == "tick":
            spec.on_tick(ref, payload)
        elif kind == "block":
            spec.on_block(ref, payload)
        elif kind == "attestations":
            for att in payload:
                spec.on_attestation(ref, att, is_from_block=False)
        elif kind == "attester_slashing":
            spec.on_attester_slashing(ref, payload)
        else:
            raise ValueError(f"unknown journal kind {kind!r}")
    return ref


def latest_votes(store) -> dict:
    """A store's latest messages as plain values, comparable across spec
    builds: validator index -> (epoch, root bytes)."""
    return {int(v): (int(m.epoch), bytes(m.root))
            for v, m in store.latest_messages.items()}


def assert_parity(spec, node: Node, ref) -> dict:
    """Byte-exact end-state parity between the node and a literal store:
    head root, the head block's state root, checkpoints, and the full
    latest-message map.  Returns the compared roots (for bench rows)."""
    # the spec materializes the justified checkpoint state lazily;
    # materialize it its own way before the literal walk
    spec.store_target_checkpoint_state(ref, ref.justified_checkpoint)
    head_node = bytes(node.get_head())
    head_ref = bytes(spec.get_head(ref))
    assert head_node == head_ref, \
        f"node head {head_node.hex()} != literal spec {head_ref.hex()}"
    state_root_node = bytes(
        node.store.block_states[head_node].hash_tree_root())
    state_root_ref = bytes(ref.block_states[head_ref].hash_tree_root())
    assert state_root_node == state_root_ref, \
        "head state root diverged from the literal spec replay"
    assert node.store.justified_checkpoint == ref.justified_checkpoint
    assert node.store.finalized_checkpoint == ref.finalized_checkpoint
    # by value: ``LatestMessage`` is a dataclass of its spec module, and
    # the literal leg may run on a spec built for another device
    assert latest_votes(node.store) == latest_votes(ref), \
        "latest messages diverged from the sequential spec fold"
    return {"head_root": "0x" + head_node.hex(),
            "head_state_root": "0x" + state_root_node.hex()}


def run_firehose(spec, anchor_state, corpus: FirehoseCorpus,
                 n_gossip_producers: int = 3, queue_cap: int = 64,
                 gossip_batch: int = 512,
                 producer_timeout: float = 300.0, on_node=None,
                 **node_kwargs) -> dict:
    """Serve ``corpus`` through a fresh ``Node`` under concurrent load:
    1 chain driver + ``n_gossip_producers`` gossip threads enqueue, the
    calling thread runs the single-writer apply loop.  Extra keyword
    arguments reach the ``Node`` constructor (``checkpoint_store=...``
    runs the firehose with durable checkpointing — the recovery bench's
    shape).  Returns the throughput/behavior row (the caller owns stats
    resets and the parity leg — see chip_smoke.py phase 10 and
    tests/test_torch_node.py)."""
    spe = int(spec.SLOTS_PER_EPOCH)
    genesis_time = int(anchor_state.genesis_time)
    sps = int(spec.config.SECONDS_PER_SLOT)
    node = Node(spec, anchor_state, corpus.anchor_block,
                queue_cap=queue_cap, **node_kwargs)
    if on_node is not None:
        # observer hook, invoked before any producer starts: the
        # query-load harness attaches its reader threads here
        on_node(node)

    slots = sorted(corpus.gossip)
    remaining_by_epoch: Dict[int, int] = {}
    for s in slots:
        e = s // spe
        remaining_by_epoch[e] = remaining_by_epoch.get(e, 0) + 1
    fence = threading.Condition()
    abort = threading.Event()
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
                # votes must be mature on arrival: wait until the apply
                # loop's clock passed the attested slot
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
            seen_epoch: Optional[int] = None
            for signed in corpus.chain:
                s = int(signed.message.slot)
                e = s // spe
                if e != seen_epoch:
                    # entering epoch e: every older epoch's gossip must
                    # be enqueued before the clock can age its targets
                    # out of the current/previous validity window
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
            # final tick: the last slot's gossip matures
            last = int(corpus.chain[-1].message.slot)
            node.enqueue_tick(genesis_time + (last + 1) * sps,
                              timeout=producer_timeout)
        except BaseException as exc:
            _fail(exc)

    producers = [threading.Thread(target=chain_driver,
                                  name="firehose-chain", daemon=True)]
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
        applied = node.run_apply_loop()
    except BaseException as exc:
        _fail(exc)
        node.queue.close()
        raise
    finally:
        closer_thread.join(timeout=producer_timeout)
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]

    n_blocks = len(corpus.chain)
    n_gossip = sum(len(v) for v in corpus.gossip.values())
    from . import ingest, service

    return {
        "node": node,
        "elapsed_s": round(elapsed, 3),
        "blocks": n_blocks,
        "gossip_attestations": n_gossip,
        "blocks_per_s": round(n_blocks / elapsed, 1),
        "atts_per_s": round(n_gossip / elapsed, 1),
        "applied_items": applied,
        "producer_threads": 1 + n_gossip_producers,
        "queue": ingest.snapshot(),
        "service": dict(service.stats),
    }
