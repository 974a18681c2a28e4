"""The port's adversarial firehose (``node/adversary.py``) against the JAX
package's, at the minimal preset, BLS off in both (the firehose's setting).

* the port builds the reference's corpus from the same genesis state
  (seed 90013, 3 epochs, 600 votes): every chain, gossip, shed, fork,
  orphan and slashing item has the reference's root, and the junk, the
  stall epochs and the future and duplicate schedules are equal;
* the survival contract of the reference's own suite
  (``tests/node/test_adversarial.py``) on the port's node: no halt,
  every block fast, the fork branch re-linked, the never-linkers
  expired, the future blocks parked and released, the junk rejected and
  its producer quarantined and shed, duplicates dropped, the slashing
  storm in the store, every admission ring within its cap;
* the served head and head state root equal the port's literal journal
  replay and the reference node's on the reference's corpus;
* the future blocks park even when their producer's thread is late, and
  the junk flooder is still scored at the end even when its thread runs
  early;
* journal recovery and the finality stall, as in the reference;
* the deep profile, ``slow`` as in the reference.
"""
import os
import threading
import time

import pytest

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.node import adversary as ref_adversary
from consensus_specs_tpu.node import service as ref_service
from consensus_specs_tpu_torch import stf
from consensus_specs_tpu_torch.node import adversary, firehose, service
from consensus_specs_tpu_torch.node.service import recover_node
from tests.torch_node_common import bls_off, pair  # noqa: F401

_RUN_KW = dict(n_gossip_producers=2, queue_cap=32, gossip_batch=64,
               producer_timeout=60.0)
_CACHE = {}


def _corpora():
    """``(ref_corpus, corpus)``: the adversarial corpus built by each
    package from the same minimal genesis state."""
    if "corpora" not in _CACHE:
        ref_spec, spec, ref_state, state = pair()
        _CACHE["corpora"] = (
            ref_adversary.build_adversarial_corpus(
                ref_spec, ref_state, n_epochs=3, gossip_target=600),
            adversary.build_adversarial_corpus(
                spec, state, n_epochs=3, gossip_target=600))
    return _CACHE["corpora"]


def _run(spec, state, corpus, **kw):
    """The port's adversarial firehose and its parity leg (the journal
    replayed through the literal spec handlers)."""
    service.reset_stats()
    stf.reset_stats()
    result = adversary.run_adversarial_firehose(spec, state, corpus, **kw)
    node = result["node"]
    ref = firehose.replay_journal_literal(
        spec, state, corpus.anchor_block, node.journal)
    result["parity"] = firehose.assert_parity(spec, node, ref)
    return result


def _served():
    """One served run of the port's corpus, shared by the tests that only
    read it (the counters are copied as the run left them)."""
    if "served" not in _CACHE:
        _, spec, _, state = pair()
        _, corpus = _corpora()
        result = _run(spec, state, corpus, **_RUN_KW)
        result["stf"] = {k: stf.stats[k] for k in (
            "fast_blocks", "replayed_blocks")}
        _CACHE["served"] = result
    return _CACHE["served"]


def _roots(items):
    return [bytes(x.hash_tree_root()) for x in items]


def _junk_shape(junk):
    # ``object()`` payloads differ by identity: compare their type only
    return [(kind, payload if isinstance(payload, (bytes, int, str, tuple))
             else type(payload).__name__) for kind, payload in junk]


@pytest.mark.parametrize("part", [
    "anchor_block", "chain", "gossip", "shed_gossip", "fork_blocks",
    "orphan_blocks", "slashings", "junk", "schedules"])
def test_port_builds_the_references_corpus(bls_off, part):  # noqa: F811
    ref_corpus, corpus = _corpora()
    if part == "anchor_block":
        assert bytes(corpus.anchor_block.hash_tree_root()) == \
            bytes(ref_corpus.anchor_block.hash_tree_root())
    elif part in ("gossip", "shed_gossip"):
        ours, theirs = getattr(corpus, part), getattr(ref_corpus, part)
        assert sorted(ours) == sorted(theirs)
        assert {s: _roots(v) for s, v in ours.items()} == \
            {s: _roots(v) for s, v in theirs.items()}
        assert sum(len(v) for v in ours.values()) > 0
    elif part == "junk":
        assert _junk_shape(corpus.junk) == _junk_shape(ref_corpus.junk)
    elif part == "schedules":
        for name in ("stall_epochs", "future_slots", "duplicate_slots"):
            assert getattr(corpus, name) == getattr(ref_corpus, name), name
        assert corpus.future_slots and corpus.duplicate_slots
    else:
        ours = _roots(getattr(corpus, part))
        assert ours == _roots(getattr(ref_corpus, part)) and ours


def test_adversarial_firehose_survival_contract(bls_off):  # noqa: F811
    """The whole arc in one concurrent run: every attack corpus lands,
    every survival counter moves, nothing halts, and the journal replays
    to the served head and head state root."""
    _, corpus = _corpora()
    result = _served()
    adm, svc = result["admission"], result["service"]
    assert result["stf"]["replayed_blocks"] == 0
    assert svc["blocks_applied"] == result["blocks"] + result["fork_blocks"]
    assert result["stf"]["fast_blocks"] == svc["blocks_applied"]
    assert svc["slashings_applied"] == len(corpus.slashings)
    assert adm["orphans_relinked"] == len(corpus.fork_blocks) - 1
    assert adm["orphans_expired"] == len(corpus.orphan_blocks)
    assert adm["parked"] == len(corpus.future_slots)
    assert adm["parked_released"] == len(corpus.future_slots)
    assert adm["malformed"] >= len(corpus.junk)
    assert adm["stale_ticks"] >= 1  # the clock-rewind attack died here
    assert adm["quarantines"] >= 1
    assert adm["shed_items"] >= 1
    assert "adv-junk" in adm["producer_scores"]
    assert adm["duplicates"] >= len(corpus.duplicate_slots)
    assert len(result["node"].store.equivocating_indices) > 0
    adversary.assert_bounded(adm)


def test_future_blocks_park_however_late_their_producer(bls_off,  # noqa: F811
                                                        monkeypatch):
    """The adversarial producer's future blocks park and are released even
    when its thread reaches the queue late: the chain's first tick waits
    for them, so the clock is still at the anchor when they are admitted."""
    from consensus_specs_tpu_torch.node.service import Node

    _, spec, _, state = pair()
    _, corpus = _corpora()
    enqueue_block, late = Node.enqueue_block, []

    def late_first_block(self, signed_block, timeout=None):
        if threading.current_thread().name == "adv-chain" and not late:
            late.append(signed_block)
            time.sleep(0.25)  # longer than the minimal run's whole chain
        return enqueue_block(self, signed_block, timeout=timeout)

    monkeypatch.setattr(Node, "enqueue_block", late_first_block)
    service.reset_stats()
    stf.reset_stats()
    adm = adversary.run_adversarial_firehose(
        spec, state, corpus, **_RUN_KW)["admission"]
    assert late
    assert adm["parked"] == adm["parked_released"] == len(corpus.future_slots)
    assert adm["orphans_expired"] == len(corpus.orphan_blocks)


def test_flooder_stays_scored_however_early_its_thread_runs(bls_off,  # noqa: F811
                                                           monkeypatch):
    """The junk flooder is still scored when the run ends even when its
    thread runs its whole schedule ahead of the chain: its clock waits
    after the chain's first slot, up to its last, return at once, so every
    scheduled charge lands early and would decay (0.75 a slot) for the
    rest of the chain.  Its last charge waits for the chain's final tick:
    the admission gate judges it after the run's last score decay."""
    from consensus_specs_tpu_torch.node import admission
    from consensus_specs_tpu_torch.node.service import Node

    _, spec, _, state = pair()
    _, corpus = _corpora()
    first_slot = int(corpus.chain[0].message.slot)
    last_slot = int(corpus.chain[-1].message.slot)
    wait_for_clock, early = Node.wait_for_clock, []

    def early_flooder(self, slot, timeout=None):
        if (threading.current_thread().name == "adv-junk"
                and first_slot < slot <= last_slot):
            early.append(slot)
            return True
        return wait_for_clock(self, slot, timeout=timeout)

    # the gate's charges and decays, in the order the apply loop made them
    events, charge, decay = [], admission._charge_locked, admission.decay_scores

    def logged_charge(producer, points):
        events.append(("charge", producer))
        return charge(producer, points)

    def logged_decay(slots_advanced):
        if slots_advanced > 0:
            events.append(("decay", None))
        return decay(slots_advanced)

    monkeypatch.setattr(Node, "wait_for_clock", early_flooder)
    monkeypatch.setattr(admission, "_charge_locked", logged_charge)
    monkeypatch.setattr(admission, "decay_scores", logged_decay)
    service.reset_stats()
    stf.reset_stats()
    adm = adversary.run_adversarial_firehose(
        spec, state, corpus, **_RUN_KW)["admission"]
    assert early == [s + 1 for s in corpus.duplicate_slots]
    last_decay = max(i for i, e in enumerate(events) if e[0] == "decay")
    last_charge = max(i for i, e in enumerate(events)
                      if e == ("charge", "adv-junk"))
    assert last_charge > last_decay
    assert adm["producer_scores"]["adv-junk"] >= admission.CHARGE_MALFORMED
    assert adm["quarantines"] >= 1


def test_served_head_equals_the_reference_nodes(bls_off):  # noqa: F811
    """The reference's adversarial firehose on its corpus reaches the
    head, head state root and equivocating indices the port's node
    reached on its own."""
    ref_spec, _, ref_state, _ = pair()
    ref_corpus, _ = _corpora()
    ref_service.reset_stats()
    ref_stf.reset_stats()
    ref_node = ref_adversary.run_adversarial_firehose(
        ref_spec, ref_state, ref_corpus, **_RUN_KW)["node"]
    node = _served()["node"]
    head = bytes(node.get_head())
    assert head == bytes(ref_node.get_head())
    assert bytes(node.store.block_states[head].hash_tree_root()) == bytes(
        ref_node.store.block_states[head].hash_tree_root())
    assert _served()["parity"]["head_root"] == "0x" + head.hex()
    assert sorted(int(i) for i in node.store.equivocating_indices) == \
        sorted(int(i) for i in ref_node.store.equivocating_indices)
    # the latest messages are not compared across the two runs: which
    # reserve votes the quarantine sheds depends on the threads'
    # interleaving (each run's votes equal its own literal replay's)


def test_adversarial_journal_recovers_after_crash(bls_off):  # noqa: F811
    """A fresh node rebuilt from the completed adversarial journal (forks,
    slashings, out-of-order re-links) reaches the served node's head,
    head state root, votes and equivocating indices."""
    _, spec, _, state = pair()
    _, corpus = _corpora()
    node = _served()["node"]
    head = bytes(node.get_head())
    service.reset_stats()
    recovered = recover_node(spec, state, corpus.anchor_block, node.journal,
                             retry_backoff_s=0.0)
    assert service.stats["recoveries"] == 1
    assert bytes(recovered.get_head()) == head
    assert bytes(recovered.store.block_states[head].hash_tree_root()) == \
        bytes(node.store.block_states[head].hash_tree_root())
    assert firehose.latest_votes(recovered.store) == \
        firehose.latest_votes(node.store)
    assert recovered.store.equivocating_indices == \
        node.store.equivocating_indices


def test_finality_stall_epoch_stalls_then_recovers(bls_off):  # noqa: F811
    """The stall epoch's blocks carry no attestations, and justification
    still moves past it once the tail epoch's votes land."""
    _, spec, _, _ = pair()
    _, corpus = _corpora()
    spe = int(spec.SLOTS_PER_EPOCH)
    stalled = corpus.stall_epochs[0]
    in_stall = [sb for sb in corpus.chain
                if (int(sb.message.slot) - 1) // spe == stalled]
    assert in_stall and all(
        len(sb.message.body.attestations) == 0 for sb in in_stall)
    assert int(_served()["node"].store.justified_checkpoint.epoch) >= 1


@pytest.mark.slow
def test_adversarial_firehose_deep_profile(bls_off):  # noqa: F811
    """The reference's deep profile on the port (the same environment
    knobs): a heavier seeded run with the same survival asserts."""
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.testing.context import (
        default_activation_threshold,
        default_balances,
    )
    from consensus_specs_tpu_torch.testing.helpers.genesis import (
        create_genesis_state,
    )

    spec = get_spec("phase0", "minimal", device="cpu")
    state = create_genesis_state(
        spec, default_balances(spec), default_activation_threshold(spec))
    corpus = adversary.build_adversarial_corpus(
        spec, state,
        n_epochs=int(os.environ.get("CSTPU_FIREHOSE_EPOCHS", "4")),
        gossip_target=int(os.environ.get("CSTPU_FIREHOSE_GOSSIP", "6000")),
        fork_len=7, n_orphans=5, n_slashings=8)
    result = _run(spec, state, corpus, n_gossip_producers=int(
        os.environ.get("CSTPU_FIREHOSE_PRODUCERS", "2")), queue_cap=32,
        gossip_batch=128, producer_timeout=120.0)
    assert stf.stats["replayed_blocks"] == 0
    adm = result["admission"]
    assert adm["orphans_relinked"] == len(corpus.fork_blocks) - 1
    assert adm["quarantines"] >= 1
    assert adm["malformed"] >= len(corpus.junk)
    adversary.assert_bounded()
