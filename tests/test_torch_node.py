"""The port's node (``node/``) against the JAX package's, at the minimal
preset, BLS off in both (the firehose's setting).

* the minimal firehose (2 epochs, 600 votes, 3 gossip producers and a
  chain driver over a 16-item queue) through the port's node and the
  reference's: the same head root and head state root, each equal to its
  own literal journal replay; the same journal tokens (as a multiset: the
  producers interleave differently from run to run), and the port's
  journal replayed literally by the reference reaches the port's head;
* the same corpus in one deterministic order through both nodes: the
  same journal, token for token, and the same head;
* the admission gate: blocks delivered child before parent, and every
  block twice, converge to the literal spec fed in order;
* the single-writer contract, crash recovery by full journal replay, and
  the node's fault sites (enqueue, apply, recover).
"""
import collections
import threading

import pytest

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.node import firehose as ref_firehose
from consensus_specs_tpu.node import service as ref_service
from consensus_specs_tpu_torch import faults, stf
from consensus_specs_tpu_torch.node import admission, firehose, ingest, service
from tests.torch_node_common import (  # noqa: F401
    bls_off,
    pair,
    port_corpus,
    serve,
    to_port,
)

_CORPUS = {}


def _corpora():
    """The reference-built minimal firehose corpus and its port copy."""
    if not _CORPUS:
        ref_spec, spec, ref_state, _ = pair()
        from consensus_specs_tpu.crypto import bls as ref_bls

        saved, ref_bls.bls_active = ref_bls.bls_active, False
        try:
            ref_corpus = ref_firehose.build_corpus(
                ref_spec, ref_state, n_epochs=2, gossip_target=600)
        finally:
            ref_bls.bls_active = saved
        _CORPUS["phase0"] = (ref_corpus,
                             port_corpus(spec, ref_corpus, firehose))
    return _CORPUS["phase0"]


def _tokens(module, journal):
    return [module._journal_token(e) for e in journal]


def _to_ref_journal(ref_spec, journal):
    out = []
    for kind, payload in journal:
        if kind == "block":
            payload = to_port(ref_spec.SignedBeaconBlock, payload)
        elif kind == "attestations":
            payload = [to_port(ref_spec.Attestation, a) for a in payload]
        out.append((kind, payload))
    return out


def test_port_builds_the_references_corpus(bls_off):
    ref_spec, spec, _ref_state, state = pair()
    ref_corpus, _ = _corpora()
    corpus = firehose.build_corpus(spec, state, n_epochs=2, gossip_target=600)
    assert [bytes(b.encode_bytes()) for b in corpus.chain] == \
        [bytes(b.encode_bytes()) for b in ref_corpus.chain]
    assert {s: [bytes(a.encode_bytes()) for a in v]
            for s, v in corpus.gossip.items()} == \
        {s: [bytes(a.encode_bytes()) for a in v]
         for s, v in ref_corpus.gossip.items()}


def test_firehose_matches_the_references(bls_off):
    ref_spec, spec, ref_state, state = pair()
    ref_corpus, corpus = _corpora()
    rows = {}
    for name, mod, engine, fh, sp, st, cp in (
            ("port", service, stf, firehose, spec, state, corpus),
            ("ref", ref_service, ref_stf, ref_firehose, ref_spec, ref_state,
             ref_corpus)):
        mod.reset_stats()
        engine.reset_stats()
        run = fh.run_firehose(sp, st, cp, n_gossip_producers=3, queue_cap=16,
                              gossip_batch=64, producer_timeout=60.0)
        node = run["node"]
        assert engine.stats["fast_blocks"] == run["blocks"]
        assert engine.stats["replayed_blocks"] == 0
        literal = fh.replay_journal_literal(sp, st, cp.anchor_block,
                                            node.journal)
        rows[name] = (run, node, fh.assert_parity(sp, node, literal))
    run, node, parity = rows["port"]
    assert parity == rows["ref"][2]
    assert run["producer_threads"] == 4
    assert run["blocks"] == 2 * int(spec.SLOTS_PER_EPOCH)
    assert run["gossip_attestations"] >= 600
    assert run["service"]["blocks_applied"] == run["blocks"]
    assert run["service"]["rejected_batches"] == 0
    assert run["queue"]["enqueued"] > 16
    assert collections.Counter(_tokens(service, node.journal)) == \
        collections.Counter(_tokens(ref_service, rows["ref"][1].journal))
    cross = ref_firehose.replay_journal_literal(
        ref_spec, ref_state, ref_corpus.anchor_block,
        _to_ref_journal(ref_spec, node.journal))
    assert "0x" + bytes(ref_spec.get_head(cross)).hex() == parity["head_root"]


def test_one_order_gives_the_same_journal(bls_off):
    ref_spec, spec, ref_state, state = pair()
    ref_corpus, corpus = _corpora()
    node = serve(spec, state, corpus, service.Node)
    ref_node = serve(ref_spec, ref_state, ref_corpus, ref_service.Node)
    assert _tokens(service, node.journal) == \
        _tokens(ref_service, ref_node.journal)
    assert bytes(node.get_head()) == bytes(ref_node.get_head())
    head = bytes(node.get_head())
    assert bytes(node.store.block_states[head].hash_tree_root()) == bytes(
        ref_node.store.block_states[head].hash_tree_root())
    recovered = service.recover_node(spec, state, corpus.anchor_block,
                                     node.journal)
    assert bytes(recovered.get_head()) == head
    assert recovered.journal == node.journal


def test_parity_holds_against_a_spec_built_apart(bls_off):
    """The literal leg on a spec module built apart from the node's (as
    the card's node is checked against a CPU-built spec): its types are
    its own, and the parity holds by value."""
    from consensus_specs_tpu_torch.specs.builder import build_spec

    _ref_spec, spec, _ref_state, state = pair()
    _, corpus = _corpora()
    node = serve(spec, state, corpus, service.Node)
    other = build_spec("phase0", "minimal", "cpu", name="parity_apart")
    assert other is not spec
    journal = []
    for kind, payload in node.journal:
        if kind == "block":
            payload = to_port(other.SignedBeaconBlock, payload)
        elif kind == "attestations":
            payload = [to_port(other.Attestation, a) for a in payload]
        journal.append((kind, payload))
    literal = firehose.replay_journal_literal(
        other, to_port(other.BeaconState, state),
        to_port(other.BeaconBlock, corpus.anchor_block), journal)
    assert firehose.assert_parity(other, node, literal)["head_root"] == \
        "0x" + bytes(node.get_head()).hex()


def _literal_in_order(spec, state, anchor, chain, final_time):
    ref = spec.get_forkchoice_store(state, anchor)
    spec.on_tick(ref, final_time)
    for sb in chain:
        spec.on_block(ref, sb)
    return ref


@pytest.mark.parametrize("delivery", ["reversed", "twice"])
def test_admission_converges_to_the_in_order_spec(bls_off, delivery):
    ref_spec, spec, ref_state, state = pair()
    _, corpus = _corpora()
    chain = corpus.chain[:int(spec.SLOTS_PER_EPOCH)]
    admission.reset_stats()
    node = service.Node(spec, state, corpus.anchor_block, retry_backoff_s=0.0)
    last = int(chain[-1].message.slot)
    final_time = int(state.genesis_time) + (last + 1) * int(
        spec.config.SECONDS_PER_SLOT)
    node.enqueue_tick(final_time)
    if delivery == "reversed":
        for sb in reversed(chain):
            node.enqueue_block(sb)
    else:
        for sb in chain:
            node.enqueue_block(sb)
            node.enqueue_block(
                spec.SignedBeaconBlock.decode_bytes(sb.encode_bytes()))
    node.queue.close()
    node.run_apply_loop()
    ref = _literal_in_order(
        ref_spec, ref_state, to_port(ref_spec.BeaconBlock, corpus.anchor_block),
        [to_port(ref_spec.SignedBeaconBlock, sb) for sb in chain], final_time)
    head = bytes(node.get_head())
    assert head == bytes(ref_spec.get_head(ref))
    assert bytes(node.store.block_states[head].hash_tree_root()) == bytes(
        ref.block_states[head].hash_tree_root())
    if delivery == "reversed":
        assert admission.stats["orphaned"] == len(chain) - 1
        assert admission.stats["orphans_relinked"] == len(chain) - 1
    else:
        assert admission.stats["duplicates"] == len(chain)


def _enqueue_prefix(spec, node, corpus, n_blocks):
    """Ticks and the first ``n_blocks`` blocks, then the first block's
    gossip, on one thread (the reference chaos suite's workload)."""
    sps = int(spec.config.SECONDS_PER_SLOT)
    for signed in corpus.chain[:n_blocks]:
        node.enqueue_tick(int(node.store.genesis_time)
                          + int(signed.message.slot) * sps)
        node.enqueue_block(signed)
    last = int(corpus.chain[n_blocks - 1].message.slot)
    node.enqueue_tick(int(node.store.genesis_time) + (last + 1) * sps)
    node.enqueue_attestations(corpus.gossip[int(corpus.chain[0].message.slot)])
    node.queue.close()


def test_the_nodes_fault_sites_leave_it_consistent(bls_off):
    """The port's own fault sites: a failed enqueue leaves the queue as it
    was; a transient apply fault re-queues the item at the head and the
    retry lands it (journal parity after); a failed recovery discards the
    half-built node and the retry rebuilds the same head."""
    _ref_spec, spec, _ref_state, state = pair()
    _, corpus = _corpora()
    node = service.Node(spec, state, retry_backoff_s=0.0)
    with faults.inject(faults.FaultPlan([faults.Fault("node.enqueue")])):
        with pytest.raises(faults.InjectedFault):
            node.enqueue_block(corpus.chain[0])
    assert node.queue.depth() == 0

    service.reset_stats()
    _enqueue_prefix(spec, node, corpus, 3)
    # hit 4 is the second block's apply (tick, block, tick, block)
    with faults.inject(faults.FaultPlan([faults.Fault("node.apply", nth=4)])):
        node.run_apply_loop()
    assert service.stats["retried_items"] == 1
    assert service.stats["quarantined_items"] == 0
    assert service.stats["blocks_applied"] == 3
    literal = firehose.replay_journal_literal(spec, state, corpus.anchor_block,
                                              node.journal)
    firehose.assert_parity(spec, node, literal)

    with faults.inject(faults.FaultPlan([faults.Fault("node.recover")])):
        with pytest.raises(faults.InjectedFault):
            service.recover_node(spec, state, corpus.anchor_block,
                                 node.journal)
    assert service.stats["recoveries"] == 0
    recovered = service.recover_node(spec, state, corpus.anchor_block,
                                     node.journal)
    assert bytes(recovered.get_head()) == bytes(node.get_head())
    assert ingest.IngestQueue(cap=4).drain(max_items=0) == []


def test_orphan_expiry_setting_is_restored(bls_off):
    prev = admission.set_orphan_expiry(4)
    try:
        assert admission.set_orphan_expiry(4) == 4
    finally:
        admission.set_orphan_expiry(prev)
    assert admission.ORPHAN_EXPIRY_SLOTS == prev


def test_a_second_writer_raises(bls_off):
    _ref_spec, spec, _ref_state, state = pair()
    node = service.Node(spec, state)
    entered, release = threading.Event(), threading.Event()

    def hold():
        with node._single_writer():
            entered.set()
            release.wait(10.0)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert entered.wait(10.0)
        with pytest.raises(RuntimeError):
            node.on_tick(int(state.genesis_time) + 6)
    finally:
        release.set()
        t.join()


def test_ingest_queue_blocks_when_full_and_ends_when_closed():
    q = ingest.IngestQueue(cap=1)
    q.put("tick", 1)
    assert not q.try_put("tick", 2)
    q.close()
    assert q.get(timeout=0.1).payload == 1
    assert q.get(timeout=0.1) is None
