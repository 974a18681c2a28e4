"""On the card: the node's serving path on CUDA-built specs against
CPU-built ones, at the minimal preset, BLS off.

* the minimal firehose (2 epochs, 600 votes, 3 gossip producers) through a
  node on a CUDA-built spec and through one on a CPU-built spec: every
  block fast, the same head root and head state root, each equal to the
  literal replay of its own journal;
* crash recovery on a CUDA-built spec from checkpoints a CPU-built node
  wrote;
* ``segment_sum``'s ``"torch"`` branch on the card against numpy.

``cuda``-marked: each test skips on a host without a card (the fixture
decides), and this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch import stf
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.node import firehose, service
from consensus_specs_tpu_torch.ops import segment
from consensus_specs_tpu_torch.persist import store as persist_store
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu_torch.testing.helpers.genesis import (
    create_genesis_state,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    prev = bls.bls_active
    bls.bls_active = False
    try:
        yield "cuda"
    finally:
        bls.bls_active = prev


def _legs(device):
    """``{device: (spec, genesis, corpus)}`` for the card and the CPU, the
    card's corpus decoded from the CPU-built one's bytes."""
    out = {}
    for dev in ("cpu", device):
        spec = get_spec("phase0", "minimal", device=dev)
        state = create_genesis_state(spec, default_balances(spec),
                                     default_activation_threshold(spec))
        if dev == "cpu":
            corpus = firehose.build_corpus(spec, state, n_epochs=2,
                                           gossip_target=600)
        else:
            base = out["cpu"][2]
            corpus = firehose.FirehoseCorpus(
                spec.BeaconBlock.decode_bytes(base.anchor_block.encode_bytes()),
                [spec.SignedBeaconBlock.decode_bytes(b.encode_bytes())
                 for b in base.chain],
                {s: [spec.Attestation.decode_bytes(a.encode_bytes())
                     for a in v] for s, v in base.gossip.items()})
        out[dev] = (spec, state, corpus)
    return out


@pytest.mark.cuda
def test_firehose_on_the_card_equals_the_cpu(cuda_device):
    parity = {}
    for dev, (spec, state, corpus) in _legs(cuda_device).items():
        service.reset_stats()
        stf.reset_stats()
        run = firehose.run_firehose(spec, state, corpus, n_gossip_producers=3,
                                    queue_cap=16, gossip_batch=64,
                                    producer_timeout=60.0)
        assert stf.stats["fast_blocks"] == run["blocks"] == 16
        assert stf.stats["replayed_blocks"] == 0
        assert run["service"]["rejected_batches"] == 0
        node = run["node"]
        literal = firehose.replay_journal_literal(
            spec, state, corpus.anchor_block, node.journal)
        parity[dev] = firehose.assert_parity(spec, node, literal)
    assert parity[cuda_device] == parity["cpu"]


@pytest.mark.cuda
def test_card_node_recovers_from_cpu_checkpoints(cuda_device, tmp_path):
    legs = _legs(cuda_device)
    spec, state, corpus = legs["cpu"]
    store = persist_store.CheckpointStore(str(tmp_path), asynchronous=False)
    node = service.Node(spec, state, corpus.anchor_block,
                        checkpoint_store=store)
    sps = int(spec.config.SECONDS_PER_SLOT)
    for signed in corpus.chain:
        s = int(signed.message.slot)
        node.enqueue_tick(int(state.genesis_time) + s * sps)
        node.enqueue_block(signed)
        for att in corpus.gossip.get(s - 1, ()):
            node.enqueue_attestations([att])
    node.queue.close()
    node.run_apply_loop()
    card_spec, card_state, card_corpus = legs[cuda_device]
    journal = []
    for kind, payload in node.journal:
        if kind == "block":
            payload = card_spec.SignedBeaconBlock.decode_bytes(
                payload.encode_bytes())
        elif kind == "attestations":
            payload = [card_spec.Attestation.decode_bytes(a.encode_bytes())
                       for a in payload]
        journal.append((kind, payload))
    service.reset_stats()
    recovered = service.recover_node(
        card_spec, card_state, card_corpus.anchor_block, journal,
        checkpoint_store=persist_store.CheckpointStore(
            str(tmp_path), asynchronous=False))
    assert service.stats["checkpoint_recoveries"] == 1
    head = bytes(node.get_head())
    assert bytes(recovered.get_head()) == head
    assert bytes(recovered.store.block_states[head].hash_tree_root()) == \
        bytes(node.store.block_states[head].hash_tree_root())
    persist_store.reset_index()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5000, 400_000])
def test_segment_sum_torch_on_the_card(cuda_device, n):
    rng = np.random.default_rng(n)
    values = rng.integers(0, 32_000_000_000, n)
    ids = rng.integers(0, 300, n)
    assert np.array_equal(
        segment.segment_sum(values, ids, 300, "torch", cuda_device),
        segment.segment_sum(values, ids, 300, "numpy"))
