"""Shared by the port's serving-path tests (``tests/test_torch_forkchoice.py``,
``test_torch_persist.py``, ``test_torch_query.py``, ``test_torch_node.py``):
minimal-preset spec pairs, objects carried between the two SSZ type
systems by their bytes, and the BLS switch of both packages."""
import pytest

from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs import get_spec

_PAIRS = {}


@pytest.fixture
def bls_off():
    """Signature checks off in both packages (the firehose's and the
    fork-choice ingest rows' setting), restored after."""
    saved = (ref_bls.bls_active, bls.bls_active)
    ref_bls.bls_active = False
    bls.bls_active = False
    try:
        yield
    finally:
        ref_bls.bls_active, bls.bls_active = saved


def to_port(port_type, ref_obj):
    return port_type.decode_bytes(bytes(ref_obj.encode_bytes()))


def pair(fork: str = "phase0"):
    """``(ref_spec, port_spec, ref_genesis, port_genesis)`` at the minimal
    preset, the port's spec built for the CPU; the genesis states are the
    reference's, the port's decoded from its bytes (callers copy them)."""
    if fork not in _PAIRS:
        ref_spec = ref_get_spec(fork, "minimal")
        spec = get_spec(fork, "minimal", device="cpu")
        ref_state = create_genesis_state(
            ref_spec, default_balances(ref_spec),
            default_activation_threshold(ref_spec))
        _PAIRS[fork] = (ref_spec, spec, ref_state,
                        to_port(spec.BeaconState, ref_state))
    return _PAIRS[fork]


def port_corpus(spec, ref_corpus, firehose):
    """The reference's ``FirehoseCorpus`` as the port's, object by object."""
    return firehose.FirehoseCorpus(
        to_port(spec.BeaconBlock, ref_corpus.anchor_block),
        [to_port(spec.SignedBeaconBlock, b) for b in ref_corpus.chain],
        {s: [to_port(spec.Attestation, a) for a in atts]
         for s, atts in ref_corpus.gossip.items()})


def serve(spec, state, corpus, node_cls, **node_kwargs):
    """A node over ``state`` fed ``corpus`` in one deterministic order (a
    tick and a block a slot, the previous slot's votes one batch each)
    and drained by its apply loop on this thread; returns the node."""
    node = node_cls(spec, state, corpus.anchor_block, **node_kwargs)
    sps = int(spec.config.SECONDS_PER_SLOT)
    for signed in corpus.chain:
        s = int(signed.message.slot)
        node.enqueue_tick(int(state.genesis_time) + s * sps)
        node.enqueue_block(signed)
        for att in corpus.gossip.get(s - 1, ()):
            node.enqueue_attestations([att])
    last = int(corpus.chain[-1].message.slot)
    node.enqueue_tick(int(state.genesis_time) + (last + 1) * sps)
    node.queue.close()
    node.run_apply_loop()
    return node


@pytest.fixture(scope="session")
def served(tmp_path_factory):
    """The same minimal corpus (3 epochs, 120 votes; built by the
    reference, carried over by bytes) served through the port's node and
    the reference's, each with a synchronous checkpoint store of its
    own.  Returns a dict: the specs, the anchor states, the corpora, the
    nodes and the two checkpoint directories."""
    from consensus_specs_tpu.node import firehose as ref_firehose
    from consensus_specs_tpu.node import service as ref_service
    from consensus_specs_tpu.persist import store as ref_store_mod
    from consensus_specs_tpu_torch.node import firehose, service
    from consensus_specs_tpu_torch.persist import store as store_mod

    ref_spec, spec, ref_state, port_state = pair()
    saved = (ref_bls.bls_active, bls.bls_active)
    ref_bls.bls_active = bls.bls_active = False
    try:
        ref_corpus = ref_firehose.build_corpus(
            ref_spec, ref_state, n_epochs=3, gossip_target=120)
        corpus = port_corpus(spec, ref_corpus, firehose)
        port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
        ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
        port_store = store_mod.CheckpointStore(port_dir, asynchronous=False)
        ref_store = ref_store_mod.CheckpointStore(ref_dir, asynchronous=False)
        node = serve(spec, port_state, corpus, service.Node,
                     checkpoint_store=port_store)
        ref_node = serve(ref_spec, ref_state, ref_corpus, ref_service.Node,
                         checkpoint_store=ref_store)
    finally:
        ref_bls.bls_active, bls.bls_active = saved
    yield {"ref_spec": ref_spec, "spec": spec, "ref_state": ref_state,
           "state": port_state, "ref_corpus": ref_corpus, "corpus": corpus,
           "node": node, "ref_node": ref_node, "port_dir": port_dir,
           "ref_dir": ref_dir}
    port_store.close()
    ref_store.close()
    for mod in (store_mod, ref_store_mod):
        mod.reset_index()


@pytest.fixture
def own_index():
    """Each test leaves both packages' module-wide checkpoint index and
    counters as it found them (the artifacts on disk stay)."""
    from consensus_specs_tpu.persist import store as ref_store_mod
    from consensus_specs_tpu_torch.persist import store as store_mod

    saved = [(mod, dict(mod._INDEX)) for mod in (store_mod, ref_store_mod)]
    for mod, _ in saved:
        mod.reset_stats()
    yield
    for mod, index in saved:
        mod.reset_stats()
        mod.reset_index()
        with mod._INDEX_LOCK:
            mod._INDEX.update(index)
