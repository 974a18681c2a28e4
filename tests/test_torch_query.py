"""The port's query engine (``query/``) against the JAX package's.

* every point query served off the same checkpoint artifacts (summary,
  balance, validator status, latest vote, historical roots, the
  materialized state) equals the reference's, and every Merkle proof is
  byte-equal and verifies with the spec's ``is_valid_merkle_branch``;
* the port's engine over the reference's files serves the same proofs;
* a mainnet-shape state at 16,384 validators through a checkpoint
  artifact: the port's proofs equal the reference's, served without
  materializing the state;
* a cold-start snapshot the port writes is the file the reference
  writes, and the reference restores it;
* the query readers against the port's live minimal firehose: no reader
  error, every cache within its cap, and the literal spec replay of the
  journal still agrees.
"""
import os
import random
import shutil

import pytest

import bench
from consensus_specs_tpu import query as ref_query
from consensus_specs_tpu.node.service import (
    default_anchor_block as ref_default_anchor_block,
)
from consensus_specs_tpu.persist import store as ref_store_mod
from consensus_specs_tpu.query import coldstart as ref_coldstart
from consensus_specs_tpu.query.engine import QueryEngine as RefQueryEngine
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu_torch import query, scenario
from consensus_specs_tpu_torch.node import firehose
from consensus_specs_tpu_torch.node.service import default_anchor_block
from consensus_specs_tpu_torch.persist import store as store_mod
from consensus_specs_tpu_torch.query import coldstart, harness
from consensus_specs_tpu_torch.query.engine import QueryEngine
from consensus_specs_tpu_torch.query.streamproof import verify_proof
from consensus_specs_tpu_torch.specs import get_spec
from tests.torch_node_common import (  # noqa: F401
    bls_off,
    own_index,
    pair,
    served,
)


@pytest.fixture(autouse=True)
def _own_index(own_index):
    query.reset_stats()
    ref_query.reset_stats()
    yield


def _proof_is_valid(spec, pr) -> bool:
    g = int(pr["gindex"])
    depth = g.bit_length() - 1
    return bool(spec.is_valid_merkle_branch(
        spec.Bytes32(pr["leaf"]), [spec.Bytes32(b) for b in pr["branch"]],
        depth, g - (1 << depth), spec.Root(pr["state_root"])))


def _same_answers(spec, engine, ref_engine, indices):
    assert engine.summary() == ref_engine.summary()
    assert engine.historical_roots() == ref_engine.historical_roots()
    for i in indices:
        assert engine.balance_of(i) == ref_engine.balance_of(i)
        assert engine.validator_status(i) == ref_engine.validator_status(i)
        assert engine.vote_of(i) == ref_engine.vote_of(i)
        pr, ref_pr = engine.proof_of_validator(i), \
            ref_engine.proof_of_validator(i)
        assert pr == ref_pr
        assert _proof_is_valid(spec, pr)
        assert verify_proof(pr["leaf"], pr["branch"], pr["gindex"],
                            pr["state_root"])
        bad = dict(pr, leaf=bytes([pr["leaf"][0] ^ 1]) + pr["leaf"][1:])
        assert not _proof_is_valid(spec, bad)


def test_point_queries_and_proofs_equal_the_references(served):
    spec = served["spec"]
    node, ref_node = served["node"], served["ref_node"]
    n = len(served["state"].validators)
    _same_answers(spec, node.query_engine, ref_node.query_engine,
                  [0, 1, n // 2, n - 1])
    for root in node.query_engine.historical_roots():
        st = node.query_engine.state_at_root(root)
        ref_st = ref_node.query_engine.state_at_root(root)
        assert bytes(st.hash_tree_root()) == root
        assert bytes(st.encode_bytes()) == bytes(ref_st.encode_bytes())
    gauges = node.query_engine.cache_gauges()
    for name in ("artifact_index", "proof_cache", "resident"):
        assert gauges[f"{name}_size"] <= gauges[f"{name}_cap"]


def test_port_engine_over_the_references_files(served, tmp_path):
    directory = str(tmp_path / "ref_files")
    shutil.copytree(served["ref_dir"], directory)
    spec = served["spec"]
    engine = QueryEngine(spec, store_mod.CheckpointStore(
        directory, asynchronous=False))
    n = len(served["state"].validators)
    _same_answers(spec, engine, served["ref_node"].query_engine,
                  random.Random(2).sample(range(n), 6))
    engine.reset()


def _engine_over_artifact(mod, engine_cls, spec, state, anchor_fn, directory):
    anchor_block = anchor_fn(spec, state)
    root = bytes(anchor_block.hash_tree_root())
    payload = mod.CheckpointPayload(
        journal_pos=1, trigger=("tick", 0), time=int(state.genesis_time),
        justified=(0, root), best_justified=(0, root), finalized=(0, root),
        proposer_boost_root=b"\x00" * 32, latest_messages={},
        equivocating=frozenset(), anchor_root=root,
        window=((root, anchor_block, state),),
        head_state_root=bytes(state.hash_tree_root()))
    store = mod.CheckpointStore(directory, asynchronous=False)
    store.write_checkpoint(spec, payload)
    return engine_cls(spec, store)


def test_proofs_at_16384_validators_equal_the_references(tmp_path):
    n = 16_384
    spec = get_spec("phase0", "mainnet", device="cpu")
    ref_spec = ref_get_spec("phase0", "mainnet")
    state = scenario.build_state(spec, n)
    ref_state = bench.build_state(ref_spec, n)
    root = bytes(state.hash_tree_root())
    assert root == bytes(ref_state.hash_tree_root())
    engine = _engine_over_artifact(store_mod, QueryEngine, spec, state,
                                   default_anchor_block, str(tmp_path / "p"))
    ref_engine = _engine_over_artifact(
        ref_store_mod, RefQueryEngine, ref_spec, ref_state,
        ref_default_anchor_block, str(tmp_path / "r"))
    indices = random.Random(0xC0FFEE).sample(range(n), 12) + [0, n - 1]
    _same_answers(spec, engine, ref_engine, indices)
    for i in indices:
        assert engine.balance_of(i) == int(state.balances[i])
    assert query.stats["state_materializations"] == 0
    engine.reset()
    ref_engine.reset()


def test_cold_start_snapshot_is_the_references_file(tmp_path):
    ref_spec, spec, ref_state, port_state = pair()
    coldstart.forget_verified()
    ref_coldstart.forget_verified()
    n = len(port_state.validators)
    calls = []

    def build():
        calls.append(1)
        return port_state.copy()

    state = coldstart.restore_or_build(spec, n, build, label="t",
                                       cache_dir=str(tmp_path / "p"))
    ref_coldstart.write_snapshot(ref_spec, ref_state, n, label="t",
                                 cache_dir=str(tmp_path / "r"))
    path = coldstart.snapshot_path(spec, n, "t", str(tmp_path / "p"))
    ref_path = ref_coldstart.snapshot_path(ref_spec, n, "t",
                                           str(tmp_path / "r"))
    assert os.path.basename(path) == os.path.basename(ref_path)
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    coldstart.forget_verified()
    again = coldstart.restore_or_build(spec, n, build, label="t",
                                       cache_dir=str(tmp_path / "r"))
    assert calls == [1] and query.stats["coldstart_restores"] == 1
    assert bytes(again.hash_tree_root()) == bytes(state.hash_tree_root())
    restored = ref_coldstart.restore_or_build(
        ref_spec, n, lambda: None, label="t", cache_dir=str(tmp_path / "p"))
    assert bytes(restored.hash_tree_root()) == bytes(state.hash_tree_root())


def test_query_readers_ride_the_live_firehose(bls_off, tmp_path):
    _ref_spec, spec, _ref_state, state = pair()
    corpus = firehose.build_corpus(spec, state, n_epochs=3, gossip_target=200)
    store = store_mod.CheckpointStore(str(tmp_path))
    try:
        run = harness.run_query_load(spec, state, corpus, n_query_threads=2,
                                     checkpoint_store=store)
        node, ql = run["node"], run["query_load"]
        assert store.flush(timeout=60.0)
        assert ql["threads"] == 2 and ql["ops"] > 0
        assert ql["served"] > 0 and ql["errors"] == 0, ql
        gauges = node.query_engine.cache_gauges()
        for name in ("artifact_index", "proof_cache", "resident"):
            assert gauges[f"{name}_size"] <= gauges[f"{name}_cap"]
        ref = firehose.replay_journal_literal(
            spec, state, corpus.anchor_block, node.journal)
        firehose.assert_parity(spec, node, ref)
    finally:
        store.close()


def test_query_load_needs_a_checkpoint_store(bls_off):
    _ref_spec, spec, _ref_state, state = pair()
    corpus = firehose.build_corpus(spec, state, n_epochs=2, gossip_target=60)
    with pytest.raises(RuntimeError):
        harness.run_query_load(spec, state, corpus, n_query_threads=1,
                               checkpoint_store=None)
