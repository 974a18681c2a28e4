"""The torch port's block engine on the altair lineage, against the
reference engine and the port's literal ``spec.state_transition``, with
BLS on.

The engine's altair fast path folds each block's sync aggregate into its
signature batch, scatters participation flags on a staged column and
applies sync rewards as net per-validator deltas.  A broken fast path
still gives the right root through the literal replay, so every engine
run also holds the engine's counters (every block fast, none replayed).

* minimal preset: the corpus of tests/test_torch_spec_altair.py (two
  epoch transitions, full, partial and empty sync participation), roots
  equal to the reference engine's and the literal spec's after every
  block, pipeline on and off, then the whole walk in one call;
* failure behavior: a tampered sync signature, empty participation
  without the infinity signature, and a block whose sync penalty would
  floor a balance fail or replay exactly as in the reference engine;
* ``stf.sync``: the seat rows equal the reference's (duplicate pubkeys
  included), and the net-delta rewards raise ``FastPathViolation`` where
  the reference's raise;
* the resident route forced on the CPU on the minimal corpus: each
  block's state-root check reduces the balances touched by the sync
  rewards with the plain reduction, as K2 does on the card;
* mainnet preset at 16,384 validators: the main path's altair epoch
  through the engine, pipeline on and off, on the host hashing path that a
  CPU spec keeps by default;
* the 400,000-validator altair epoch through the engine (``slow``).
"""
import numpy as np
import pytest

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.stf import attestations as ref_attestations
from consensus_specs_tpu.stf import sync as ref_sync
from consensus_specs_tpu.stf import verify as ref_verify
from consensus_specs_tpu.testing.helpers.block import build_empty_block_for_next_slot
from consensus_specs_tpu.testing.helpers.state import state_transition_and_sign_block
from consensus_specs_tpu_torch import scenario, stf, tracing
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.stf import attestations, pipeline, sync, verify

from .test_torch_spec_altair import (
    altair_corpus,
    bls_on,
    mainnet_epoch,
    sync_aggregate,
    to_port,
)

__all__ = ["bls_on"]  # the fixture, shared with the spec tests


def _fresh_engines():
    """Both engines cold: counters zeroed, breaker closed, no degradation,
    empty verified-triple memo, geometry caches and sync seat rows."""
    for engine, settle, plans in ((stf, verify, attestations),
                                  (ref_stf, ref_verify, ref_attestations)):
        engine.reset_stats()
        settle.reset_memo()
        settle.reset_degraded()
        plans.reset_caches()


def _assert_all_fast(n_blocks):
    """The engine counter contract: every block on the fast path."""
    assert stf.stats["fast_blocks"] == n_blocks, stf.stats
    assert stf.stats["replayed_blocks"] == 0, stf.stats["replay_reasons"]
    assert stf.stats["replay_reasons"] == {}
    assert stf.stats["breaker_trips"] == 0
    assert verify.stats["native_degraded"] == 0
    assert not verify.native_degraded()


@pytest.fixture
def tracing_on():
    """The port's tracing counters on and zeroed, restored after."""
    was = tracing.enabled()
    tracing.enable()
    tracing.reset()
    try:
        yield
    finally:
        tracing.reset()
        if not was:
            tracing.disable()


@pytest.fixture(params=[True, False], ids=["pipeline-on", "pipeline-off"])
def pipelined(request, monkeypatch):
    """The overlapped pipeline on or off in both engines (the reference
    reads its switch from the environment, the port from a module
    attribute)."""
    monkeypatch.setenv("CSTPU_PIPELINE", "1" if request.param else "0")
    monkeypatch.setattr(pipeline, "ENABLED", request.param)
    return request.param


def test_altair_is_a_fast_fork():
    from consensus_specs_tpu_torch.stf import engine

    assert engine.FAST_FORKS == ("phase0", "altair", "bellatrix")


def test_engine_matches_reference_engine_and_literal(bls_on, pipelined):
    ref_spec, spec, pre, blocks = altair_corpus()
    port_blocks = [to_port(spec.SignedBeaconBlock, b) for b in blocks]
    ref_state = pre.copy()
    engine_state = to_port(spec.BeaconState, pre)
    literal_state = to_port(spec.BeaconState, pre)
    _fresh_engines()
    for i, (ref_block, block) in enumerate(zip(blocks, port_blocks)):
        ref_stf.apply_signed_blocks(ref_spec, ref_state, [ref_block], True)
        stf.apply_signed_blocks(spec, engine_state, [block], True)
        spec.state_transition(literal_state, block, True)
        want = bytes(ref_state.hash_tree_root())
        assert bytes(engine_state.hash_tree_root()) == want, f"block {i}"
        assert bytes(literal_state.hash_tree_root()) == want, f"block {i}"
    _assert_all_fast(len(blocks))
    assert ref_stf.stats["fast_blocks"] == len(blocks)
    assert stf.stats["sync_apply_s"] > 0
    assert stf.stats["mirror_flush_s"] > 0
    assert bytes(engine_state.encode_bytes()) == bytes(ref_state.encode_bytes())

    # the whole walk in one call, from cold caches: with the pipeline on,
    # block N's batch is in flight while block N+1's host phases run
    _fresh_engines()
    whole = to_port(spec.BeaconState, pre)
    stf.apply_signed_blocks(spec, whole, port_blocks, True)
    assert bytes(whole.hash_tree_root()) == bytes(literal_state.hash_tree_root())
    _assert_all_fast(len(blocks))
    assert pipeline.stats["depth_max"] == (3 if pipelined else 0)


def _capture(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # noqa: B001 - parity harness captures anything
        return exc
    return None


def _tamper_signature(ref_spec, sb):
    sb.message.body.sync_aggregate.sync_committee_signature = \
        ref_spec.BLSSignature(b"\x42" * 96)


def _tamper_empty(ref_spec, sb):
    # empty participation must carry the infinity signature
    sb.message.body.sync_aggregate = ref_spec.SyncAggregate(
        sync_committee_bits=[False] * int(ref_spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=ref_spec.BLSSignature(b"\x01" * 96))


@pytest.mark.parametrize("tamper", [_tamper_signature, _tamper_empty],
                         ids=["sync-signature", "empty-sync-set"])
def test_invalid_sync_aggregate_fails_like_the_reference(
        bls_on, pipelined, tamper):
    """Three valid blocks, then one with a bad sync aggregate (in the
    corpus it has every seat but seat 0 set), in one call: both engines
    raise the same exception and leave equal post-states."""
    ref_spec, spec, pre, blocks = altair_corpus()
    bad = blocks[3].copy()
    assert any(bad.message.body.sync_aggregate.sync_committee_bits)
    tamper(ref_spec, bad)
    walk = list(blocks[:3]) + [bad]

    _fresh_engines()
    ref_state = pre.copy()
    ref_exc = _capture(ref_stf.apply_signed_blocks, ref_spec, ref_state,
                       walk, True)
    engine_state = to_port(spec.BeaconState, pre)
    exc = _capture(stf.apply_signed_blocks, spec, engine_state,
                   [to_port(spec.SignedBeaconBlock, b) for b in walk], True)
    assert ref_exc is not None, "the tampered block was accepted"
    assert type(exc) is type(ref_exc), (exc, ref_exc)
    assert str(exc) == str(ref_exc)
    assert bytes(engine_state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    assert stf.stats["fast_blocks"] == ref_stf.stats["fast_blocks"] == 3
    assert stf.stats["replayed_blocks"] == ref_stf.stats["replayed_blocks"] == 1
    assert stf.stats["replay_reasons"] == ref_stf.stats["replay_reasons"] == {
        "FastPathViolation": 1}
    assert stf.stats["breaker_trips"] == 0


def _floor_block(ref_spec, pre):
    """(pre-state, signed block): one validator of the sync committee holds
    a balance of 1 Gwei and every one of its seats is clear in the block's
    sync aggregate.  The spec floors that balance at zero, a valid block;
    the engine's net-delta path cannot prove the walk safe and replays."""
    state = pre.copy()
    rows = ref_sync.sync_committee_rows(ref_spec, state)
    victim = int(rows[0])
    state.balances[victim] = 1
    start = state.copy()
    block = build_empty_block_for_next_slot(ref_spec, state)
    block.body.sync_aggregate = sync_aggregate(
        ref_spec, state, state.slot, lambda seat: int(rows[seat]) != victim)
    signed = state_transition_and_sign_block(ref_spec, state, block)
    assert int(state.balances[victim]) == 0
    return start, signed


def test_sync_penalty_floor_replays_like_the_reference(bls_on, pipelined):
    ref_spec, spec, pre, _ = altair_corpus()
    start, signed = _floor_block(ref_spec, pre)
    _fresh_engines()
    ref_state = start.copy()
    ref_stf.apply_signed_blocks(ref_spec, ref_state, [signed], True)
    port_block = to_port(spec.SignedBeaconBlock, signed)
    engine_state = to_port(spec.BeaconState, start)
    stf.apply_signed_blocks(spec, engine_state, [port_block], True)
    literal = to_port(spec.BeaconState, start)
    spec.state_transition(literal, port_block, True)
    want = bytes(signed.message.state_root)
    assert bytes(ref_state.hash_tree_root()) == want
    assert bytes(engine_state.hash_tree_root()) == want
    assert bytes(literal.hash_tree_root()) == want
    assert stf.stats["fast_blocks"] == ref_stf.stats["fast_blocks"] == 0
    assert stf.stats["replayed_blocks"] == ref_stf.stats["replayed_blocks"] == 1
    assert stf.stats["replay_reasons"] == ref_stf.stats["replay_reasons"] == {
        "FastPathViolation": 1}


def _sync_raise(module, spec, state, bits, reward, proposer_reward):
    rows = module.sync_committee_rows(spec, state)
    try:
        module._apply_rewards(spec, state, rows, bits, reward, proposer_reward)
    except Exception as exc:  # noqa: B001 - parity harness captures anything
        return exc
    return None


@pytest.mark.parametrize("case", ["floor", "overflow", "fine"])
def test_sync_rewards_raise_where_the_reference_raises(case):
    """``_apply_rewards`` on equal states: a clear seat whose balance is
    below the reward (floor), a set seat whose balance would pass 2^64
    (overflow), and a state with neither; the port raises exactly where
    the reference raises, with the same message, and otherwise writes the
    same balances."""
    ref_spec, spec, pre, _ = altair_corpus()
    ref_state = pre.copy()
    rows = ref_sync.sync_committee_rows(ref_spec, ref_state)
    bits = np.arange(len(rows)) % 2 == 0
    reward = 10**6
    if case == "floor":
        ref_state.balances[int(rows[1])] = reward - 1
    elif case == "overflow":
        ref_state.balances[int(rows[0])] = 2**64 - reward
    state = to_port(spec.BeaconState, ref_state)
    attestations.reset_caches()
    ref_attestations.reset_caches()
    ref_exc = _sync_raise(ref_sync, ref_spec, ref_state, bits, reward, 7)
    exc = _sync_raise(sync, spec, state, bits, reward, 7)
    if case == "fine":
        assert ref_exc is None and exc is None
    else:
        assert isinstance(ref_exc, ref_attestations.FastPathViolation)
        assert isinstance(exc, stf.FastPathViolation)
        assert str(exc) == str(ref_exc)
    assert bytes(state.balances.hash_tree_root()) == bytes(
        ref_state.balances.hash_tree_root())


def test_sync_committee_rows_match_the_reference():
    """Seat rows on the minimal corpus's state and on a registry that
    cycles 8,192 keys (so seats resolve to the first of duplicate
    pubkeys), plus the memo: one resolution per committee version."""
    ref_spec, spec, pre, _ = altair_corpus()
    attestations.reset_caches()
    ref_attestations.reset_caches()
    state = to_port(spec.BeaconState, pre)
    got = sync.sync_committee_rows(spec, state)
    assert np.array_equal(got, ref_sync.sync_committee_rows(ref_spec, pre))
    assert sync.sync_committee_rows(spec, state) is got
    attestations.reset_caches()
    assert sync.sync_committee_rows(spec, state) is not got

    spec_m, ref_spec_m, pre_m, _ = mainnet_epoch()
    ref_pre_m = to_port(ref_spec_m.BeaconState, pre_m)
    got = sync.sync_committee_rows(spec_m, pre_m)
    want = ref_sync.sync_committee_rows(ref_spec_m, ref_pre_m)
    assert len(got) == int(spec_m.SYNC_COMMITTEE_SIZE)
    assert np.array_equal(got, want)
    assert int(got.max()) < 8192  # first occurrences of cycled keys


def test_resident_route_forced_on_the_cpu(bls_on, tracing_on, monkeypatch):
    """The minimal corpus through the engine with the resident route
    forced on the CPU and its size gate lowered to the corpus's registry:
    each block's sync rewards leave the balances subtree unhashed at its
    state-root check, so every block takes the resident route (the plain
    reduction, as K2 on the card), and the roots stay the literal path's."""
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    monkeypatch.setattr(merkle_resident, "RESIDENT_MIN", 1)
    ref_spec, spec, pre, blocks = altair_corpus()
    port_blocks = [to_port(spec.SignedBeaconBlock, b) for b in blocks]
    literal = to_port(spec.BeaconState, pre)
    for block in port_blocks:
        spec.state_transition(literal, block, True)
    _fresh_engines()
    state = to_port(spec.BeaconState, pre)
    state.hash_tree_root()  # the decoded pre-state's balances hashed
    stf.apply_signed_blocks(spec, state, port_blocks, True)
    _assert_all_fast(len(blocks))
    assert tracing.report()["counters"].get("stf.resident_slot_root") == len(blocks)
    assert bytes(state.hash_tree_root()) == bytes(literal.hash_tree_root())


def test_mainnet_altair_epoch_at_16384_through_the_engine(
        bls_on, pipelined, tracing_on):
    """The main path's altair epoch at 16,384 validators in one engine
    call: every block fast (so every block's state root, checked by the
    engine, equals the one its builder signed, which the reference's
    literal replay reproduces in tests/test_torch_spec_altair.py).  The
    sync rewards leave the balances subtree unhashed at each block's
    check; a CPU spec hashes it on the host (the reference's policy), so
    no check takes the resident route, which K2 takes on the card."""
    spec, _, pre, blocks = mainnet_epoch()
    _fresh_engines()
    state = pre.copy()
    stf.apply_signed_blocks(spec, state, blocks, True)
    _assert_all_fast(len(blocks))
    counters = tracing.report()["counters"]
    assert counters.get("stf.resident_slot_root") is None
    assert counters.get("stf.sync_aggregate") == len(blocks)
    assert bytes(state.hash_tree_root()) == bytes(blocks[-1].message.state_root)


@pytest.mark.slow
def test_altair_main_path_at_400k_through_the_engine(bls_on):
    """The altair main path on the CPU: 32 signed blocks with sync
    aggregates at 400,000 validators through the engine in one call, root
    equal to the literal path's."""
    spec = get_spec("altair", "mainnet", device="cpu")
    state = scenario.build_main_path_state(spec, 400_000)
    blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
    literal = state.copy()
    for signed in blocks:
        spec.state_transition(literal, signed, True)
    _fresh_engines()
    engine_state = state.copy()
    stf.apply_signed_blocks(spec, engine_state, blocks, True)
    _assert_all_fast(len(blocks))
    assert bytes(engine_state.hash_tree_root()) == bytes(literal.hash_tree_root())
