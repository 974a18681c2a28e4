"""The torch port's block engine on bellatrix, against the reference
engine and the port's literal ``spec.state_transition``, with BLS on.

Bellatrix rides the altair fast path; the engine runs the block's
execution payload literally (``process_execution_payload``) inside the
block's snapshot region, so an invalid payload raises into the replay
contract exactly as in the reference.  Every engine run also holds the
engine's counters (every valid block fast, none replayed).

* minimal preset: the corpus of tests/test_torch_spec_bellatrix.py
  (pre-merge blocks, the merge-transition block, a post-merge payload
  chain, two epoch transitions), roots equal to the reference engine's
  and the literal spec's after every block, pipeline on and off, then the
  whole walk in one call;
* a payload with a wrong ``parent_hash``, ``prev_randao`` or
  ``timestamp`` replays and raises exactly as in the reference engine;
* a failing reduction on a bellatrix block raises ``KernelError`` with
  the pre-state restored and nothing replayed;
* mainnet preset at 16,384 validators: the main path's bellatrix epoch
  through the engine in one call;
* the 400,000-validator bellatrix epoch through the engine (``slow``).
"""
import pytest

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.testing.helpers.block import build_empty_block_for_next_slot
from consensus_specs_tpu.testing.helpers.state import state_transition_and_sign_block
from consensus_specs_tpu_torch import scenario, stf, tracing
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.ops.sha256 import KernelError
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.stf import pipeline

from .test_torch_spec_bellatrix import (
    MERGE_AT,
    bellatrix_corpus,
    bls_on,
    mainnet_epoch,
    to_port,
)
from .test_torch_stf_engine_altair import (
    _assert_all_fast,
    _capture,
    _fresh_engines,
    pipelined,
    tracing_on,
)

__all__ = ["bls_on", "pipelined", "tracing_on"]  # fixtures, shared


def test_engine_matches_reference_engine_and_literal(bls_on, pipelined):
    ref_spec, spec, pre, blocks = bellatrix_corpus()
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
        assert spec.is_merge_transition_complete(engine_state) == (i >= MERGE_AT)
    _assert_all_fast(len(blocks))
    assert ref_stf.stats["fast_blocks"] == len(blocks)
    assert stf.stats["execution_payload_s"] > 0
    assert bytes(engine_state.encode_bytes()) == bytes(ref_state.encode_bytes())

    # the whole walk in one call, from cold caches
    _fresh_engines()
    whole = to_port(spec.BeaconState, pre)
    stf.apply_signed_blocks(spec, whole, port_blocks, True)
    assert bytes(whole.hash_tree_root()) == bytes(literal_state.hash_tree_root())
    _assert_all_fast(len(blocks))
    assert pipeline.stats["depth_max"] == (3 if pipelined else 0)


def _wrong_parent_hash(ref_spec, payload):
    payload.parent_hash = ref_spec.Hash32(b"\x13" * 32)


def _wrong_prev_randao(ref_spec, payload):
    payload.prev_randao = ref_spec.Bytes32(b"\x14" * 32)


def _wrong_timestamp(ref_spec, payload):
    payload.timestamp = payload.timestamp + 1


@pytest.mark.parametrize("tamper", [
    _wrong_parent_hash, _wrong_prev_randao, _wrong_timestamp],
    ids=["parent_hash", "prev_randao", "timestamp"])
def test_invalid_payload_fails_like_the_reference(bls_on, pipelined, tamper):
    """Three valid post-merge blocks, then a signed block whose payload
    breaks one of ``process_execution_payload``'s checks, in one call:
    both engines replay it, raise the same exception and leave equal
    poisoned post-states."""
    ref_spec, spec, pre, blocks = bellatrix_corpus()
    start = MERGE_AT + 1
    walk_pre = pre.copy()
    was = ref_bls.bls_active, ref_bls.backend_name()
    ref_bls.use_native()
    ref_bls.bls_active = True
    try:
        for signed in blocks[:start]:
            ref_spec.state_transition(walk_pre, signed, True)
        state = walk_pre.copy()
        for signed in blocks[start:start + 3]:
            ref_spec.state_transition(state, signed, True)
        block = build_empty_block_for_next_slot(ref_spec, state)
        tamper(ref_spec, block.body.execution_payload)
        bad = state_transition_and_sign_block(
            ref_spec, state.copy(), block, expect_fail=True)
    finally:
        ref_bls.bls_active = was[0]
        ref_bls.use_backend(was[1])
    walk = list(blocks[start:start + 3]) + [bad]

    _fresh_engines()
    ref_state = walk_pre.copy()
    ref_exc = _capture(ref_stf.apply_signed_blocks, ref_spec, ref_state,
                       walk, True)
    engine_state = to_port(spec.BeaconState, walk_pre)
    exc = _capture(stf.apply_signed_blocks, spec, engine_state,
                   [to_port(spec.SignedBeaconBlock, b) for b in walk], True)
    assert isinstance(ref_exc, AssertionError), ref_exc
    assert type(exc) is type(ref_exc), (exc, ref_exc)
    assert str(exc) == str(ref_exc)
    assert bytes(engine_state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    assert stf.stats["fast_blocks"] == ref_stf.stats["fast_blocks"] == 3
    assert stf.stats["replayed_blocks"] == ref_stf.stats["replayed_blocks"] == 1
    assert stf.stats["replay_reasons"] == ref_stf.stats["replay_reasons"] == {
        "AssertionError": 1}
    assert stf.stats["breaker_trips"] == 0


def test_failing_reduction_raises_on_bellatrix(bls_on, monkeypatch):
    """The resident route forced on the CPU (size gate lowered to the
    corpus's registry) with a reduction that fails: the engine raises the
    kernel's error on a bellatrix block with its pre-state restored, and
    replays nothing on the host path."""
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    monkeypatch.setattr(merkle_resident, "RESIDENT_MIN", 1)

    def broken(values):
        raise KernelError("K2 launch failed")

    monkeypatch.setattr(merkle_resident, "packed_u64_root", broken)
    _, spec, pre, blocks = bellatrix_corpus()
    state = to_port(spec.BeaconState, pre)
    before = bytes(state.encode_bytes())
    _fresh_engines()
    with pytest.raises(KernelError, match="K2 launch failed"):
        stf.apply_signed_blocks(
            spec, state, [to_port(spec.SignedBeaconBlock, blocks[0])], True)
    assert stf.stats["fast_blocks"] == 0
    assert stf.stats["replayed_blocks"] == 0, stf.stats["replay_reasons"]
    assert stf.stats["breaker_trips"] == 0
    assert bytes(state.encode_bytes()) == before


def test_mainnet_bellatrix_epoch_at_16384_through_the_engine(bls_on, tracing_on):
    """The main path's bellatrix epoch at 16,384 validators in one engine
    call: every block fast, each with its sync aggregate and its execution
    payload, and the last root the one its builder signed.  A CPU spec
    hashes the balances on the host (no resident root)."""
    spec, _, pre, blocks = mainnet_epoch()
    assert all(len(b.message.body.execution_payload.transactions)
               == scenario.TXS_PER_PAYLOAD for b in blocks)
    _fresh_engines()
    state = pre.copy()
    stf.apply_signed_blocks(spec, state, blocks, True)
    _assert_all_fast(len(blocks))
    counters = tracing.report()["counters"]
    assert counters.get("stf.sync_aggregate") == len(blocks)
    assert counters.get("stf.resident_slot_root") is None
    assert bytes(state.hash_tree_root()) == bytes(blocks[-1].message.state_root)
    assert state.latest_execution_payload_header.block_hash == \
        blocks[-1].message.body.execution_payload.block_hash


@pytest.mark.slow
def test_bellatrix_main_path_at_400k_through_the_engine(bls_on):
    """The bellatrix main path on the CPU: 32 signed blocks with sync
    aggregates and execution payloads at 400,000 validators through the
    engine in one call, root equal to the literal path's."""
    spec = get_spec("bellatrix", "mainnet", device="cpu")
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
