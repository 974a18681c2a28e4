"""The torch port's bellatrix spec against the reference spec, with BLS on.

States and blocks cross between the two SSZ type systems serialized
(``encode_bytes`` / ``decode_bytes``); post-state roots must be equal.

* the fork ladder: bellatrix over altair, with the altair-lineage
  installs;
* minimal preset: a bellatrix genesis state reset to before the merge,
  then signed blocks across two epoch transitions, built with the
  reference's testing helpers: pre-merge blocks with empty payloads, the
  merge-transition block, and a post-merge chain of payloads (from
  ``testing/helpers/execution_payload.py``, with random transactions),
  each block with attestations and a full, partial or empty sync
  aggregate; the reference's root after every block;
* ``upgrade_to_bellatrix`` of an altair state;
* the port's ``scenario`` on bellatrix: a post-merge state and payloads
  that chain, at the minimal preset, replayed through the reference;
* mainnet preset at 16,384 validators: the main path's bellatrix epoch
  (32 blocks, each with the two preceding slots' aggregates, a full sync
  aggregate and a ~90 KB execution payload) through the literal spec, the
  reference's root after every block (``slow``: it costs more than its
  altair counterpart; the engine runs the same epoch in tier-1, in
  tests/test_torch_stf_engine_bellatrix.py);
* the whole 400,000-validator bellatrix epoch (``slow``).
"""
import numpy as np
import pytest

from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.attestations import get_valid_attestation
from consensus_specs_tpu.testing.helpers.block import build_empty_block_for_next_slot
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu.testing.helpers.state import (
    next_epoch,
    state_transition_and_sign_block,
)
from consensus_specs_tpu_torch import scenario
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.specs import get_spec

from .test_torch_spec_altair import SYNC_PATTERNS, bls_on, sync_aggregate, to_port

__all__ = ["bls_on"]  # the fixture, shared with the altair tests

_CORPUS = {}
_MAINNET = {}

# the index of the merge-transition block in the minimal walk: the blocks
# before it carry the default (empty) payload
MERGE_AT = 5


def random_transactions(rng, count: int) -> list:
    """``count`` transactions of 1 to 300 random bytes."""
    return [rng.integers(0, 256, int(rng.integers(1, 301)), dtype=np.uint8)
            .tobytes() for _ in range(count)]


def bellatrix_corpus():
    """(reference spec, port spec, reference pre-state, reference signed
    blocks): from an epoch-aligned minimal bellatrix state before the
    merge, 2 epochs + 1 blocks, so that two epoch transitions run.  Blocks
    before ``MERGE_AT`` carry the empty payload, block ``MERGE_AT`` is the
    merge-transition block and every later one extends the payload chain
    with a few random transactions; each block carries one aggregate a
    committee of the slot before it and a sync aggregate of the
    participation ``SYNC_PATTERNS`` gives it."""
    if not _CORPUS:
        was = ref_bls.bls_active, ref_bls.backend_name()
        ref_bls.use_native()
        ref_bls.bls_active = True
        try:
            ref_spec = ref_get_spec("bellatrix", "minimal")
            state = create_genesis_state(
                ref_spec, default_balances(ref_spec),
                default_activation_threshold(ref_spec))
            state.latest_execution_payload_header = ref_spec.ExecutionPayloadHeader()
            next_epoch(ref_spec, state)
            pre = state.copy()
            rng = np.random.default_rng(6)
            blocks = []
            for i in range(2 * int(ref_spec.SLOTS_PER_EPOCH) + 1):
                block = build_empty_block_for_next_slot(ref_spec, state)
                n_committees = ref_spec.get_committee_count_per_slot(
                    state, ref_spec.get_current_epoch(state))
                for index in range(n_committees):
                    block.body.attestations.append(get_valid_attestation(
                        ref_spec, state, state.slot, index=index, signed=True))
                block.body.sync_aggregate = sync_aggregate(
                    ref_spec, state, state.slot,
                    SYNC_PATTERNS[i % len(SYNC_PATTERNS)])
                if i < MERGE_AT:
                    block.body.execution_payload = ref_spec.ExecutionPayload()
                else:
                    # the helper's payload: the state's header extended
                    # (from zero at the merge) at the block's slot
                    block.body.execution_payload.transactions = \
                        random_transactions(rng, i % 4)
                assert ref_spec.is_merge_transition_block(
                    state, block.body) == (i == MERGE_AT)
                blocks.append(
                    state_transition_and_sign_block(ref_spec, state, block))
                assert ref_spec.is_merge_transition_complete(state) == (i >= MERGE_AT)
        finally:
            ref_bls.bls_active = was[0]
            ref_bls.use_backend(was[1])
        _CORPUS.update(ref_spec=ref_spec, pre=pre, blocks=blocks,
                       spec=get_spec("bellatrix", "minimal", device="cpu"))
    c = _CORPUS
    return c["ref_spec"], c["spec"], c["pre"], c["blocks"]


def mainnet_epoch():
    """(port spec, reference spec, pre-state, signed blocks): the main
    path's bellatrix epoch at 16,384 validators on the mainnet preset,
    built by the port's ``scenario`` with the native BLS backend."""
    if not _MAINNET:
        was = bls.bls_active, bls.backend_name()
        bls.use_native()
        try:
            spec = get_spec("bellatrix", "mainnet", device="cpu")
            state = scenario.build_main_path_state(
                spec, merkle_resident.RESIDENT_MIN)
            blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
        finally:
            bls.bls_active = was[0]
            bls.use_backend(was[1])
        _MAINNET.update(spec=spec, ref_spec=ref_get_spec("bellatrix", "mainnet"),
                        pre=state, blocks=blocks)
    m = _MAINNET
    return m["spec"], m["ref_spec"], m["pre"], m["blocks"]


def test_fork_ladder_builds_bellatrix_over_altair():
    from consensus_specs_tpu_torch.specs import builder

    spec = get_spec("bellatrix", "minimal", device="cpu")
    assert spec.fork == "bellatrix"
    assert spec.altair is get_spec("altair", "minimal", device="cpu")
    assert spec.__name__ == "consensus_specs_tpu_torch.specs.bellatrix_minimal_cpu"
    assert builder.FORK_PARENTS["bellatrix"] == "altair"
    assert builder.FORK_ORDER[:3] == ("phase0", "altair", "bellatrix")
    # the altair-lineage installs are in place
    for name in ("process_attestation", "process_sync_aggregate",
                 "process_rewards_and_penalties", "process_inactivity_updates",
                 "process_participation_flag_updates",
                 "process_justification_and_finalization", "process_slashings"):
        assert hasattr(getattr(spec, name), "__wrapped__"), name
    assert type(spec.EXECUTION_ENGINE).__name__ == "NoopExecutionEngine"


def test_minimal_bellatrix_blocks_through_the_merge(bls_on):
    ref_spec, spec, pre, blocks = bellatrix_corpus()
    state = to_port(spec.BeaconState, pre)
    assert state.hash_tree_root() == pre.hash_tree_root()
    assert not spec.is_merge_transition_complete(state)
    ref_state = pre.copy()
    for i, signed in enumerate(blocks):
        spec.state_transition(state, to_port(spec.SignedBeaconBlock, signed), True)
        ref_spec.state_transition(ref_state, signed, True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
        assert bytes(state.hash_tree_root()) == bytes(signed.message.state_root)
        assert spec.is_merge_transition_complete(state) == (i >= MERGE_AT)
    assert int(spec.get_current_epoch(state)) == int(
        spec.get_current_epoch(to_port(spec.BeaconState, pre))) + 2
    assert int(state.latest_execution_payload_header.block_number) == len(
        blocks) - MERGE_AT
    assert bytes(state.encode_bytes()) == bytes(ref_state.encode_bytes())


def test_upgrade_to_bellatrix_matches_reference():
    ref_altair = ref_get_spec("altair", "minimal")
    ref_spec = ref_get_spec("bellatrix", "minimal")
    spec = get_spec("bellatrix", "minimal", device="cpu")
    pre = create_genesis_state(ref_altair, default_balances(ref_altair),
                               default_activation_threshold(ref_altair))
    next_epoch(ref_altair, pre)
    want = ref_spec.upgrade_to_bellatrix(pre.copy())
    got = spec.upgrade_to_bellatrix(to_port(spec.altair.BeaconState, pre))
    assert bytes(got.hash_tree_root()) == bytes(want.hash_tree_root())
    assert bytes(got.fork.current_version) == bytes(spec.config.BELLATRIX_FORK_VERSION)
    assert got.latest_execution_payload_header == spec.ExecutionPayloadHeader()


def test_scenario_payloads_chain_and_match_reference(bls_on):
    """The port's ``scenario`` on bellatrix at the minimal preset: the
    state is past the merge, every payload extends the one before (parent
    hash, block number), carries the RANDAO mix before its block's reveal
    and the slot's timestamp, and holds ``TXS_PER_PAYLOAD`` transactions
    in ``TX_BYTES``; the reference's literal spec gives the same roots."""
    spec = get_spec("bellatrix", "minimal", device="cpu")
    ref_spec = ref_get_spec("bellatrix", "minimal")
    state = scenario.build_main_path_state(spec, 256)
    assert spec.is_merge_transition_complete(state)
    blocks = scenario.build_epoch_blocks(spec, state, with_sync=True, seed=3)
    again = scenario.build_epoch_blocks(spec, state, with_sync=True, seed=3)
    assert [bytes(b.encode_bytes()) for b in blocks] == [
        bytes(b.encode_bytes()) for b in again]

    ref_state = to_port(ref_spec.BeaconState, state)
    post = state.copy()
    for i, signed in enumerate(blocks):
        payload = signed.message.body.execution_payload
        head = post.latest_execution_payload_header
        stub = post.copy()
        spec.process_slots(stub, signed.message.slot)
        assert payload.parent_hash == head.block_hash
        assert payload.block_number == head.block_number + 1
        assert payload.prev_randao == spec.get_randao_mix(
            stub, spec.get_current_epoch(stub))
        assert payload.timestamp == spec.compute_timestamp_at_slot(
            stub, signed.message.slot)
        assert len(payload.transactions) == scenario.TXS_PER_PAYLOAD
        sizes = [len(tx) for tx in payload.transactions]
        assert scenario.TX_BYTES[0] <= min(sizes)
        assert max(sizes) <= scenario.TX_BYTES[1]
        spec.state_transition(post, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(post.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
    assert post.latest_execution_payload_header.block_hash == \
        blocks[-1].message.body.execution_payload.block_hash


@pytest.mark.slow
def test_mainnet_bellatrix_epoch_at_16384_matches_reference(bls_on):
    """The main path's bellatrix epoch at 16,384 validators: the
    reference's root after every block, through the port's literal spec."""
    spec, ref_spec, pre, blocks = mainnet_epoch()
    assert len(blocks) == int(spec.SLOTS_PER_EPOCH)
    payload_bytes = [sum(len(tx) for tx in b.message.body.execution_payload.transactions)
                     for b in blocks]
    assert 60_000 < np.mean(payload_bytes) < 120_000
    state = pre.copy()
    ref_state = to_port(ref_spec.BeaconState, pre)
    for i, signed in enumerate(blocks):
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
    assert int(spec.get_current_epoch(state)) == int(
        spec.get_current_epoch(pre)) + 1


@pytest.mark.slow
def test_bellatrix_main_path_at_400k_matches_reference(bls_on):
    """The bellatrix main path on the CPU: 32 signed blocks at 400,000
    validators with sync aggregates and execution payloads, port vs
    reference, equal roots after every block."""
    spec = get_spec("bellatrix", "mainnet", device="cpu")
    ref_spec = ref_get_spec("bellatrix", "mainnet")
    state = scenario.build_main_path_state(spec, 400_000)
    blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
    ref_state = to_port(ref_spec.BeaconState, state)
    for signed in blocks:
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
