"""The torch port's altair spec against the reference spec, with BLS on.

States and blocks cross between the two SSZ type systems serialized
(``encode_bytes`` / ``decode_bytes``); post-state roots must be equal.

* minimal preset: an altair genesis state and signed blocks carrying
  attestations and sync aggregates (full, partial and empty
  participation) across two epoch transitions, built with the
  reference's testing helpers, replayed through the port's spec built
  for the CPU;
* mainnet preset at 16,384 validators: one altair epoch of the main
  path's shape (the port's ``scenario``: real pubkeys, real sync
  committees, 32 blocks each with the two preceding slots' aggregates and
  a full sync aggregate), the reference's root after every block, through
  the literal spec here and through the engine in
  tests/test_torch_stf_engine_altair.py;
* the whole 400,000-validator altair epoch (``slow``).
"""
import pytest

import bench
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
from consensus_specs_tpu.testing.helpers.sync_committee import (
    compute_aggregate_sync_committee_signature,
    compute_committee_indices,
)
from consensus_specs_tpu_torch import scenario
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.specs import get_spec

_CORPUS = {}
_MAINNET = {}

# sync participation by block: full, every other seat, none, all but seat 0
SYNC_PATTERNS = (
    lambda seat: True,
    lambda seat: seat % 2 == 0,
    lambda seat: False,
    lambda seat: seat != 0,
)


@pytest.fixture
def bls_on():
    """Native BLS with verification on in both packages, restored after."""
    saved = (ref_bls.bls_active, ref_bls.backend_name(),
             bls.bls_active, bls.backend_name())
    ref_bls.use_native()
    bls.use_native()
    ref_bls.bls_active = True
    bls.bls_active = True
    try:
        yield
    finally:
        ref_bls.bls_active, bls.bls_active = saved[0], saved[2]
        ref_bls.use_backend(saved[1])
        bls.use_backend(saved[3])


def to_port(port_type, ref_obj):
    return port_type.decode_bytes(bytes(ref_obj.encode_bytes()))


def sync_aggregate(ref_spec, state, slot, participation):
    """A sync aggregate of the current committee signed over the block
    root of ``slot`` (the block before the one carrying it)."""
    committee = compute_committee_indices(ref_spec, state)
    bits = [participation(seat) for seat in range(len(committee))]
    participants = [v for seat, v in enumerate(committee) if bits[seat]]
    return ref_spec.SyncAggregate(
        sync_committee_bits=bits,
        sync_committee_signature=compute_aggregate_sync_committee_signature(
            ref_spec, state, slot, participants))


def altair_corpus():
    """(reference spec, port spec, reference pre-state, reference signed
    blocks): from an epoch-aligned minimal altair state, 2 epochs + 1
    blocks, so that two epoch transitions run; each block carries one
    aggregate a committee of the slot before it and a sync aggregate of
    the participation ``SYNC_PATTERNS`` gives it."""
    if not _CORPUS:
        was = ref_bls.bls_active, ref_bls.backend_name()
        ref_bls.use_native()
        ref_bls.bls_active = True
        try:
            ref_spec = ref_get_spec("altair", "minimal")
            state = create_genesis_state(
                ref_spec, default_balances(ref_spec),
                default_activation_threshold(ref_spec))
            next_epoch(ref_spec, state)
            pre = state.copy()
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
                blocks.append(
                    state_transition_and_sign_block(ref_spec, state, block))
        finally:
            ref_bls.bls_active = was[0]
            ref_bls.use_backend(was[1])
        assert sum(len(b.message.body.attestations) for b in blocks) > 0
        _CORPUS.update(ref_spec=ref_spec, pre=pre, blocks=blocks,
                       spec=get_spec("altair", "minimal", device="cpu"))
    c = _CORPUS
    return c["ref_spec"], c["spec"], c["pre"], c["blocks"]


def mainnet_epoch():
    """(port spec, reference spec, pre-state, signed blocks): the main
    path's altair epoch at 16,384 validators on the mainnet preset, built
    by the port's ``scenario`` with the native BLS backend."""
    if not _MAINNET:
        was = bls.bls_active, bls.backend_name()
        bls.use_native()
        try:
            spec = get_spec("altair", "mainnet", device="cpu")
            state = scenario.build_main_path_state(
                spec, merkle_resident.RESIDENT_MIN)
            blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
        finally:
            bls.bls_active = was[0]
            bls.use_backend(was[1])
        _MAINNET.update(spec=spec, ref_spec=ref_get_spec("altair", "mainnet"),
                        pre=state, blocks=blocks)
    m = _MAINNET
    return m["spec"], m["ref_spec"], m["pre"], m["blocks"]


def test_fork_ladder_builds_altair_over_phase0():
    spec = get_spec("altair", "minimal", device="cpu")
    assert spec.fork == "altair"
    assert spec.phase0 is get_spec("phase0", "minimal", device="cpu")
    assert spec.__name__ == "consensus_specs_tpu_torch.specs.altair_minimal_cpu"
    # the altair installs are in place
    for name in ("process_attestation", "process_sync_aggregate",
                 "process_rewards_and_penalties", "process_inactivity_updates",
                 "process_participation_flag_updates",
                 "process_justification_and_finalization"):
        assert hasattr(getattr(spec, name), "__wrapped__"), name


def test_minimal_altair_blocks_across_two_epoch_transitions(bls_on):
    ref_spec, spec, pre, blocks = altair_corpus()
    state = to_port(spec.BeaconState, pre)
    assert state.hash_tree_root() == pre.hash_tree_root()
    ref_state = pre.copy()
    for i, signed in enumerate(blocks):
        spec.state_transition(state, to_port(spec.SignedBeaconBlock, signed), True)
        ref_spec.state_transition(ref_state, signed, True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
        assert bytes(state.hash_tree_root()) == bytes(signed.message.state_root)
    # two epoch transitions ran: the participation rotated twice
    assert int(spec.get_current_epoch(state)) == int(
        spec.get_current_epoch(to_port(spec.BeaconState, pre))) + 2
    assert bytes(state.encode_bytes()) == bytes(ref_state.encode_bytes())


def test_scenario_builds_the_references_altair_state():
    """The port's altair ``build_state`` gives the reference bench's bytes
    (zeroed participation and inactivity columns sized to the registry)."""
    n = 1000
    spec = get_spec("altair", "mainnet", device="cpu")
    ref_spec = ref_get_spec("altair", "mainnet")
    port_state = scenario.build_state(spec, n)
    ref_state = bench.build_state(ref_spec, n)
    assert bytes(port_state.encode_bytes()) == bytes(ref_state.encode_bytes())
    assert len(port_state.previous_epoch_participation) == n
    assert len(port_state.inactivity_scores) == n


def test_mainnet_altair_epoch_at_16384_matches_reference(bls_on):
    """The main path's altair epoch at 16,384 validators: the reference's
    root after every block, through the port's literal spec."""
    spec, ref_spec, pre, blocks = mainnet_epoch()
    assert len(blocks) == int(spec.SLOTS_PER_EPOCH)
    assert all(sum(b.message.body.sync_aggregate.sync_committee_bits)
               == int(spec.SYNC_COMMITTEE_SIZE) for b in blocks)
    state = pre.copy()
    ref_state = to_port(ref_spec.BeaconState, pre)
    for i, signed in enumerate(blocks):
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
    # the last block crossed the epoch boundary
    assert int(spec.get_current_epoch(state)) == int(
        spec.get_current_epoch(pre)) + 1


@pytest.mark.slow
def test_altair_main_path_at_400k_matches_reference(bls_on):
    """The altair main path on the CPU: 32 signed blocks at 400,000
    validators with sync aggregates, port vs reference, equal roots after
    every block."""
    spec = get_spec("altair", "mainnet", device="cpu")
    ref_spec = ref_get_spec("altair", "mainnet")
    state = scenario.build_main_path_state(spec, 400_000)
    blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
    ref_state = to_port(ref_spec.BeaconState, state)
    for signed in blocks:
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
