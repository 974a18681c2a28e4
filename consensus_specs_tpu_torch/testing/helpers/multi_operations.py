"""Blocks stuffed with many simultaneous operations (reference capability:
test/helpers/multi_operations.py): the strongest single-block integration
probe — slashings, attestations, deposits and exits all applied in one
state transition.
"""
from __future__ import annotations

from .attestations import get_valid_attestation
from .attester_slashings import get_valid_attester_slashing_by_indices
from .block import build_empty_block_for_next_slot
from .deposits import prepare_state_and_deposit
from .proposer_slashings import get_valid_proposer_slashing
from .state import next_slots, state_transition_and_sign_block
from .voluntary_exits import prepare_signed_exits


def get_random_proposer_slashings(spec, state, rng, num_slashings=1):
    """Slashings against distinct currently-slashable validators."""
    active = list(spec.get_active_validator_indices(
        state, spec.get_current_epoch(state)))
    indices = [
        i for i in active if not state.validators[i].slashed
    ]
    slashings = []
    for _ in range(num_slashings):
        if not indices:
            break
        index = indices.pop(rng.randrange(len(indices)))
        slashings.append(get_valid_proposer_slashing(
            spec, state, slashed_index=index, signed_1=True, signed_2=True))
    return slashings


def get_random_attester_slashings(spec, state, rng, slashed_indices=()):
    """One attester slashing over a few not-yet-slashed committee members."""
    attestation = get_valid_attestation(spec, state)
    committee = list(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits))
    candidates = sorted(
        i for i in committee
        if not state.validators[i].slashed and i not in slashed_indices
    )[:3]
    if not candidates:
        return []
    return [get_valid_attester_slashing_by_indices(
        spec, state, candidates, signed_1=True, signed_2=True)]


def get_random_attestations(spec, state, rng, num_attestations=2):
    atts = []
    for _ in range(num_attestations):
        slot = state.slot - rng.randrange(
            int(spec.MIN_ATTESTATION_INCLUSION_DELAY),
            int(spec.SLOTS_PER_EPOCH),
        )
        if slot < 0:
            continue
        index = rng.randrange(
            int(spec.get_committee_count_per_slot(
                state, spec.compute_epoch_at_slot(slot)))
        )
        atts.append(get_valid_attestation(
            spec, state, slot=slot, index=index, signed=True))
    return atts


def run_test_full_random_operations(spec, state, rng):
    """Build + sign one block carrying every operation family, run the
    full state transition, and yield the standard sanity-block parts."""
    # age the state so attestations and exits are admissible
    next_slots(spec, state, int(spec.SLOTS_PER_EPOCH) + 1)
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH

    block = build_empty_block_for_next_slot(spec, state)

    proposer_slashings = get_random_proposer_slashings(spec, state, rng)
    slashed = {
        ps.signed_header_1.message.proposer_index for ps in proposer_slashings
    }
    attester_slashings = get_random_attester_slashings(spec, state, rng, slashed)
    for ps in proposer_slashings:
        block.body.proposer_slashings.append(ps)
    for a_s in attester_slashings:
        block.body.attester_slashings.append(a_s)
    for att in get_random_attestations(spec, state, rng):
        block.body.attestations.append(att)

    # a fresh deposit for a brand-new validator
    deposit = prepare_state_and_deposit(
        spec, state, len(state.validators), spec.MAX_EFFECTIVE_BALANCE,
        signed=True,
    )
    block.body.deposits.append(deposit)

    # one voluntary exit from a validator not otherwise touched
    exit_candidates = [
        i for i in spec.get_active_validator_indices(
            state, spec.get_current_epoch(state))
        if not state.validators[i].slashed
        and i not in slashed
        and not any(
            i in a_s.attestation_1.attesting_indices
            for a_s in attester_slashings
        )
    ]
    block.body.voluntary_exits.append(
        prepare_signed_exits(spec, state, [exit_candidates[-1]])[0]
    )

    yield "pre", state
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield "blocks", [signed_block]
    yield "post", state

    assert len(state.validators) > len(slashed)
    for index in slashed:
        assert state.validators[index].slashed
