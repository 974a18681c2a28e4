"""Sync-committee signing, reward accounting, and processing runners.

Parity surface: reference ``eth2spec/test/helpers/sync_committee.py``.
Reward validation is computed as a whole expected-delta table first and
asserted once per validator, instead of branch-per-validator arithmetic.
"""
from __future__ import annotations

from collections import Counter

from consensus_specs_tpu_torch.crypto import bls

from ..context import expect_assertion_error
from .block import build_empty_block_for_next_slot
from .block_processing import run_block_processing_to
from .keys import privkeys


def _sync_signing_root(spec, state, slot, block_root, domain_type):
    domain = spec.get_domain(
        state, domain_type or spec.DOMAIN_SYNC_COMMITTEE,
        spec.compute_epoch_at_slot(slot))
    if block_root is None:
        # Attesting the current head: its root is only recoverable via the
        # parent root a next-slot block would reference.
        if slot == state.slot:
            block_root = build_empty_block_for_next_slot(spec, state).parent_root
        else:
            block_root = spec.get_block_root_at_slot(state, slot)
    return spec.compute_signing_root(block_root, domain)


def compute_sync_committee_signature(spec, state, slot, privkey, block_root=None,
                                     domain_type=None):
    return bls.Sign(privkey, _sync_signing_root(spec, state, slot, block_root, domain_type))


def compute_aggregate_sync_committee_signature(spec, state, slot, participants,
                                               block_root=None, domain_type=None):
    if not participants:
        return spec.G2_POINT_AT_INFINITY
    # One message, many keys: hoist the signing root out of the loop.
    root = _sync_signing_root(spec, state, slot, block_root, domain_type)
    return bls.Aggregate([bls.Sign(privkeys[i], root) for i in participants])


def compute_sync_committee_inclusion_reward(spec, state):
    active_increments = spec.get_total_active_balance(state) // spec.EFFECTIVE_BALANCE_INCREMENT
    per_slot_pool = (spec.get_base_reward_per_increment(state) * active_increments
                     * spec.SYNC_REWARD_WEIGHT // spec.WEIGHT_DENOMINATOR
                     // spec.SLOTS_PER_EPOCH)
    return per_slot_pool // spec.SYNC_COMMITTEE_SIZE


def compute_sync_committee_participant_reward_and_penalty(
        spec, state, participant_index, committee_indices, committee_bits):
    unit = compute_sync_committee_inclusion_reward(spec, state)
    # A validator can occupy several committee seats; count multiplicity of
    # participating vs absent seats separately.
    seats = Counter()
    for index, bit in zip(committee_indices, committee_bits):
        seats[(index, bool(bit))] += 1
    return (
        spec.Gwei(unit * seats[(participant_index, True)]),
        spec.Gwei(unit * seats[(participant_index, False)]),
    )


def compute_sync_committee_proposer_reward(spec, state, committee_indices, committee_bits):
    unit = compute_sync_committee_inclusion_reward(spec, state)
    per_participant = unit * spec.PROPOSER_WEIGHT // (spec.WEIGHT_DENOMINATOR - spec.PROPOSER_WEIGHT)
    return spec.Gwei(per_participant * sum(1 for b in committee_bits if b))


def compute_committee_indices(spec, state, committee=None):
    """Validator indices behind the committee's pubkeys."""
    if committee is None:
        committee = state.current_sync_committee
    index_of = {}
    for i, v in enumerate(state.validators):
        index_of.setdefault(bytes(v.pubkey), i)  # first seat wins on duplicates
    return [index_of[bytes(pk)] for pk in committee.pubkeys]


def validate_sync_committee_rewards(spec, pre_state, post_state, committee_indices,
                                    committee_bits, proposer_index):
    expected = {}
    for index in set(committee_indices):
        reward, penalty = compute_sync_committee_participant_reward_and_penalty(
            spec, pre_state, index, committee_indices, committee_bits)
        expected[index] = int(reward) - int(penalty)
    expected[proposer_index] = expected.get(proposer_index, 0) + int(
        compute_sync_committee_proposer_reward(
            spec, pre_state, committee_indices, committee_bits))

    for index in range(len(post_state.validators)):
        delta = expected.get(index, 0)
        assert int(post_state.balances[index]) == int(pre_state.balances[index]) + delta


def run_sync_committee_processing(spec, state, block, expect_exception=False):
    """Run block processing up to the sync-aggregate step, then that step in
    isolation, yielding pre/sync_aggregate/post."""
    pre_state = state.copy()
    target = run_block_processing_to(spec, state, block, "process_sync_aggregate")
    yield "pre", state
    yield "sync_aggregate", block.body.sync_aggregate
    if expect_exception:
        expect_assertion_error(lambda: target(state, block))
        yield "post", None
        assert pre_state.balances == state.balances
        return
    target(state, block)
    yield "post", state
    validate_sync_committee_rewards(
        spec, pre_state, state,
        compute_committee_indices(spec, state, state.current_sync_committee),
        block.body.sync_aggregate.sync_committee_bits,
        block.proposer_index)


def _build_block_for_next_slot_with_sync_participation(spec, state, committee_indices,
                                                       committee_bits):
    block = build_empty_block_for_next_slot(spec, state)
    participants = [i for i, bit in zip(committee_indices, committee_bits) if bit]
    block.body.sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=committee_bits,
        sync_committee_signature=compute_aggregate_sync_committee_signature(
            spec, state, block.slot - 1, participants, block_root=block.parent_root),
    )
    return block


def run_successful_sync_committee_test(spec, state, committee_indices, committee_bits):
    yield from run_sync_committee_processing(
        spec, state,
        _build_block_for_next_slot_with_sync_participation(
            spec, state, committee_indices, committee_bits))
