"""Attestation construction, signing and scenario runners.

Parity surface: reference ``eth2spec/test/helpers/attestations.py``.
Differences in shape: the aggregate signing root is computed once per
attestation (all participants sign the same message, so the reference's
per-validator domain/root recomputation is pure overhead), and aggregation
bits are built in bulk rather than assigned index-by-index.
"""
from __future__ import annotations

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs.builder import LRUDict
from consensus_specs_tpu_torch.ssz.types import Bitlist

from ..context import expect_assertion_error, is_post_altair
from .block import build_empty_block_for_next_slot
from .keys import privkeys
from .state import next_epoch, next_slot, state_transition_and_sign_block


def run_attestation_processing(spec, state, attestation, valid=True):
    """Yield pre/attestation/post around ``process_attestation``.

    Invalid attestations must abort with AssertionError and yield no post.
    """
    yield "pre", state
    yield "attestation", attestation

    if not valid:
        expect_assertion_error(lambda: spec.process_attestation(state, attestation))
        yield "post", None
        return

    # Pre-altair the effect is observable as a pending-attestation append;
    # post-altair a duplicate attestation may legitimately change nothing.
    if is_post_altair(spec):
        spec.process_attestation(state, attestation)
    else:
        pending = (state.current_epoch_attestations
                   if attestation.data.target.epoch == spec.get_current_epoch(state)
                   else state.previous_epoch_attestations)
        count_before = len(pending)
        spec.process_attestation(state, attestation)
        assert len(pending) == count_before + 1

    yield "post", state


def build_attestation_data(spec, state, slot, index, shard=None):
    assert state.slot >= slot
    epoch_of_slot = spec.compute_epoch_at_slot(slot)
    current_start = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))

    if slot == state.slot:
        # Head block root is not yet in state history; recover it the way a
        # proposer would, via the parent root a next-slot block would carry.
        head_root = build_empty_block_for_next_slot(spec, state).parent_root
    else:
        head_root = spec.get_block_root_at_slot(state, slot)

    if slot < current_start:
        target_root = spec.get_block_root(state, spec.get_previous_epoch(state))
        source = state.previous_justified_checkpoint
    else:
        target_root = head_root if slot == current_start \
            else spec.get_block_root(state, spec.get_current_epoch(state))
        source = state.current_justified_checkpoint

    return spec.AttestationData(
        slot=slot,
        index=index,
        beacon_block_root=head_root,
        source=spec.Checkpoint(epoch=source.epoch, root=source.root),
        target=spec.Checkpoint(epoch=epoch_of_slot, root=target_root),
    )


def _attestation_signing_root(spec, state, attestation_data):
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, attestation_data.target.epoch)
    return spec.compute_signing_root(attestation_data, domain)


def get_attestation_signature(spec, state, attestation_data, privkey):
    return bls.Sign(privkey, _attestation_signing_root(spec, state, attestation_data))


def sign_aggregate_attestation(spec, state, attestation_data, participants):
    # One signing root serves every participant; only the keys differ.
    root = _attestation_signing_root(spec, state, attestation_data)
    return bls.Aggregate([bls.Sign(privkeys[i], root) for i in participants])


def sign_indexed_attestation(spec, state, indexed_attestation):
    indexed_attestation.signature = sign_aggregate_attestation(
        spec, state, indexed_attestation.data, indexed_attestation.attesting_indices)


def sign_attestation(spec, state, attestation):
    attesters = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits)
    attestation.signature = sign_aggregate_attestation(
        spec, state, attestation.data, attesters)


def fill_aggregate_attestation(spec, state, attestation, signed=False,
                               filter_participant_set=None):
    """Mark the (optionally filtered) committee as participating, in bulk."""
    committee = spec.get_beacon_committee(
        state, attestation.data.slot, attestation.data.index)
    participants = set(committee)
    if filter_participant_set is not None:
        participants = filter_participant_set(participants)
    attestation.aggregation_bits = Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
        *(member in participants for member in committee))
    if signed and participants:
        sign_attestation(spec, state, attestation)


def get_valid_attestation(spec, state, slot=None, index=None,
                          filter_participant_set=None, signed=False):
    # A filter that removes everyone produces a 0-participant attestation,
    # which cannot be signed and is invalid unless bits are added later.
    data = build_attestation_data(
        spec, state,
        slot=state.slot if slot is None else slot,
        index=0 if index is None else index)
    # aggregation_bits are installed wholesale by fill_aggregate_attestation.
    attestation = spec.Attestation(data=data)
    fill_aggregate_attestation(
        spec, state, attestation, signed=signed,
        filter_participant_set=filter_participant_set)
    return attestation


def add_attestations_to_state(spec, state, attestations, slot):
    if state.slot < slot:
        spec.process_slots(state, slot)
    for attestation in attestations:
        spec.process_attestation(state, attestation)


def _get_valid_attestation_at_slot(state, spec, slot_to_attest, participation_fn=None):
    """One signed attestation per committee of ``slot_to_attest``."""
    committee_count = spec.get_committee_count_per_slot(
        state, spec.compute_epoch_at_slot(slot_to_attest))
    for index in range(committee_count):
        def _filter(comm, _index=index):
            return comm if participation_fn is None \
                else participation_fn(state.slot, _index, comm)
        yield get_valid_attestation(
            spec, state, slot_to_attest, index=index, signed=True,
            filter_participant_set=_filter)


def state_transition_with_full_block(spec, state, fill_cur_epoch, fill_prev_epoch,
                                     participation_fn=None):
    """Apply one block carrying attestations for the newest attestable slot(s)."""
    block = build_empty_block_for_next_slot(spec, state)
    targets = []
    if fill_cur_epoch and state.slot >= spec.MIN_ATTESTATION_INCLUSION_DELAY:
        slot = state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY + 1
        if slot >= spec.compute_start_slot_at_epoch(spec.get_current_epoch(state)):
            targets.append(slot)
    if fill_prev_epoch:
        targets.append(state.slot - spec.SLOTS_PER_EPOCH + 1)
    for slot in targets:
        for attestation in _get_valid_attestation_at_slot(
                state, spec, slot, participation_fn=participation_fn):
            block.body.attestations.append(attestation)
    return state_transition_and_sign_block(spec, state, block)


def state_transition_with_full_attestations_block(spec, state, fill_cur_epoch, fill_prev_epoch):
    """Apply one block attesting every valid slot of the chosen epoch(s)."""
    block = build_empty_block_for_next_slot(spec, state)
    into_epoch = state.slot % spec.SLOTS_PER_EPOCH
    attestations = []
    if fill_cur_epoch:
        for offset in range(into_epoch):
            attestations += _get_valid_attestation_at_slot(state, spec, state.slot - offset)
    if fill_prev_epoch:
        epoch_start = state.slot - into_epoch
        for offset in range(1, spec.SLOTS_PER_EPOCH - into_epoch):
            attestations += _get_valid_attestation_at_slot(state, spec, epoch_start - offset)
    block.body.attestations = attestations
    return state_transition_and_sign_block(spec, state, block)


def next_slots_with_attestations(spec, state, slot_count, fill_cur_epoch,
                                 fill_prev_epoch, participation_fn=None):
    """(pre_state, signed blocks, post_state) for ``slot_count`` full blocks.

    ``participation_fn(slot, committee_index, committee_set) -> participant_set``
    """
    post_state = state.copy()
    blocks = [
        state_transition_with_full_block(
            spec, post_state, fill_cur_epoch, fill_prev_epoch, participation_fn)
        for _ in range(slot_count)
    ]
    return state, blocks, post_state


def next_epoch_with_attestations(spec, state, fill_cur_epoch, fill_prev_epoch,
                                 participation_fn=None):
    assert state.slot % spec.SLOTS_PER_EPOCH == 0
    return next_slots_with_attestations(
        spec, state, spec.SLOTS_PER_EPOCH, fill_cur_epoch, fill_prev_epoch,
        participation_fn)


def prepare_state_with_attestations(spec, state, participation_fn=None):
    """Walk one epoch (plus inclusion delay) creating and including an
    attestation per committee per slot; default participation is full."""
    next_epoch(spec, state)  # align to an epoch start for full participation
    start_slot = state.slot
    boundary = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state) + 1)

    made = []
    for _ in range(spec.SLOTS_PER_EPOCH + spec.MIN_ATTESTATION_INCLUSION_DELAY):
        if state.slot < boundary:
            for committee_index in range(
                    spec.get_committee_count_per_slot(state, spec.get_current_epoch(state))):
                def _filter(comm, _index=committee_index):
                    return comm if participation_fn is None \
                        else participation_fn(state.slot, _index, comm)
                attestation = get_valid_attestation(
                    spec, state, index=committee_index,
                    filter_participant_set=_filter, signed=True)
                if any(attestation.aggregation_bits):
                    made.append(attestation)
        if state.slot >= start_slot + spec.MIN_ATTESTATION_INCLUSION_DELAY:
            due = state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY
            add_attestations_to_state(
                spec, state, [a for a in made if a.data.slot == due], state.slot)
        next_slot(spec, state)

    assert state.slot == boundary + spec.MIN_ATTESTATION_INCLUSION_DELAY
    if not is_post_altair(spec):
        assert len(state.previous_epoch_attestations) == len(made)
    return made


_prepared_state_backings = LRUDict(10)


def cached_prepare_state_with_attestations(spec, state):
    """Memoized prepare_state_with_attestations: swaps in a cached immutable
    backing keyed on (fork, pre-state root)."""
    key = (spec.fork, state.hash_tree_root())
    if key not in _prepared_state_backings:
        prepare_state_with_attestations(spec, state)
        _prepared_state_backings[key] = state.get_backing()
    state.set_backing(_prepared_state_backings[key])
