"""Slot/epoch advancement and participation-flag manipulation for tests.

Parity surface: reference ``eth2spec/test/helpers/state.py``. Participation
fills use the framework's bulk packed-leaf seam (``ssz/bulk.py``) — one numpy
fill per epoch column instead of the reference's per-validator Python loop.
"""
from __future__ import annotations

import numpy as np

from consensus_specs_tpu_torch.ssz.bulk import set_packed_uint8_from_numpy

from ..context import expect_assertion_error, is_post_altair
from .block import apply_empty_block, sign_block, transition_unsigned_block
from .voluntary_exits import get_unslashed_exited_validators


def get_balance(state, index):
    return state.balances[index]


def get_state_root(spec, state, slot) -> bytes:
    assert slot < state.slot <= slot + spec.SLOTS_PER_HISTORICAL_ROOT
    return state.state_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT]


def _slots_until_next_epoch(spec, state) -> int:
    return spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH


def next_slot(spec, state):
    spec.process_slots(state, state.slot + 1)


def next_slots(spec, state, slots):
    if slots > 0:
        spec.process_slots(state, state.slot + slots)


def transition_to(spec, state, slot):
    assert state.slot <= slot
    # Step one slot at a time: a few suites rely on observing every boundary.
    while state.slot < slot:
        next_slot(spec, state)


def transition_to_slot_via_block(spec, state, slot):
    assert state.slot < slot
    apply_empty_block(spec, state, slot)
    assert state.slot == slot


def next_epoch(spec, state):
    next_slots(spec, state, _slots_until_next_epoch(spec, state))


def next_epoch_via_block(spec, state, insert_state_root=False):
    block = apply_empty_block(spec, state, state.slot + _slots_until_next_epoch(spec, state))
    if insert_state_root:
        block.state_root = state.hash_tree_root()
    return block


def next_epoch_via_signed_block(spec, state):
    return sign_block(spec, state, next_epoch_via_block(spec, state, insert_state_root=True))


def state_transition_and_sign_block(spec, state, block, expect_fail=False):
    """Run ``block`` through the transition, then seal in root + signature.

    Under ``block_processing.engine_mode()`` the sealed block also replays
    through the batched transition engine on a shadow pre-state copy, with
    post-state parity (or shared rejection) asserted."""
    from . import block_processing

    pre_state = block_processing.engine_pre_state(state)
    if expect_fail:
        expect_assertion_error(lambda: transition_unsigned_block(spec, state, block))
    else:
        transition_unsigned_block(spec, state, block)
    block.state_root = state.hash_tree_root()
    signed_block = sign_block(spec, state, block)
    block_processing.mirror_signed_block(
        spec, pre_state, signed_block, state, expect_fail=expect_fail)
    return signed_block


# -- participation flags (altair+) -------------------------------------------

def _fill_participation(spec, state, flags: int, current: bool, previous: bool):
    assert is_post_altair(spec)
    column = np.full(len(state.validators), flags, dtype=np.uint8)
    if current:
        set_packed_uint8_from_numpy(state.current_epoch_participation, column)
    if previous:
        set_packed_uint8_from_numpy(state.previous_epoch_participation, column)


def _all_flags(spec) -> int:
    value = spec.ParticipationFlags(0)
    for flag_index in range(len(spec.PARTICIPATION_FLAG_WEIGHTS)):
        value = spec.add_flag(value, flag_index)
    return int(value)


def set_full_participation(spec, state, rng=None):
    _fill_participation(spec, state, _all_flags(spec), current=True, previous=True)


def set_full_participation_previous_epoch(spec, state, rng=None):
    _fill_participation(spec, state, _all_flags(spec), current=False, previous=True)


def set_empty_participation(spec, state, rng=None):
    _fill_participation(spec, state, 0, current=True, previous=True)


# -- registry shape probes ---------------------------------------------------

def ensure_state_has_validators_across_lifecycle(spec, state):
    """True iff the registry covers pending, active, exited and slashed."""
    now = spec.get_current_epoch(state)
    stages = (
        any(spec.is_eligible_for_activation_queue(v) for v in state.validators),
        any(spec.is_active_validator(v, now) for v in state.validators),
        any(get_unslashed_exited_validators(spec, state)),
        any(v.slashed for v in state.validators),
    )
    return all(stages)


def has_active_balance_differential(spec, state):
    """Active balance differs from total balance by >= one increment."""
    active = spec.get_total_active_balance(state)
    total = spec.get_total_balance(state, set(range(len(state.validators))))
    return active // spec.EFFECTIVE_BALANCE_INCREMENT != total // spec.EFFECTIVE_BALANCE_INCREMENT
