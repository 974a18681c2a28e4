"""Proposer-slashing construction and balance-effect assertions (parity
surface: reference ``eth2spec/test/helpers/proposer_slashings.py``).

The effect check computes an expected balance delta per role first, then
asserts, instead of the reference's branch-per-assert layout.
"""
from __future__ import annotations

from ..context import is_post_altair, is_post_bellatrix
from .block_header import sign_block_header
from .keys import pubkey_to_privkey
from .state import get_balance
from .sync_committee import (
    compute_committee_indices,
    compute_sync_committee_participant_reward_and_penalty,
)


def get_min_slashing_penalty_quotient(spec):
    for predicate, name in (
        (is_post_bellatrix, "MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX"),
        (is_post_altair, "MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR"),
    ):
        if predicate(spec):
            return getattr(spec, name)
    return spec.MIN_SLASHING_PENALTY_QUOTIENT


def _sync_reward_and_penalty(spec, pre_state, state, index, block):
    """(reward, penalty) the sync aggregate in ``block`` paid ``index``."""
    if block is None or not is_post_altair(spec):
        return 0, 0
    reward, penalty = compute_sync_committee_participant_reward_and_penalty(
        spec, pre_state, index,
        compute_committee_indices(spec, state, state.current_sync_committee),
        block.body.sync_aggregate.sync_committee_bits,
    )
    return int(reward), int(penalty)


def check_proposer_slashing_effect(spec, pre_state, state, slashed_index, block=None):
    slashed = state.validators[slashed_index]
    assert slashed.slashed
    assert slashed.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert slashed.withdrawable_epoch < spec.FAR_FUTURE_EPOCH

    slash_penalty = int(slashed.effective_balance // get_min_slashing_penalty_quotient(spec))
    whistleblower_reward = int(slashed.effective_balance // spec.WHISTLEBLOWER_REWARD_QUOTIENT)
    proposer_index = spec.get_beacon_proposer_index(state)

    sc_r_slashed, sc_p_slashed = _sync_reward_and_penalty(
        spec, pre_state, state, slashed_index, block)
    sc_r_proposer, sc_p_proposer = _sync_reward_and_penalty(
        spec, pre_state, state, proposer_index, block)

    # Deltas as plain ints: checked uint64 (rightly) refuses to go negative.
    slashed_delta = int(get_balance(state, slashed_index)) - int(get_balance(pre_state, slashed_index))
    if proposer_index == slashed_index:
        # Self-report: penalty and whistleblower reward land on one account
        # (">=" because the block may have carried multiple slashings).
        assert slashed_delta >= int(
            whistleblower_reward - slash_penalty + sc_r_slashed - sc_p_slashed)
    else:
        assert slashed_delta == int(sc_r_slashed - sc_p_slashed - slash_penalty)
        proposer_delta = (
            int(get_balance(state, proposer_index)) - int(get_balance(pre_state, proposer_index)))
        assert proposer_delta >= int(whistleblower_reward + sc_r_proposer - sc_p_proposer)


def get_valid_proposer_slashing(spec, state, random_root=b"\x99" * 32,
                                slashed_index=None, slot=None, signed_1=False, signed_2=False):
    if slashed_index is None:
        active = spec.get_active_validator_indices(state, spec.get_current_epoch(state))
        slashed_index = active[-1]
    privkey = pubkey_to_privkey[state.validators[slashed_index].pubkey]

    base_header = spec.BeaconBlockHeader(
        slot=state.slot if slot is None else slot,
        proposer_index=slashed_index,
        parent_root=b"\x33" * 32,
        state_root=b"\x44" * 32,
        body_root=b"\x55" * 32,
    )
    variant = base_header.copy()
    variant.parent_root = random_root

    def _wrap(header, do_sign):
        if do_sign:
            return sign_block_header(spec, state, header, privkey)
        return spec.SignedBeaconBlockHeader(message=header)

    return spec.ProposerSlashing(
        signed_header_1=_wrap(base_header, signed_1),
        signed_header_2=_wrap(variant, signed_2),
    )
