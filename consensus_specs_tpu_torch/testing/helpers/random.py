"""State randomizers powering randomized suites (reference capability:
test/helpers/random.py): activations, deposits, exits, slashings, and
participation shuffles — each leaves the state transition-valid."""
from __future__ import annotations

from random import Random

from consensus_specs_tpu_torch.testing.context import is_post_altair

from .deposits import mock_deposit
from .state import next_epoch


def set_some_activations(spec, state, rng, activation_epoch=None):
    """A few validators become pending-activation (not yet active)."""
    if activation_epoch is None:
        activation_epoch = spec.get_current_epoch(state) + 1
    n = len(state.validators)
    picked = []
    for index in range(n):
        if rng.random() < 0.1 and len(picked) < n // 10:
            mock_deposit(spec, state, index)
            state.validators[index].activation_epoch = activation_epoch
            picked.append(index)
    return picked


def set_some_new_deposits(spec, state, rng):
    """A few validators look freshly deposited (queued, not active)."""
    n = len(state.validators)
    picked = []
    for index in range(n):
        if rng.random() < 0.1 and len(picked) < n // 10:
            mock_deposit(spec, state, index)
            if rng.choice((True, False)):
                # eligible for the queue next epoch
                state.validators[index].activation_eligibility_epoch = (
                    spec.get_current_epoch(state)
                )
            picked.append(index)
    return picked


def exit_random_validators(spec, state, rng, fraction=0.5, exit_epoch=None,
                           withdrawable_epoch=None, from_epoch=None):
    """Exit ~fraction of validators.  ``from_epoch`` (default: far enough
    back to clear the activity window) controls whether they read as
    recently or long exited."""
    if from_epoch is None:
        from_epoch = spec.config.SHARD_COMMITTEE_PERIOD + 1
    epoch_diff = int(from_epoch) - int(spec.get_current_epoch(state))
    for _ in range(epoch_diff):
        next_epoch(spec, state)

    current_epoch = spec.get_current_epoch(state)
    exited = []
    for index in spec.get_active_validator_indices(state, current_epoch):
        if rng.random() > fraction:
            continue
        validator = state.validators[index]
        validator.exit_epoch = (
            exit_epoch if exit_epoch is not None
            else rng.choice((current_epoch, current_epoch - 1))
        )
        validator.withdrawable_epoch = (
            withdrawable_epoch if withdrawable_epoch is not None
            else int(validator.exit_epoch) + int(
                spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)
        )
        exited.append(index)
    return exited


def slash_random_validators(spec, state, rng, fraction=0.5):
    slashed = []
    for index in range(len(state.validators)):
        if rng.random() < fraction:
            spec.slash_validator(state, index)
            slashed.append(index)
    return slashed


def randomize_attestation_participation(spec, state, rng=None):
    """Phase0: fill pending attestations with rng-driven participation."""
    from .attestations import prepare_state_with_attestations

    rng = rng or Random(8020)
    prepare_state_with_attestations(
        spec, state,
        participation_fn=lambda slot, index, comm: {
            i for i in comm if rng.random() < 0.75
        },
    )


def patch_state_to_non_leaking(spec, state):
    """Pin finality close enough that is_in_inactivity_leak is False."""
    state.justification_bits[0] = True
    state.justification_bits[1] = True
    previous_epoch = spec.get_previous_epoch(state)
    previous_root = spec.get_block_root(state, previous_epoch)
    current_epoch = spec.get_current_epoch(state)
    state.previous_justified_checkpoint = spec.Checkpoint(
        epoch=previous_epoch, root=previous_root)
    state.current_justified_checkpoint = spec.Checkpoint(
        epoch=previous_epoch, root=previous_root)
    state.finalized_checkpoint = spec.Checkpoint(
        epoch=previous_epoch, root=previous_root)
    assert not spec.is_in_inactivity_leak(state)
    assert int(current_epoch) >= int(previous_epoch)


def randomize_state(spec, state, rng=None, exit_fraction=0.1,
                    slash_fraction=0.1):
    """Compound randomizer: balances drift, some exits, some slashings,
    randomized participation — the standard pre-state for random suites."""
    rng = rng or Random(8020)
    for index in range(len(state.validators)):
        balance = int(state.balances[index])
        if balance > 0 and rng.random() < 0.3:
            state.balances[index] = max(
                0, balance + rng.randint(-(10**9), 10**9))
    exit_random_validators(spec, state, rng, fraction=exit_fraction)
    slash_random_validators(spec, state, rng, fraction=slash_fraction)
    if not is_post_altair(spec):
        randomize_attestation_participation(spec, state, rng)
    return state
