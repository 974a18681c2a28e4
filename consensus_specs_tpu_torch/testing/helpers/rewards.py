"""Rewards-suite helpers (reference capability: test/helpers/rewards.py).

``run_deltas`` yields every reward component's (rewards, penalties) pair
as an SSZ ``Deltas`` vector part and cross-checks each against the
attester sets the state actually contains — then pins their sum to
``get_attestation_deltas`` (which is the installed JAX kernel, so every
rewards test is also a kernel differential test).
NOTE: no ``from __future__ import annotations`` here — the Deltas
container needs live type annotations for the SSZ field machinery.
"""
from consensus_specs_tpu_torch.ssz.types import Container, List, uint64

VALIDATOR_REGISTRY_LIMIT = 2**40
Gwei = uint64


class Deltas(Container):
    rewards: List[Gwei, VALIDATOR_REGISTRY_LIMIT]
    penalties: List[Gwei, VALIDATOR_REGISTRY_LIMIT]


def has_enough_for_reward(spec, state, index) -> bool:
    """Rewards are nonzero only when the base reward quotient is."""
    return (
        int(state.validators[index].effective_balance)
        * int(spec.BASE_REWARD_FACTOR)
        > int(spec.integer_squareroot(spec.get_total_active_balance(state)))
        * int(spec.BASE_REWARDS_PER_EPOCH)
    )


def _component(spec, state, name):
    rewards, penalties = getattr(spec, f"get_{name}_deltas")(state)
    return Deltas(rewards=rewards, penalties=penalties)


def _eligible_indices(spec, state):
    prev = spec.get_previous_epoch(state)
    return [
        i for i, v in enumerate(state.validators)
        if spec.is_active_validator(v, prev)
        or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


# -- independent exact model ------------------------------------------------
#
# A third implementation of the phase0 rewards pipeline, written over numpy
# columns: the sequential spec transcription and the installed vectorized
# kernel must BOTH match it value-for-value.  This is the triangulation that
# catches a wrong-but-plausible kernel substitution (a sum-only check can
# mask compensating errors between components).

def _model_base_rewards(spec, state):
    import numpy as np
    from consensus_specs_tpu_torch.ssz.bulk import validator_columns

    cols = validator_columns(state.validators)
    eff = cols["effective_balance"].astype(object)  # exact int math
    sqrt_total = int(spec.integer_squareroot(spec.get_total_active_balance(state)))
    return np.array([
        int(e) * int(spec.BASE_REWARD_FACTOR) // sqrt_total // int(spec.BASE_REWARDS_PER_EPOCH)
        for e in eff
    ], dtype=object)


def _model_component(spec, state, attestations):
    """Exact expected (rewards, penalties) for one source/target/head
    component, as python-int numpy vectors."""
    import numpy as np

    n = len(state.validators)
    rewards = np.zeros(n, dtype=object)
    penalties = np.zeros(n, dtype=object)
    base = _model_base_rewards(spec, state)
    unslashed = {int(i) for i in spec.get_unslashed_attesting_indices(state, attestations)}
    attesting = int(spec.get_total_balance(state, unslashed))
    total = int(spec.get_total_active_balance(state))
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    leak = bool(spec.is_in_inactivity_leak(state))
    for i in (int(x) for x in spec.get_eligible_validator_indices(state)):
        if i in unslashed:
            rewards[i] = base[i] if leak \
                else int(base[i]) * (attesting // incr) // (total // incr)
        else:
            penalties[i] = base[i]
    return rewards, penalties


def _model_inclusion_delay(spec, state):
    """Exact expected inclusion-delay rewards: each unslashed source
    attester is paid off its *earliest* inclusion, whose proposer collects
    the proposer cut."""
    import numpy as np

    n = len(state.validators)
    rewards = np.zeros(n, dtype=object)
    base = _model_base_rewards(spec, state)
    source_atts = spec.get_matching_source_attestations(
        state, spec.get_previous_epoch(state))
    quotient = int(spec.PROPOSER_REWARD_QUOTIENT)

    earliest: dict = {}  # attester -> (delay, proposer)
    for att in source_atts:
        members = spec.get_attesting_indices(state, att.data, att.aggregation_bits)
        for i in (int(x) for x in members):
            delay = int(att.inclusion_delay)
            if i not in earliest or delay < earliest[i][0]:
                earliest[i] = (delay, int(att.proposer_index))
    unslashed = {int(i) for i in spec.get_unslashed_attesting_indices(state, source_atts)}
    for i in sorted(unslashed):
        delay, proposer = earliest[i]
        proposer_cut = int(base[i]) // quotient
        rewards[proposer] += proposer_cut
        rewards[i] += (int(base[i]) - proposer_cut) // delay
    return rewards, np.zeros(n, dtype=object)


def _model_inactivity(spec, state):
    """Exact expected inactivity penalties (zero outside the leak)."""
    import numpy as np

    n = len(state.validators)
    penalties = np.zeros(n, dtype=object)
    if spec.is_in_inactivity_leak(state):
        base = _model_base_rewards(spec, state)
        target_atts = spec.get_matching_target_attestations(
            state, spec.get_previous_epoch(state))
        on_target = {int(i) for i in spec.get_unslashed_attesting_indices(state, target_atts)}
        delay = int(spec.get_finality_delay(state))
        for i in (int(x) for x in spec.get_eligible_validator_indices(state)):
            proposer_cut = int(base[i]) // int(spec.PROPOSER_REWARD_QUOTIENT)
            penalties[i] = int(spec.BASE_REWARDS_PER_EPOCH) * int(base[i]) - proposer_cut
            if i not in on_target:
                penalties[i] += (int(state.validators[i].effective_balance) * delay
                                 // int(spec.INACTIVITY_PENALTY_QUOTIENT))
    return np.zeros(n, dtype=object), penalties


def _assert_deltas_equal(deltas, expected_rewards, expected_penalties, label):
    for i, (er, ep) in enumerate(zip(expected_rewards, expected_penalties)):
        assert int(deltas.rewards[i]) == int(er), (label, "reward", i)
        assert int(deltas.penalties[i]) == int(ep), (label, "penalty", i)


def run_deltas(spec, state):
    """Yield all five phase0 component deltas + consistency checks."""
    yield "pre", state

    source = _component(spec, state, "source")
    target = _component(spec, state, "target")
    head = _component(spec, state, "head")
    inclusion = _component(spec, state, "inclusion_delay")
    inactivity = _component(spec, state, "inactivity_penalty")

    yield "source_deltas", source
    yield "target_deltas", target
    yield "head_deltas", head
    yield "inclusion_delay_deltas", inclusion
    yield "inactivity_penalty_deltas", inactivity

    # component-level sanity vs the attester sets in the state
    matching = {
        "source": spec.get_matching_source_attestations(
            state, spec.get_previous_epoch(state)),
        "target": spec.get_matching_target_attestations(
            state, spec.get_previous_epoch(state)),
        "head": spec.get_matching_head_attestations(
            state, spec.get_previous_epoch(state)),
    }
    eligible = set(_eligible_indices(spec, state))
    for name, deltas in (("source", source), ("target", target), ("head", head)):
        attesters = spec.get_unslashed_attesting_indices(state, matching[name])
        for index in range(len(state.validators)):
            if index not in eligible:
                assert int(deltas.rewards[index]) == 0
                assert int(deltas.penalties[index]) == 0
            elif index in attesters:
                if has_enough_for_reward(spec, state, index):
                    assert int(deltas.rewards[index]) > 0
                assert int(deltas.penalties[index]) == 0
            else:
                assert int(deltas.rewards[index]) == 0
                if has_enough_for_reward(spec, state, index):
                    assert int(deltas.penalties[index]) > 0

    # exact-value triangulation: sequential spec components == the
    # independent numpy model, value for value
    _assert_deltas_equal(source, *_model_component(
        spec, state, matching["source"]), "source")
    _assert_deltas_equal(target, *_model_component(
        spec, state, matching["target"]), "target")
    _assert_deltas_equal(head, *_model_component(
        spec, state, matching["head"]), "head")
    _assert_deltas_equal(inclusion, *_model_inclusion_delay(spec, state), "inclusion")
    _assert_deltas_equal(inactivity, *_model_inactivity(spec, state), "inactivity")

    # the components must sum to the full attestation deltas (the installed
    # vectorized kernel), proving kernel == sum-of-sequential-components
    total_r, total_p = spec.get_attestation_deltas(state)
    for index in range(len(state.validators)):
        assert int(total_r[index]) == sum(
            int(d.rewards[index])
            for d in (source, target, head, inclusion, inactivity)
        )
        assert int(total_p[index]) == sum(
            int(d.penalties[index])
            for d in (source, target, head, inclusion, inactivity)
        )


def run_flag_deltas(spec, state):
    """Altair+ flag-based rewards: yield per-flag component deltas plus
    inactivity-penalty deltas, check each against the participating sets
    the state actually contains, then pin the installed vectorized
    ``process_rewards_and_penalties`` kernel to the sequential
    apply-each-component result (including balance flooring order)."""
    yield "pre", state

    prev = spec.get_previous_epoch(state)
    eligible = {int(i) for i in spec.get_eligible_validator_indices(state)}
    in_leak = spec.is_in_inactivity_leak(state)
    base_rewards = [
        int(spec.get_base_reward(state, spec.ValidatorIndex(index)))
        if index in eligible else 0
        for index in range(len(state.validators))
    ]
    names = ["source", "target", "head"]
    components = []
    for flag_index in range(len(spec.PARTICIPATION_FLAG_WEIGHTS)):
        rewards, penalties = spec.get_flag_index_deltas(state, flag_index)
        deltas = Deltas(rewards=rewards, penalties=penalties)
        components.append(deltas)
        yield f"{names[flag_index]}_deltas", deltas

        unslashed = {int(i) for i in spec.get_unslashed_participating_indices(
            state, flag_index, prev)}
        weight = int(spec.PARTICIPATION_FLAG_WEIGHTS[flag_index])
        for index in range(len(state.validators)):
            base = base_rewards[index]
            if index not in eligible:
                assert int(deltas.rewards[index]) == 0
                assert int(deltas.penalties[index]) == 0
            elif index in unslashed:
                assert int(deltas.penalties[index]) == 0
                if in_leak:
                    assert int(deltas.rewards[index]) == 0
            else:
                assert int(deltas.rewards[index]) == 0
                if flag_index == int(spec.TIMELY_HEAD_FLAG_INDEX):
                    assert int(deltas.penalties[index]) == 0
                else:
                    expected = base * weight // int(spec.WEIGHT_DENOMINATOR)
                    assert int(deltas.penalties[index]) == expected

    rewards, penalties = spec.get_inactivity_penalty_deltas(state)
    inactivity = Deltas(rewards=rewards, penalties=penalties)
    components.append(inactivity)
    yield "inactivity_penalty_deltas", inactivity
    target_participants = {int(i) for i in spec.get_unslashed_participating_indices(
        state, int(spec.TIMELY_TARGET_FLAG_INDEX), prev)}
    for index in range(len(state.validators)):
        assert int(inactivity.rewards[index]) == 0
        if index in target_participants or index not in eligible:
            assert int(inactivity.penalties[index]) == 0

    # the installed kernel must equal applying every component in spec
    # order (increase, then floored decrease, per component)
    kernel_state = state.copy()
    spec.process_rewards_and_penalties(kernel_state)
    for index in range(len(state.validators)):
        bal = int(state.balances[index])
        for d in components:
            bal += int(d.rewards[index])
            bal = max(bal - int(d.penalties[index]), 0)
        assert int(kernel_state.balances[index]) == bal, index


def leaking(epochs_extra: int = 0):
    """Advance a state into the inactivity leak before running deltas."""
    def deco(fn):
        def entry(*args, spec, state, **kw):
            from .state import next_epoch

            for _ in range(
                int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2 + epochs_extra
            ):
                next_epoch(spec, state)
            assert spec.is_in_inactivity_leak(state)
            return fn(*args, spec=spec, state=state, **kw)

        return entry

    return deco


# -- scenario library ---------------------------------------------------------
#
# Each run_test_* builds one participation/registry shape and hands it to
# run_deltas; the rewards suites (basic / leak / random) parameterize these
# (reference capability: the run_test_* family of test/helpers/rewards.py).

def _participation_fraction(fraction):
    """Committee filter keeping the first ``fraction`` of each committee."""
    def _fn(slot, index, comm):
        members = sorted(comm)
        return set(members[: int(len(members) * fraction)])
    return _fn


def run_test_empty(spec, state):
    from .state import next_epoch

    next_epoch(spec, state)
    yield from run_deltas(spec, state)


def run_test_full_all_correct(spec, state):
    from .attestations import prepare_state_with_attestations

    prepare_state_with_attestations(spec, state)
    yield from run_deltas(spec, state)


def run_test_partial(spec, state, fraction):
    from .attestations import prepare_state_with_attestations

    prepare_state_with_attestations(
        spec, state, participation_fn=_participation_fraction(fraction))
    yield from run_deltas(spec, state)


def run_test_one_attestation_one_correct(spec, state):
    from .attestations import prepare_state_with_attestations

    prepare_state_with_attestations(
        spec, state,
        participation_fn=lambda slot, index, comm: (
            set(sorted(comm)[:1]) if (slot == 0 and index == 0) else set()))
    yield from run_deltas(spec, state)


def run_test_full_fraction_incorrect(spec, state, correct_target, correct_head,
                                     fraction_incorrect):
    """Full participation, but a fraction of the pending attestations carry
    wrong target and/or head roots (post-edited: rewards read the pending
    records, not signatures)."""
    from .attestations import prepare_state_with_attestations

    prepare_state_with_attestations(spec, state)
    pending = state.previous_epoch_attestations
    cutoff = int(len(pending) * fraction_incorrect)
    for i in range(cutoff):
        if not correct_target:
            pending[i].data.target.root = b"\x66" * 32
        if not correct_head:
            pending[i].data.beacon_block_root = b"\x77" * 32
    yield from run_deltas(spec, state)


def run_test_with_not_yet_activated_validators(spec, state, rng=None):
    from random import Random

    from .attestations import prepare_state_with_attestations
    from .deposits import mock_deposit

    rng = rng or Random(5555)
    # Mutate the registry BEFORE building attestations: committee sizes are
    # a function of the active set, so deactivating afterwards would leave
    # pending aggregation bits sized for committees that no longer exist.
    for index in rng.sample(range(len(state.validators)), 3):
        mock_deposit(spec, state, index)
    prepare_state_with_attestations(spec, state)
    yield from run_deltas(spec, state)


def run_test_with_exited_validators(spec, state, rng=None):
    from random import Random

    from .attestations import prepare_state_with_attestations
    from .random import exit_random_validators

    rng = rng or Random(1337)
    exit_random_validators(spec, state, rng, fraction=0.25,
                           exit_epoch=spec.get_current_epoch(state))
    prepare_state_with_attestations(spec, state)
    yield from run_deltas(spec, state)


def run_test_with_slashed_validators(spec, state, rng=None):
    from random import Random

    from .attestations import prepare_state_with_attestations
    from .random import exit_random_validators, slash_random_validators

    rng = rng or Random(3322)
    exit_random_validators(spec, state, rng, fraction=0.25)
    slash_random_validators(spec, state, rng, fraction=0.25)
    prepare_state_with_attestations(spec, state)
    yield from run_deltas(spec, state)


def run_test_low_balances(spec, state, *, attested: bool):
    """A handful of validators at minimum effective balance, either inside
    or outside the attesting set."""
    from .attestations import prepare_state_with_attestations

    low = set(range(4))
    if attested:
        prepare_state_with_attestations(spec, state)
    else:
        prepare_state_with_attestations(
            spec, state,
            participation_fn=lambda slot, index, comm: set(comm) - low)
    for index in low:
        state.validators[index].effective_balance = spec.EFFECTIVE_BALANCE_INCREMENT
    yield from run_deltas(spec, state)


def run_test_all_balances_too_low_for_reward(spec, state):
    from .attestations import prepare_state_with_attestations

    prepare_state_with_attestations(spec, state)
    for index in range(len(state.validators)):
        state.validators[index].effective_balance = 10_000_000
    yield from run_deltas(spec, state)


def run_test_full_random(spec, state, rng):
    """Random registry shape (exits + slashings) and random participation."""
    from .attestations import prepare_state_with_attestations
    from .random import exit_random_validators, slash_random_validators

    exit_random_validators(spec, state, rng, fraction=rng.uniform(0.0, 0.3))
    slash_random_validators(spec, state, rng, fraction=rng.uniform(0.0, 0.3))
    prepare_state_with_attestations(
        spec, state,
        participation_fn=lambda slot, index, comm: {
            v for v in comm if rng.random() < 0.75})
    yield from run_deltas(spec, state)
