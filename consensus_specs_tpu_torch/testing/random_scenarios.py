"""Randomized block-scenario engine (reference capability:
test/utils/randomized_block_tests.py + generators/random/generate.py).

A scenario is a seeded sequence of stages; each stage either advances
time (slots / epochs / a leak-depth worth of empty epochs) or produces a
signed block with randomized contents.  The engine runs the REAL
state_transition for every block and yields standard sanity-block vector
parts, so each scenario doubles as a conformance vector.
"""
from __future__ import annotations

from random import Random

from .helpers.block import build_empty_block_for_next_slot
from .helpers.multi_operations import (
    get_random_attestations,
    get_random_proposer_slashings,
)
from .helpers.state import next_epoch, next_slots, state_transition_and_sign_block

# stage vocabulary -----------------------------------------------------------


def next_slot_stage(spec, state, rng):
    next_slots(spec, state, 1)


def small_skip_stage(spec, state, rng):
    next_slots(spec, state, rng.randint(2, int(spec.SLOTS_PER_EPOCH) // 2))


def next_epoch_stage(spec, state, rng):
    next_epoch(spec, state)


def leak_stage(spec, state, rng):
    """Empty epochs deep enough to enter the inactivity leak."""
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2):
        next_epoch(spec, state)
    assert spec.is_in_inactivity_leak(state)


def _random_sync_aggregate(spec, state, rng, block):
    """Random partial sync-committee participation, properly signed (the
    vectors generate BLS-on).  Only within the pre-state's sync-committee
    period: at period rotation the pre-state committee would no longer
    match the processing committee (domain and committee are stable
    within a period, so epoch boundaries inside it are fine)."""
    from .helpers.sync_committee import (
        compute_aggregate_sync_committee_signature,
        compute_committee_indices,
    )

    if int(spec.compute_sync_committee_period(
            spec.compute_epoch_at_slot(block.slot))) != \
            int(spec.compute_sync_committee_period(
                spec.get_current_epoch(state))):
        return
    committee = compute_committee_indices(spec, state)
    bits = [rng.random() < 0.75 for _ in committee]
    participants = [v for v, b in zip(committee, bits) if b]
    block.body.sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits,
        sync_committee_signature=compute_aggregate_sync_committee_signature(
            spec, state, block.slot - 1, participants,
            block_root=block.parent_root),
    )


def _random_block(spec, state, rng):
    block = build_empty_block_for_next_slot(spec, state)
    if int(state.slot) > int(spec.SLOTS_PER_EPOCH):
        for att in get_random_attestations(
            spec, state, rng, num_attestations=rng.randint(0, 2)
        ):
            block.body.attestations.append(att)
    if rng.random() < 0.25:
        for ps in get_random_proposer_slashings(spec, state, rng):
            block.body.proposer_slashings.append(ps)
    if hasattr(spec, "SyncAggregate") and rng.random() < 0.5:
        _random_sync_aggregate(spec, state, rng, block)
    block.body.graffiti = rng.getrandbits(256).to_bytes(32, "little")
    return block


def _skip_slots_with_slashed_proposer(spec, state):
    """A slashed validator can never propose; a live chain simply has no
    block those slots.  Bounded: some unslashed proposer always exists."""
    while True:
        probe = state.copy()
        spec.process_slots(probe, probe.slot + 1)
        if not probe.validators[spec.get_beacon_proposer_index(probe)].slashed:
            return
        next_slots(spec, state, 1)


def block_stage(spec, state, rng, blocks):
    _skip_slots_with_slashed_proposer(spec, state)
    block = _random_block(spec, state, rng)
    blocks.append(state_transition_and_sign_block(spec, state, block))


def empty_block_stage(spec, state, rng, blocks):
    _skip_slots_with_slashed_proposer(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    blocks.append(state_transition_and_sign_block(spec, state, block))


# engine ---------------------------------------------------------------------

_TIME_STAGES = (next_slot_stage, small_skip_stage, next_epoch_stage)
_BLOCK_STAGES = (block_stage, empty_block_stage)


def make_random_case(fork: str, seed: int, with_leak: bool = False,
                     stages: int = 6):
    """Decorated test case running a seeded scenario under ``fork`` —
    the per-fork random suites are just seed tables over this."""
    from .context import spec_state_test, with_phases

    @spec_state_test
    def case(spec, state):
        yield from run_random_scenario(
            spec, state, seed=seed, stages=stages, with_leak=with_leak)

    return with_phases([fork])(case)


def run_random_scenario(spec, state, seed: int, stages: int = 8,
                        with_leak: bool = False):
    """Seeded random walk: alternating time and block stages, one full
    attestation-bearing validity check per block."""
    rng = Random(seed)
    blocks = []
    yield "pre", state
    if with_leak:
        leak_stage(spec, state, rng)
    for _ in range(stages):
        rng.choice(_TIME_STAGES)(spec, state, rng)
        rng.choice(_BLOCK_STAGES)(spec, state, rng, blocks)
    yield "blocks", blocks
    yield "post", state
    # the transition applied every block; the last one must be the head
    # (the cached header's state_root stays zeroed until the next slot, so
    # compare the slot + body root rather than the full header root)
    assert blocks, "scenario produced no blocks"
    last = blocks[-1].message
    assert int(state.latest_block_header.slot) == int(last.slot)
    assert state.latest_block_header.body_root == last.body.hash_tree_root()
    assert int(state.slot) >= stages
