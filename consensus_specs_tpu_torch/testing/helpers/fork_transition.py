"""Cross-fork transition machinery (reference capability:
test/helpers/fork_transition.py): drive a state up to a fork epoch under
the pre-fork spec, apply the upgrade function, and keep producing blocks
under the post-fork spec — with slot/block filters for gap scenarios and
an operation-carrying mode for the boundary blocks.
"""
from __future__ import annotations

from enum import Enum, auto

from .block import build_empty_block_for_next_slot, get_proposer_index_maybe
from .state import next_slot, state_transition_and_sign_block, transition_to


class OperationType(Enum):
    PROPOSER_SLASHING = auto()
    ATTESTER_SLASHING = auto()
    DEPOSIT = auto()
    VOLUNTARY_EXIT = auto()


def _all_blocks(_):
    return True


def skip_slots(*slots):
    """Block filter: no proposal at the given slots."""
    def f(state_at_prior_slot):
        return state_at_prior_slot.slot + 1 not in slots

    return f


def no_blocks(_):
    return False


def only_at(slot):
    def f(state_at_prior_slot):
        return state_at_prior_slot.slot + 1 == slot

    return f


def state_transition_across_slots(spec, state, to_slot, block_filter=_all_blocks,
                                  ignoring_proposers=None):
    """Advance to ``to_slot``, yielding a signed block per admitted slot.

    ``ignoring_proposers``: slots whose proposer is in the set (e.g. slashed
    validators, who can no longer propose) stay empty; the walk then runs
    PAST ``to_slot`` until one block actually lands, so the caller's post
    state always includes a block at slot >= to_slot (reference semantics:
    state_transition_across_slots_with_ignoring_proposers)."""
    assert state.slot < to_slot
    produced_at_or_after_target = ignoring_proposers is None
    while state.slot < to_slot or not produced_at_or_after_target:
        should_make_block = block_filter(state) or state.slot >= to_slot
        if should_make_block and ignoring_proposers is not None:
            proposer = get_proposer_index_maybe(spec, state, state.slot + 1)
            should_make_block = proposer not in ignoring_proposers
        if should_make_block:
            block = build_empty_block_for_next_slot(spec, state)
            yield state_transition_and_sign_block(spec, state, block)
            if state.slot >= to_slot:
                produced_at_or_after_target = True
        else:
            next_slot(spec, state)


def transition_until_fork(spec, state, fork_epoch):
    """Pre-fork spec drives the state to the last pre-fork slot."""
    transition_to(spec, state, fork_epoch * spec.SLOTS_PER_EPOCH - 1)


def do_fork(state, spec, post_spec, fork_epoch, with_block=True, operation=None):
    """Process the fork-boundary slot: slot processing under the pre-fork
    spec, the upgrade function, then optionally the first post-fork block.

    ``operation``: optional ``(body_list_field, op)`` carried by the fork
    block itself (e.g. a slashing included right at the boundary).
    Returns (state, signed_block | None).
    """
    spec.process_slots(state, state.slot + 1)
    assert state.slot % spec.SLOTS_PER_EPOCH == 0
    assert spec.compute_epoch_at_slot(state.slot) == fork_epoch

    state = getattr(post_spec, f"upgrade_to_{post_spec.fork}")(state)

    assert state.fork.epoch == fork_epoch
    version_name = f"{post_spec.fork.upper()}_FORK_VERSION"
    assert state.fork.current_version == getattr(post_spec.config, version_name)

    if not with_block:
        return state, None
    block = build_empty_block_for_next_slot(post_spec, state)
    if operation is not None:
        field, op = operation
        getattr(block.body, field).append(op)
    # the first post-fork block is produced and signed under the new spec
    signed_block = state_transition_and_sign_block(post_spec, state, block)
    return state, signed_block


def transition_to_next_epoch_and_append_blocks(spec, state, post_tag, blocks,
                                               only_last_block=False,
                                               ignoring_proposers=None):
    """Fill the rest of the current epoch with post-fork blocks, appending
    tagged signed blocks to ``blocks``."""
    to_slot = spec.SLOTS_PER_EPOCH + state.slot
    if only_last_block:
        block_filter = only_at(to_slot)
    else:
        block_filter = _all_blocks
    blocks.extend([
        post_tag(b)
        for b in state_transition_across_slots(
            spec, state, to_slot, block_filter=block_filter,
            ignoring_proposers=ignoring_proposers)
    ])


# -- operations across the boundary ------------------------------------------

def _make_operation(spec, state, operation_type):
    """Build one valid operation of the given type against ``state``.

    Returns (body_list_field, operation, post_check(spec, state))."""
    from .attester_slashings import get_valid_attester_slashing_by_indices
    from .deposits import prepare_state_and_deposit
    from .proposer_slashings import get_valid_proposer_slashing
    from .voluntary_exits import prepare_signed_exits

    if operation_type == OperationType.PROPOSER_SLASHING:
        slashing = get_valid_proposer_slashing(
            spec, state, signed_1=True, signed_2=True)
        victim = int(slashing.signed_header_1.message.proposer_index)

        def check(post_spec, post_state):
            assert post_state.validators[victim].slashed
        return "proposer_slashings", slashing, check

    if operation_type == OperationType.ATTESTER_SLASHING:
        indices = [0, 1]
        slashing = get_valid_attester_slashing_by_indices(
            spec, state, indices, signed_1=True, signed_2=True)

        def check(post_spec, post_state):
            for index in indices:
                assert post_state.validators[index].slashed
        return "attester_slashings", slashing, check

    if operation_type == OperationType.DEPOSIT:
        new_index = len(state.validators)
        deposit = prepare_state_and_deposit(
            spec, state, new_index, spec.MAX_EFFECTIVE_BALANCE, signed=True)

        def check(post_spec, post_state):
            assert len(post_state.validators) == new_index + 1
        return "deposits", deposit, check

    assert operation_type == OperationType.VOLUNTARY_EXIT
    signed_exit = prepare_signed_exits(spec, state, [0])[0]

    def check(post_spec, post_state):
        assert post_state.validators[0].exit_epoch < post_spec.FAR_FUTURE_EPOCH
    return "voluntary_exits", signed_exit, check


def run_transition_with_operation(state, fork_epoch, spec, post_spec,
                                  pre_tag, post_tag, operation_type,
                                  operation_at_slot):
    """Carry one operation across the fork boundary: included either in the
    last pre-fork block or in the fork block itself."""
    fork_slot = fork_epoch * spec.SLOTS_PER_EPOCH
    assert operation_at_slot in (fork_slot - 1, fork_slot)
    include_pre_fork = operation_at_slot == fork_slot - 1

    transition_to(spec, state, operation_at_slot - 1)
    field, operation, check = _make_operation(spec, state, operation_type)

    yield "pre", state
    blocks = []

    if include_pre_fork:
        block = build_empty_block_for_next_slot(spec, state)
        getattr(block.body, field).append(operation)
        blocks.append(pre_tag(state_transition_and_sign_block(spec, state, block)))
        check(spec, state)
        state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    else:
        state, fork_block = do_fork(
            state, spec, post_spec, fork_epoch, operation=(field, operation))
        check(post_spec, state)
    blocks.append(post_tag(fork_block))

    transition_to_next_epoch_and_append_blocks(
        post_spec, state, post_tag, blocks, only_last_block=True)
    check(post_spec, state)

    yield "blocks", blocks
    yield "post", state
