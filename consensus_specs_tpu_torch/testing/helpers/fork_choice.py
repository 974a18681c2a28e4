"""Step-scripted fork-choice runners.

Parity surface: reference ``eth2spec/test/helpers/fork_choice.py``; vector
format contract: ``docs/formats/fork_choice`` (tick/block/attestation steps
plus ssz parts, replayable by clients).

Shape differences from the reference: all "run handler, expect abort when
invalid" plumbing funnels through ``_expecting_validity``; part naming goes
through one ``_part_name`` table; the epoch/slots store-appliers share one
implementation.

Engine-backed mode: under ``engine_mode()`` every store built here gets a
shadow ``forkchoice.ForkChoiceEngine`` (wrapping its own independent spec
``Store``); each handler replays its input into the shadow expecting the
same validity verdict, then asserts head + justified/finalized parity —
so any scenario scripted through these helpers doubles as a differential
test of the proto-array engine against the literal spec walk.
"""
from __future__ import annotations

import contextlib

from ..exceptions import BlockNotFoundException
from .attestations import next_slots_with_attestations


def _hex(b) -> str:
    return "0x" + bytes(b).hex()


def _part_name(kind: str, obj, field=None) -> str:
    tag = _hex(obj.block_hash if field == "block_hash" else obj.hash_tree_root())
    return f"{kind}_{tag}"


def get_block_file_name(block):
    return _part_name("block", block)


def get_attestation_file_name(attestation):
    return _part_name("attestation", attestation)


def get_attester_slashing_file_name(attester_slashing):
    return _part_name("attester_slashing", attester_slashing)


def get_pow_block_file_name(pow_block):
    return _part_name("pow_block", pow_block, field="block_hash")


def _expecting_validity(fn, valid, tolerated=(AssertionError,)):
    """Run ``fn``; when ``valid`` is False it MUST abort with ``tolerated``.

    Returns True if fn completed (only possible when valid)."""
    if valid:
        fn()
        return True
    try:
        fn()
    except tolerated:
        return False
    raise AssertionError("handler accepted an input the scenario declared invalid")


def _slot_wall_time(spec, state, slot) -> int:
    return int(state.genesis_time) + int(slot) * int(spec.config.SECONDS_PER_SLOT)


# -- engine-backed differential mode -----------------------------------------

_engine_mode = False
_engine_mirrors: dict = {}  # id(primary store) -> ForkChoiceEngine
_mirror_factory = None      # (spec, genesis_state, anchor) -> engine-like


def _default_mirror_factory(spec, genesis_state, anchor):
    from consensus_specs_tpu_torch.forkchoice import ForkChoiceEngine

    shadow = spec.get_forkchoice_store(genesis_state, anchor)
    return ForkChoiceEngine(spec, shadow)


@contextlib.contextmanager
def engine_mode(mirror_factory=None):
    """Mirror every helper-driven store mutation into a shadow proto-array
    engine and assert head/checkpoint parity after each step.

    ``mirror_factory`` swaps WHAT shadows the store: any object exposing
    the engine handler surface (``on_tick`` / ``on_block`` /
    ``on_attestations`` / ``on_attester_slashing`` / ``get_head`` /
    ``.store``) works — the node differential suite passes a
    ``Node``-backed factory so every scenario scripted through these
    helpers also pins the engine-backed ``on_block`` pipeline."""
    global _engine_mode, _mirror_factory
    prev, prev_factory = _engine_mode, _mirror_factory
    _engine_mode = True
    _mirror_factory = mirror_factory or _default_mirror_factory
    try:
        yield
    finally:
        _engine_mode = prev
        _mirror_factory = prev_factory
        if not _engine_mode:
            _engine_mirrors.clear()


def _mirror(store):
    if not _engine_mode:
        return None
    entry = _engine_mirrors.get(id(store))
    # the strong store ref both prevents id reuse and confirms the match
    if entry is None or entry[0] is not store:
        return None
    return entry[1]


def _mirror_replay(spec, store, valid, call):
    """Replay a handler into the shadow engine with the same validity
    expectation the primary store was held to, then check parity."""
    eng = _mirror(store)
    if eng is None:
        return
    _expecting_validity(lambda: call(eng), valid)
    if valid:
        assert_engine_parity(spec, store)


def assert_engine_parity(spec, store):
    """Heads and checkpoints must be byte-identical between the literal
    spec walk over ``store`` and the shadow engine's proto-array."""
    eng = _mirror(store)
    if eng is None:
        return
    # the spec materializes the justified checkpoint state lazily on the
    # first matching attestation; parity queries the head at points the
    # original scenarios didn't, so materialize it the spec's own way
    spec.store_target_checkpoint_state(store, store.justified_checkpoint)
    assert bytes(eng.get_head()) == bytes(spec.get_head(store)), \
        "proto-array engine head diverged from spec get_head"
    assert eng.store.justified_checkpoint == store.justified_checkpoint, \
        "engine justified checkpoint diverged"
    assert eng.store.finalized_checkpoint == store.finalized_checkpoint, \
        "engine finalized checkpoint diverged"


# -- store construction ------------------------------------------------------

def get_anchor_root(spec, state):
    header = state.latest_block_header.copy()
    if header.state_root == spec.Bytes32():
        header.state_root = spec.hash_tree_root(state)
    return spec.hash_tree_root(header)


def get_genesis_forkchoice_store_and_block(spec, genesis_state):
    assert genesis_state.slot == spec.GENESIS_SLOT
    anchor = spec.BeaconBlock(state_root=genesis_state.hash_tree_root())
    store = spec.get_forkchoice_store(genesis_state, anchor)
    if _engine_mode:
        _engine_mirrors[id(store)] = (
            store, _mirror_factory(spec, genesis_state, anchor))
    return store, anchor


def get_genesis_forkchoice_store(spec, genesis_state):
    return get_genesis_forkchoice_store_and_block(spec, genesis_state)[0]


# -- raw handlers (no step recording) ----------------------------------------

def run_on_block(spec, store, signed_block, valid=True):
    done = _expecting_validity(lambda: spec.on_block(store, signed_block), valid)
    if done:
        assert store.blocks[signed_block.message.hash_tree_root()] == signed_block.message
    _mirror_replay(spec, store, valid, lambda eng: eng.on_block(signed_block))


def run_on_attestation(spec, store, attestation, is_from_block=False, valid=True):
    _expecting_validity(
        lambda: spec.on_attestation(store, attestation, is_from_block=is_from_block), valid)
    _mirror_replay(
        spec, store, valid,
        lambda eng: eng.on_attestations([attestation], is_from_block=is_from_block))


def run_on_attester_slashing(spec, store, attester_slashing, valid=True):
    completed = _expecting_validity(
        lambda: spec.on_attester_slashing(store, attester_slashing), valid)
    _mirror_replay(spec, store, valid,
                   lambda eng: eng.on_attester_slashing(attester_slashing))
    return completed


def add_block_to_store(spec, store, signed_block):
    parent_state = store.block_states[signed_block.message.parent_root]
    arrival = _slot_wall_time(spec, parent_state, signed_block.message.slot)
    if store.time < arrival:
        spec.on_tick(store, arrival)
        _mirror_replay(spec, store, True, lambda eng: eng.on_tick(arrival))
    spec.on_block(store, signed_block)
    _mirror_replay(spec, store, True, lambda eng: eng.on_block(signed_block))


# -- step-recording runners (yield ssz parts, append step dicts) -------------

def on_tick_and_append_step(spec, store, time, test_steps):
    spec.on_tick(store, time)
    _mirror_replay(spec, store, True, lambda eng: eng.on_tick(time))
    test_steps.append({"tick": int(time)})


def add_block(spec, store, signed_block, test_steps, valid=True, block_not_found=False):
    """on_block plus the implied on_attestation/on_attester_slashing calls."""
    part = get_block_file_name(signed_block)
    yield part, signed_block

    if not valid:
        tolerated = (AssertionError, BlockNotFoundException) if block_not_found \
            else (AssertionError,)
        completed = _expecting_validity(
            lambda: run_on_block(spec, store, signed_block), False, tolerated)
        assert not completed
        test_steps.append({"block": part, "valid": False})
        return

    run_on_block(spec, store, signed_block)
    test_steps.append({"block": part})

    # A delivered block implies delivery of its payload of attestations and
    # attester slashings to the store as well.
    body = signed_block.message.body
    for attestation in body.attestations:
        run_on_attestation(spec, store, attestation, is_from_block=True)
    for slashing in body.attester_slashings:
        run_on_attester_slashing(spec, store, slashing)

    root = signed_block.message.hash_tree_root()
    assert store.blocks[root] == signed_block.message
    assert store.block_states[root].hash_tree_root() == signed_block.message.state_root

    def _cp(checkpoint):
        return {"epoch": int(checkpoint.epoch), "root": _hex(checkpoint.root)}

    test_steps.append({"checks": {
        "time": int(store.time),
        "head": get_formatted_head_output(spec, store),
        "justified_checkpoint": _cp(store.justified_checkpoint),
        "finalized_checkpoint": _cp(store.finalized_checkpoint),
        "best_justified_checkpoint": _cp(store.best_justified_checkpoint),
        "proposer_boost_root": _hex(store.proposer_boost_root),
    }})

    return store.block_states[root]


def tick_and_add_block(spec, store, signed_block, test_steps, valid=True,
                       merge_block=False, block_not_found=False):
    parent_state = store.block_states[signed_block.message.parent_root]
    if merge_block:
        assert spec.is_merge_transition_block(parent_state, signed_block.message.body)
    arrival = _slot_wall_time(spec, parent_state, signed_block.message.slot)
    if store.time < arrival:
        on_tick_and_append_step(spec, store, arrival, test_steps)
    post_state = yield from add_block(
        spec, store, signed_block, test_steps,
        valid=valid, block_not_found=block_not_found)
    return post_state


def add_attestation(spec, store, attestation, test_steps, is_from_block=False):
    run_on_attestation(spec, store, attestation, is_from_block=is_from_block)
    part = get_attestation_file_name(attestation)
    yield part, attestation
    test_steps.append({"attestation": part})


def tick_and_run_on_attestation(spec, store, attestation, test_steps, is_from_block=False):
    # Advance the clock one epoch past the attested block so the attestation
    # is no longer "from the future" for the store.
    target_block = store.blocks[attestation.data.beacon_block_root]
    state_at_block = store.block_states[spec.hash_tree_root(target_block)]
    mature_time = (_slot_wall_time(spec, state_at_block, target_block.slot)
                   + int(spec.SLOTS_PER_EPOCH) * int(spec.config.SECONDS_PER_SLOT))
    if store.time < mature_time:
        on_tick_and_append_step(spec, store, mature_time, test_steps)
    yield from add_attestation(spec, store, attestation, test_steps, is_from_block)


def add_attester_slashing(spec, store, attester_slashing, test_steps, valid=True):
    part = get_attester_slashing_file_name(attester_slashing)
    yield part, attester_slashing
    completed = run_on_attester_slashing(spec, store, attester_slashing, valid)
    step = {"attester_slashing": part}
    if not completed:
        step["valid"] = False
    test_steps.append(step)


def add_pow_block(spec, store, pow_block, test_steps):
    part = get_pow_block_file_name(pow_block)
    yield part, pow_block
    test_steps.append({"pow_block": part})


def get_formatted_head_output(spec, store):
    head = spec.get_head(store)
    return {"slot": int(store.blocks[head].slot), "root": _hex(head)}


# -- multi-slot store appliers -----------------------------------------------

def _apply_blocks_with_attestations(spec, state, store, slots, fill_cur_epoch,
                                    fill_prev_epoch, test_steps, participation_fn):
    _, signed_blocks, post_state = next_slots_with_attestations(
        spec, state, slots, fill_cur_epoch, fill_prev_epoch,
        participation_fn=participation_fn)
    last = None
    for signed_block in signed_blocks:
        yield from tick_and_add_block(spec, store, signed_block, test_steps)
        last = signed_block
    last_root = last.message.hash_tree_root()
    assert store.blocks[last_root] == last.message
    assert store.block_states[last_root].hash_tree_root() == post_state.hash_tree_root()
    return post_state, store, last


def apply_next_epoch_with_attestations(spec, state, store, fill_cur_epoch,
                                       fill_prev_epoch, participation_fn=None,
                                       test_steps=None):
    assert state.slot % spec.SLOTS_PER_EPOCH == 0  # whole-epoch window only
    result = yield from _apply_blocks_with_attestations(
        spec, state, store, spec.SLOTS_PER_EPOCH, fill_cur_epoch, fill_prev_epoch,
        test_steps if test_steps is not None else [], participation_fn)
    return result


def apply_next_slots_with_attestations(spec, state, store, slots, fill_cur_epoch,
                                       fill_prev_epoch, test_steps,
                                       participation_fn=None):
    result = yield from _apply_blocks_with_attestations(
        spec, state, store, slots, fill_cur_epoch, fill_prev_epoch,
        test_steps, participation_fn)
    return result
