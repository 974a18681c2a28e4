"""Partial block-processing runner (parity capability: reference
``test/helpers/block_processing.py``).

The sub-transition table is data, not a dict of lambdas: each row names the
spec function and how to feed it from a block, and ``run_block_processing_to``
walks rows in canonical order until it reaches the requested one.

Engine-backed mode: under ``engine_mode()`` every signed-block transition
driven through ``state_transition_and_sign_block`` (helpers/state.py) is
mirrored through ``stf.apply_signed_blocks`` on a shadow copy of the
pre-state with the same validity expectation, then post-state
``hash_tree_root`` parity is asserted — so any scenario scripted through
the helpers doubles as a differential test of the batched block-transition
engine against the literal spec path (same pattern as
helpers/fork_choice.py's fork-choice engine mirror).
"""
from __future__ import annotations

import contextlib

# -- engine-backed differential mode -----------------------------------------

_engine_mode = False


@contextlib.contextmanager
def engine_mode():
    """Mirror every helper-driven signed-block transition through the
    batched transition engine and assert post-state parity."""
    global _engine_mode
    prev = _engine_mode
    _engine_mode = True
    try:
        yield
    finally:
        _engine_mode = prev


def engine_pre_state(state):
    """Pre-transition snapshot for the engine mirror (None when inactive)."""
    return state.copy() if _engine_mode else None


def mirror_signed_block(spec, pre_state, signed_block, post_state,
                        expect_fail=False):
    """Replay ``signed_block`` on the engine-mode shadow pre-state and
    assert byte-identical post-state (or that the engine also rejects)."""
    if pre_state is None:
        return
    from consensus_specs_tpu_torch import stf

    shadow = pre_state
    if expect_fail:
        try:
            stf.apply_signed_blocks(spec, shadow, [signed_block])
        except Exception:
            return
        raise AssertionError(
            "engine accepted a block the spec path rejected")
    stf.apply_signed_blocks(spec, shadow, [signed_block])
    assert bytes(shadow.hash_tree_root()) == bytes(post_state.hash_tree_root()), \
        "engine post-state diverged from the literal spec transition"

# (spec function name, block accessor, mode)
#   mode "block":   fn(state, block)
#   mode "single":  fn(state, accessor(block))
#   mode "each":    fn(state, item) for item in accessor(block)
#   mode "payload": fn(state, accessor(block), spec.EXECUTION_ENGINE)
_SUB_TRANSITIONS = (
    # phase0
    ("process_block_header", None, "block"),
    ("process_randao", lambda b: b.body, "single"),
    ("process_eth1_data", lambda b: b.body, "single"),
    ("process_proposer_slashing", lambda b: b.body.proposer_slashings, "each"),
    ("process_attester_slashing", lambda b: b.body.attester_slashings, "each"),
    ("process_shard_header", lambda b: b.body.shard_headers, "each"),
    ("process_attestation", lambda b: b.body.attestations, "each"),
    ("process_deposit", lambda b: b.body.deposits, "each"),
    ("process_voluntary_exit", lambda b: b.body.voluntary_exits, "each"),
    # altair
    ("process_sync_aggregate", lambda b: b.body.sync_aggregate, "single"),
    # bellatrix
    ("process_execution_payload", lambda b: b.body.execution_payload, "payload"),
    # capella
    ("process_withdrawals", lambda b: b.body.execution_payload, "single"),
    ("process_bls_to_execution_change", lambda b: b.body.bls_to_execution_changes, "each"),
)


def for_ops(state, operations, fn) -> None:
    for operation in operations:
        fn(state, operation)


def _make_call(spec, name, accessor, mode):
    fn = getattr(spec, name)
    if mode == "block":
        return fn
    if mode == "single":
        return lambda state, block: fn(state, accessor(block))
    if mode == "payload":
        return lambda state, block: fn(state, accessor(block), spec.EXECUTION_ENGINE)
    return lambda state, block: for_ops(state, accessor(block), fn)


def get_process_calls(spec):
    return {
        name: _make_call(spec, name, accessor, mode)
        for name, accessor, mode in _SUB_TRANSITIONS
        if hasattr(spec, name)
    }


def run_block_processing_to(spec, state, block, process_name: str):
    """Run every sub-transition before ``process_name`` (in canonical order)
    and return the ``process_name`` step itself as a callable."""
    if state.slot < block.slot:
        spec.process_slots(state, block.slot)
    for name, accessor, mode in _SUB_TRANSITIONS:
        if name == process_name:
            return _make_call(spec, name, accessor, mode)
        if hasattr(spec, name):  # later forks add steps earlier forks lack
            _make_call(spec, name, accessor, mode)(state, block)
