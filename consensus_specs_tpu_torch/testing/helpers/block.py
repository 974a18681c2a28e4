"""Beacon-block scaffolding for tests.

Parity surface: reference ``eth2spec/test/helpers/block.py`` (same helper
names so ported suites read the same), restructured around a single
``_state_view_at`` primitive: every question of the form "what would the
state look like at block-slot S" — proposer index, parent root — goes through
one slot-advanced copy instead of each helper rolling its own.
"""
from __future__ import annotations

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.crypto.bls import only_with_bls
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root

from ..context import is_post_altair, is_post_bellatrix
from .execution_payload import build_empty_execution_payload
from .keys import privkeys


def _state_view_at(spec, state, slot):
    """``state`` advanced (on a copy, if needed) to exactly ``slot``."""
    if slot < state.slot:
        raise Exception(f"cannot view state at past slot {slot} (state at {state.slot})")
    if slot == state.slot:
        return state
    view = state.copy()
    spec.process_slots(view, slot)
    return view


def get_proposer_index_maybe(spec, state, slot, proposer_index=None):
    if proposer_index is not None:
        return proposer_index
    assert state.slot <= slot
    if spec.compute_epoch_at_slot(slot) > spec.compute_epoch_at_slot(state.slot) + 1:
        print("warning: proposer lookup across >1 epoch requires a slow slot transition; "
              "pass proposer_index explicitly to skip it")
    return spec.get_beacon_proposer_index(_state_view_at(spec, state, slot))


def get_state_and_beacon_parent_root_at_slot(spec, state, slot):
    view = _state_view_at(spec, state, slot)
    parent_header = view.latest_block_header.copy()
    # The header's state root is only filled in at the next process_slot;
    # mirror that here so the parent root matches what the chain would see.
    if parent_header.state_root == spec.Root():
        parent_header.state_root = hash_tree_root(view)
    return view, hash_tree_root(parent_header)


@only_with_bls()  # proposer lookup is costly, so skip entirely when BLS is stubbed
def apply_randao_reveal(spec, state, block, proposer_index=None):
    assert state.slot <= block.slot
    target_epoch = spec.compute_epoch_at_slot(block.slot)
    proposer = get_proposer_index_maybe(spec, state, block.slot, proposer_index)
    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, target_epoch)
    block.body.randao_reveal = bls.Sign(
        privkeys[proposer], spec.compute_signing_root(target_epoch, domain))


@only_with_bls()  # see apply_randao_reveal
def apply_sig(spec, state, signed_block, proposer_index=None):
    block = signed_block.message
    proposer = get_proposer_index_maybe(spec, state, block.slot, proposer_index)
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_PROPOSER, spec.compute_epoch_at_slot(block.slot))
    signed_block.signature = bls.Sign(
        privkeys[proposer], spec.compute_signing_root(block, domain))


def sign_block(spec, state, block, proposer_index=None):
    envelope = spec.SignedBeaconBlock(message=block)
    apply_sig(spec, state, envelope, proposer_index)
    return envelope


def transition_unsigned_block(spec, state, block):
    # Mirror state_transition's own ordering checks so invalid-slot scenarios
    # fail here rather than leaving a half-transitioned state behind.
    assert state.slot < block.slot
    spec.process_slots(state, block.slot)
    assert state.latest_block_header.slot < block.slot
    assert state.slot == block.slot
    spec.process_block(state, block)
    return block


def build_empty_block(spec, state, slot=None):
    """An empty block at ``slot`` (>= state.slot) chained onto the latest header."""
    if slot is None:
        slot = state.slot
    view, parent_root = get_state_and_beacon_parent_root_at_slot(spec, state, slot)
    block = spec.BeaconBlock(
        slot=slot,
        proposer_index=spec.get_beacon_proposer_index(view),
        parent_root=parent_root,
    )
    block.body.eth1_data.deposit_count = view.eth1_deposit_index
    apply_randao_reveal(spec, view, block)
    if is_post_altair(spec):
        block.body.sync_aggregate.sync_committee_signature = spec.G2_POINT_AT_INFINITY
    if is_post_bellatrix(spec):
        block.body.execution_payload = build_empty_execution_payload(spec, view)
    return block


def build_empty_block_for_next_slot(spec, state):
    return build_empty_block(spec, state, state.slot + 1)


def apply_empty_block(spec, state, slot=None):
    """Advance ``state`` in place by transitioning an empty block at ``slot``."""
    return transition_unsigned_block(spec, state, build_empty_block(spec, state, slot))
