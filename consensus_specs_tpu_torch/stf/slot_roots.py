"""Slot advancement with cheap per-slot state roots.

Port of ``consensus_specs_tpu/stf/slot_roots.py``.  ``process_slots``
(specs/src/phase0.py:785-806) computes ``hash_tree_root(state)`` once per
slot.  The persistent node layer already makes that incremental —
unchanged subtrees keep their memoized roots — so the replica below is
byte-identical to the spec loop while routing the one genuinely expensive
case through the resident merkle path: a freshly bulk-written packed
balances subtree (epoch kernels and state loaders rewrite the whole vector
through ``ssz/bulk.py``, leaving an unhashed power-of-two subtree of ~n/4
chunks).  From ``merkle_resident.RESIDENT_MIN`` validators on, that
subtree is reduced on the device the spec was built for (``spec.device``;
K2 on CUDA) and the 32-byte root is memoized into the host backing
(``memoize_packed_u64_contents_root``).  A CPU spec keeps the host hashing
path unless ``merkle_resident.RESIDENT_ON_CPU`` asks for the plain
reduction.

Unlike the reference, a failure of the device reduction is not caught.
The kernel raises ``ops.sha256.KernelError``, which the engine lets
through after restoring the block's pre-state: it neither replays the
block on the host path nor counts it against the breaker.

Differentially pinned to ``spec.process_slots`` by
tests/test_torch_stf_engine.py.
"""
from __future__ import annotations

from consensus_specs_tpu_torch import faults, tracing
from consensus_specs_tpu_torch.ops import merkle_resident

from . import columns

# fault probe: fires at each slot advance, so an error lands with some
# slots already processed — the engine rollback must restore the whole
# multi-slot advance
_SITE_PROCESS = faults.site("stf.slot_roots.process")


def state_root(spec, state):
    """``hash_tree_root(state)``, with a dirty bulk-written balances
    subtree routed through the device reduction on the spec's device."""
    _maybe_resident_balances_root(spec, state)
    return spec.hash_tree_root(state)


def _maybe_resident_balances_root(spec, state) -> None:
    balances = getattr(state, "balances", None)
    if balances is None:
        return
    device = merkle_resident.resident_device(len(balances), spec.device)
    if device is None:
        return
    if balances.get_backing().left._root is not None:
        return  # contents subtree already hashed: incremental path is free
    resident = merkle_resident.ResidentPackedU64List(
        type(balances).LENGTH, device=device)
    # after the epoch transition's flush this read is the identity fast
    # path — no tree walk before the upload
    resident.upload(columns.balance_column(state))
    merkle_resident.memoize_packed_u64_contents_root(
        balances, resident.contents_subtree_root())
    tracing.count("stf.resident_slot_root")


def process_slots(spec, state, slot) -> None:
    """Spec-identical ``process_slots`` (same asserts, same mutations, the
    spec module's own ``process_epoch``) with per-slot roots through
    ``state_root`` above."""
    assert state.slot < slot
    while state.slot < slot:
        _SITE_PROCESS()
        _process_slot(spec, state)
        # Process epoch on the start slot of the next epoch
        if (state.slot + 1) % spec.SLOTS_PER_EPOCH == 0:
            spec.process_epoch(state)
        state.slot = spec.Slot(state.slot + 1)


def _process_slot(spec, state) -> None:
    # Cache state root (phase0.py:796-806 verbatim behind state_root)
    previous_state_root = state_root(spec, state)
    state.state_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = previous_state_root
    # Cache latest block header state root
    if state.latest_block_header.state_root == spec.Bytes32():
        state.latest_block_header.state_root = previous_state_root
    # Cache block root
    previous_block_root = spec.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = previous_block_root
