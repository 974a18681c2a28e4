"""Light-client store/update scaffolding, altair+ (parity capability:
reference ``test/helpers/light_client.py``)."""
from __future__ import annotations

from .sync_committee import (
    compute_aggregate_sync_committee_signature,
    compute_committee_indices,
)


def initialize_light_client_store(spec, state):
    """A fresh store trusting ``state``'s sync committees, with empty
    finalized/optimistic headers and no pending update."""
    empty_header = spec.BeaconBlockHeader()
    return spec.LightClientStore(
        finalized_header=empty_header,
        optimistic_header=empty_header,
        current_sync_committee=state.current_sync_committee,
        next_sync_committee=state.next_sync_committee,
        best_valid_update=None,
        previous_max_active_participants=0,
        current_max_active_participants=0,
    )


def get_sync_aggregate(spec, state, block_header, block_root=None, signature_slot=None):
    """Full-participation SyncAggregate over ``block_header``.

    The signing domain is taken from ``signature_slot`` (defaulting to the
    header's own slot), matching how a real aggregate trails its block.
    """
    committee = compute_committee_indices(spec, state, state.current_sync_committee)
    return spec.SyncAggregate(
        sync_committee_bits=[True] * len(committee),
        sync_committee_signature=compute_aggregate_sync_committee_signature(
            spec, state,
            block_header.slot if signature_slot is None else signature_slot,
            committee, block_root=block_root),
    )
