"""Execution-payload construction for bellatrix+ test scenarios.

Parity surface: reference ``eth2spec/test/helpers/execution_payload.py``.
Rebuilt table-driven: the payload→header projection walks one mirrored-field
tuple instead of restating every field as a literal kwarg, so capella's
withdrawals only add a root entry rather than a second copy of the table.
"""
from __future__ import annotations

from .constants import FORKS_BEFORE_CAPELLA

# Fields an ExecutionPayloadHeader carries verbatim from the payload; the
# list-typed fields (transactions, withdrawals) are summarized as SSZ roots.
_MIRRORED = (
    "parent_hash", "fee_recipient", "state_root", "receipts_root",
    "logs_bloom", "prev_randao", "block_number", "gas_limit", "gas_used",
    "timestamp", "extra_data", "base_fee_per_gas", "block_hash",
)


def has_withdrawals(spec) -> bool:
    return spec.fork not in FORKS_BEFORE_CAPELLA


def build_empty_execution_payload(spec, state, randao_mix=None):
    """A zero-transaction payload consistent with ``state`` at its own slot."""
    prev = state.latest_execution_payload_header
    if randao_mix is None:
        randao_mix = spec.get_randao_mix(state, spec.get_current_epoch(state))
    payload = spec.ExecutionPayload(
        parent_hash=prev.block_hash,
        state_root=prev.state_root,
        receipts_root=b"\xd9" * 32,
        block_number=prev.block_number + 1,
        prev_randao=randao_mix,
        gas_limit=prev.gas_limit,
        timestamp=spec.compute_timestamp_at_slot(state, state.slot),
        base_fee_per_gas=prev.base_fee_per_gas,
    )
    # Every other field keeps its SSZ zero default: no fee recipient, zero
    # gas used, empty logs bloom / extra data / transaction list.
    if has_withdrawals(spec):
        take = min(int(spec.MAX_WITHDRAWALS_PER_PAYLOAD), len(state.withdrawals_queue))
        payload.withdrawals = state.withdrawals_queue[:take]
    # No EL is attached, so no RLP/keccak block hash exists; substitute a
    # deterministic digest of the SSZ root so parent/child links still chain.
    payload.block_hash = spec.Hash32(spec.hash(payload.hash_tree_root() + b"stub-el-block-hash"))
    return payload


def get_execution_payload_header(spec, execution_payload):
    """Project ``execution_payload`` onto its header container."""
    fields = {name: getattr(execution_payload, name) for name in _MIRRORED}
    fields["transactions_root"] = spec.hash_tree_root(execution_payload.transactions)
    if has_withdrawals(spec):
        fields["withdrawals_root"] = spec.hash_tree_root(execution_payload.withdrawals)
    return spec.ExecutionPayloadHeader(**fields)


def build_state_with_execution_payload_header(spec, state, execution_payload_header):
    post = state.copy()
    post.latest_execution_payload_header = execution_payload_header
    return post


def build_state_with_incomplete_transition(spec, state):
    # Pre-merge: the header slot of the state is still all zero defaults.
    return build_state_with_execution_payload_header(spec, state, spec.ExecutionPayloadHeader())


def build_state_with_complete_transition(spec, state):
    header = get_execution_payload_header(spec, build_empty_execution_payload(spec, state))
    return build_state_with_execution_payload_header(spec, state, header)
