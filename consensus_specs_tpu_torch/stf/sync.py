"""Sync-aggregate fast path for the batched block-transition engine.

Altair's ``process_sync_aggregate`` (altair/beacon-chain.md:487-525) costs
the sequential path three separate walks per block: a 512-member
FastAggregateVerify pairing, an O(registry) pubkey scan to map committee
seats to validator indices, and ~1500 single-seat balance writes (one
``increase_balance`` per participant plus one per-participant proposer
increment).  This module folds all three into the engine's existing
batched shapes:

* the aggregate signature becomes ONE more entry in the block's
  ``BatchFastAggregateVerify`` multi-pairing (stf/verify.py) — message =
  previous-slot block root under ``DOMAIN_SYNC_COMMITTEE``, members
  resolved to rows of the registry affine matrix through a per-period
  memo (below), deduped through the verified-triple memo and covered by
  the same bisection-to-first-failure;
* seat-to-validator resolution is memoized per sync-committee period:
  ``sync_committee_rows`` maps the current committee's pubkeys to
  registry row indices once per (registry, committee) version, with the
  spec's exact first-occurrence (``list.index``) semantics;
* rewards apply as net per-validator deltas — participant/proposer
  reward math in exact integer arithmetic, per-seat occurrences
  aggregated with ``np.add.at`` — touching each affected balance leaf
  once instead of per seat.

Net-delta application is only order-equivalent to the spec's sequential
``increase_balance``/``decrease_balance`` walk while no balance can hit
the ``decrease_balance`` floor or the uint64 ceiling mid-sequence; both
are checked conservatively and any doubt raises ``FastPathViolation``,
handing the block to the literal replay (stf/engine.py's rollback
contract).  Port of ``consensus_specs_tpu/stf/sync.py``; differentially
pinned by tests/test_torch_stf_engine_altair.py.
"""
from __future__ import annotations

import numpy as np

from consensus_specs_tpu_torch import faults, telemetry, tracing

from .attestations import (
    FastPathViolation,
    _fifo_put,
    affine_rows,
    beacon_proposer_index,
)

# fault probes: the seat memo build (a corrupted value
# here must roll back with the block, never serve a later one) and the
# mid-walk reward application (partial balance writes must restore)
_SITE_ROWS_MEMO = faults.site("stf.sync.rows_memo")
_SITE_REWARDS = faults.site("stf.sync.rewards")

# -- per-period seat-to-registry-row memo -------------------------------------

_SYNC_ROWS_CACHE: dict = {}
_CACHE_MAX = 4


def sync_committee_rows(spec, state) -> np.ndarray:
    """Registry row indices of the CURRENT sync committee, in seat order
    with duplicate pubkeys preserved (the numpy form of the spec's
    ``all_pubkeys.index(pubkey)`` per seat — first occurrence wins).
    Memoized per (registry, committee) version: one resolution per sync
    period unless the registry changes under it."""
    key = (bytes(state.validators.hash_tree_root()),
           bytes(state.current_sync_committee.hash_tree_root()))
    hit = _SYNC_ROWS_CACHE.get(key)
    if hit is not None:
        return hit
    from consensus_specs_tpu_torch.ssz import bulk

    index_of = bulk.cached_pubkey_index(state.validators)
    pubkeys = state.current_sync_committee.pubkeys
    try:
        rows = np.fromiter((index_of[bytes(pk)] for pk in pubkeys),
                           dtype=np.int64, count=len(pubkeys))
    except KeyError:
        # the spec's list.index scan raises on a committee pubkey missing
        # from the registry — replay path surfaces its exact ValueError
        raise FastPathViolation("sync committee pubkey not in registry")
    # probed before the insert: a corrupted seat map fails the block (bad
    # signature members / bad rewards -> root mismatch) and the cache
    # transaction pops the poisoned entry with the rollback
    rows = _SITE_ROWS_MEMO(rows)
    rows.setflags(write=False)
    return _fifo_put(_SYNC_ROWS_CACHE, key, rows, cap=_CACHE_MAX)


def reset_caches() -> None:
    """Drop the seat-resolution memo (bench cold-start control and test
    isolation)."""
    _SYNC_ROWS_CACHE.clear()


def _telemetry_provider() -> dict:
    return {"rows_memo_size": len(_SYNC_ROWS_CACHE), "cap": _CACHE_MAX}


telemetry.register_provider("stf.sync", _telemetry_provider, replace=True)


# -- process_sync_aggregate, engine shape -------------------------------------


def _u64(value: int) -> int:
    """The spec's reward math runs in checked uint64 (``Gwei``/``uint64``
    products raise on overflow); mirror the bound so the engine never
    accepts arithmetic the spec would reject."""
    if value >= 1 << 64:
        raise FastPathViolation("uint64 overflow in sync reward math")
    return value


def process_sync_aggregate(spec, state, sync_aggregate, collect, bls_on) -> None:
    """``process_sync_aggregate`` (altair/beacon-chain.md:487-525) with the
    signature deferred into the block batch and rewards as net deltas."""
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.ssz import bulk

    rows = sync_committee_rows(spec, state)
    bits = bulk.bitlist_to_numpy(sync_aggregate.sync_committee_bits)
    if len(bits) != len(rows):
        raise FastPathViolation("sync bits != committee size")
    participant_rows = rows[bits]

    if bls_on:
        signature = bytes(sync_aggregate.sync_committee_signature)
        if len(participant_rows) == 0:
            # eth_fast_aggregate_verify's one non-pairing acceptance: the
            # empty participation set with the infinity signature
            if signature != bls.G2_POINT_AT_INFINITY:
                raise FastPathViolation("empty sync set, non-infinity sig")
        else:
            previous_slot = max(int(state.slot), 1) - 1
            domain = spec.get_domain(
                state, spec.DOMAIN_SYNC_COMMITTEE,
                spec.compute_epoch_at_slot(spec.Slot(previous_slot)))
            signing_root = spec.compute_signing_root(
                spec.get_block_root_at_slot(state, spec.Slot(previous_slot)),
                domain)
            registry_root = bytes(state.validators.hash_tree_root())
            validators = state.validators
            collect(registry_root + participant_rows.tobytes(),
                    len(participant_rows),
                    lambda r=participant_rows: affine_rows(validators, r),
                    bytes(signing_root), signature)
    tracing.count("stf.sync_aggregate")

    # participant/proposer reward derivation (spec lines verbatim, in
    # checked integer arithmetic)
    ebi = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    weight_denominator = int(spec.WEIGHT_DENOMINATOR)
    proposer_weight = int(spec.PROPOSER_WEIGHT)
    total_active_increments = int(spec.get_total_active_balance(state)) // ebi
    total_base_rewards = _u64(
        int(spec.get_base_reward_per_increment(state)) * total_active_increments)
    max_participant_rewards = (
        _u64(total_base_rewards * int(spec.SYNC_REWARD_WEIGHT))
        // weight_denominator // int(spec.SLOTS_PER_EPOCH))
    participant_reward = max_participant_rewards // int(spec.SYNC_COMMITTEE_SIZE)
    proposer_reward = (_u64(participant_reward * proposer_weight)
                       // (weight_denominator - proposer_weight))

    _apply_rewards(spec, state, rows, bits, participant_reward, proposer_reward)


def _apply_rewards(spec, state, rows, bits, participant_reward: int,
                   proposer_reward: int) -> None:
    """Net-delta equivalent of the spec's per-seat reward walk: each seat
    contributes +participant_reward (bit set) or -participant_reward (bit
    clear) to its validator, and each set bit adds proposer_reward to the
    proposer.  Equivalence to the sequential fold needs no balance to
    floor at zero or overflow mid-walk; both are bounded conservatively
    (credits-only upper prefix, debits-only lower prefix) and violations
    replay through the literal spec."""
    uniq, inv = np.unique(rows, return_inverse=True)
    credit = np.zeros(len(uniq), dtype=np.uint64)
    np.add.at(credit, inv[bits], np.uint64(participant_reward))
    debit = np.zeros(len(uniq), dtype=np.uint64)
    np.add.at(debit, inv[~bits], np.uint64(participant_reward))

    deltas = {int(i): (int(c), int(d))
              for i, c, d in zip(uniq, credit, debit)}
    n_participants = int(np.count_nonzero(bits))
    if n_participants and proposer_reward:
        proposer = int(beacon_proposer_index(spec, state))
        c, d = deltas.get(proposer, (0, 0))
        deltas[proposer] = (c + n_participants * proposer_reward, d)

    balances = state.balances
    for index, (c, d) in deltas.items():
        _SITE_REWARDS()  # mid-walk: some balances written, some pending
        b = int(balances[index])
        if b + c >= 1 << 64:
            raise FastPathViolation("sync reward overflows a balance")
        if d > b:
            raise FastPathViolation("sync penalty floors a balance")
        balances[index] = spec.Gwei(b + c - d)
