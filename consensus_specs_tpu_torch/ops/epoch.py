"""Vectorized phase0 epoch rewards/penalties (attestation deltas) in torch.

Port of ``consensus_specs_tpu/ops/epoch_jax.py``.  The spec computes
``get_attestation_deltas`` with nested Python loops — O(validators ×
attestations) (reference: phase0/beacon-chain.md:1439-1561).  Here the
irregular part (pending attestations -> per-validator participation
flags) is flattened on host using the cached committees (numpy helpers,
copied from the reference as they are), and the arithmetic — base
rewards, three component deltas, inclusion delay, inactivity leak — runs
as int64 torch code over dense tensors on the caller's device.

Exactness: all quantities fit comfortably in int64 for any realistic
state (effective balances ≤ 32 Gwei·1e9, registry ≤ ~2^22 today, total
balance ≤ 2^57), every operand of a floor division is non-negative, and
the proposer scatter is an integer ``index_add_``; the differential tests
(tests/test_torch_epoch.py) check bit-equality against the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from consensus_specs_tpu_torch._device import upload


# --- registry columns (cached off the validators tree root) ----------------

# validator_columns saturates FAR_FUTURE_EPOCH (2^64-1) at int64 max; any
# comparison against FAR_FUTURE therefore tests >= _SAT
_SAT = 2**63 - 1

_COLS_CACHE = None  # RootKeyedCache(4), built lazily (bulk imports jax-free)


def registry_columns(state):
    """Cached numpy columns of the validator registry, keyed by the
    registry's tree root (mutation -> new root -> automatic refresh)."""
    from consensus_specs_tpu_torch.ssz import bulk

    global _COLS_CACHE
    if _COLS_CACHE is None:
        _COLS_CACHE = bulk.RootKeyedCache(4)
    return _COLS_CACHE.get(state.validators, bulk.validator_columns)


def active_mask(cols, epoch: int) -> np.ndarray:
    """is_active_validator over columns: activation <= epoch < exit."""
    return (cols["activation_epoch"] <= epoch) & (epoch < cols["exit_epoch"])


class DeltaInputs(NamedTuple):
    """Dense per-validator inputs for the deltas kernel (all numpy)."""

    effective_balance: np.ndarray  # int64 [N] Gwei
    eligible: np.ndarray           # bool [N] active-prev or slashed-not-withdrawable
    source_part: np.ndarray        # bool [N] unslashed source attester
    target_part: np.ndarray        # bool [N] unslashed target attester
    head_part: np.ndarray          # bool [N] unslashed head attester
    incl_delay: np.ndarray         # int64 [N] min inclusion delay (source attesters)
    incl_proposer: np.ndarray      # int64 [N] proposer of that attestation
    total_balance: int             # total active balance (>= EBI)
    sqrt_total: int                # integer_squareroot(total_balance)
    finality_delay: int
    # preset constants
    base_reward_factor: int
    base_rewards_per_epoch: int
    proposer_reward_quotient: int
    inactivity_penalty_quotient: int
    min_epochs_to_inactivity_penalty: int
    effective_balance_increment: int


def attesting_indices(spec, state, data, bits, plan_ctx=None) -> np.ndarray:
    """``get_attesting_indices`` for a state-resident pending attestation
    as one numpy gather off the cached whole-epoch committee geometry
    (stf/attestations.committee_context) — the spec call materializes the
    committee as a Python list per attestation, which made the epoch's
    pending-attestation scans the block-path replay's second-largest cost.
    With ``plan_ctx`` (a per-SCAN ``{epoch: plan ctx key}`` memo — pass a
    fresh ``{}`` per scan) the attestation-plan memo is probed first:
    the pendings ARE the aggregates the block path already
    resolved, so the content-addressed hit replaces even the gather +
    bits unpack (callers are set-semantics scatters, so the plan's sorted
    order is equivalent).  ``data`` was validated at inclusion, so
    ``compute_epoch_at_slot(slot)`` indexes a real committee.
    Element-set equality with the spec call is pinned by
    tests/test_torch_epoch.py."""
    from consensus_specs_tpu_torch.ssz import bulk
    from consensus_specs_tpu_torch.stf.attestations import (
        cached_plan_attesters,
        committee_context,
        plan_ctx_key,
    )

    slot = int(data.slot)
    epoch = slot // int(spec.SLOTS_PER_EPOCH)
    if plan_ctx is not None:
        pk = plan_ctx.get(epoch)
        if pk is None:
            pk = plan_ctx[epoch] = plan_ctx_key(spec, state, epoch)
        planned = cached_plan_attesters(pk, data, bits)
        if planned is not None:
            return planned
    ctx = committee_context(spec, state, epoch)
    committee = ctx.committee(slot, int(data.index))
    return committee[bulk.bitlist_to_numpy(bits)]


def extract_delta_inputs(spec, state) -> DeltaInputs:
    """Host-side flattening of state + pending attestations into arrays.

    Registry columns come straight off the Merkle backing in one tree walk
    (ssz/bulk.py) — the per-validator view loop this replaces was the real
    end-to-end bottleneck at 400k validators."""
    n = len(state.validators)
    prev_epoch = int(spec.get_previous_epoch(state))

    cols = registry_columns(state)
    eff = cols["effective_balance"]
    slashed = cols["slashed"]
    # is_active_validator: activation_epoch <= epoch < exit_epoch
    active_prev = (cols["activation_epoch"] <= prev_epoch) & (
        prev_epoch < cols["exit_epoch"]
    )
    eligible = active_prev | (
        slashed & (prev_epoch + 1 < cols["withdrawable_epoch"])
    )

    # ONE fused pass over the epoch's pending attestations replaces the
    # spec's three get_matching_* scans + three participation scans + the
    # inclusion-delay walk (seven list traversals, each rebuilding the
    # same ``a.data`` views).  Semantics per scan are the spec's exactly:
    # every attestation of the epoch matches source (the matching_source
    # selector), target matches on ``get_block_root(state, epoch)``
    # (computed at the first attestation — the spec's listcomp evaluates
    # it per item, so first-use raises identically and an empty list
    # never evaluates it), head refines target on the per-slot block root
    # (memoized per slot), and min-inclusion-delay keeps the FIRST
    # minimal element in list order (strict <, beacon-chain.md:1500-1505).
    if prev_epoch == int(spec.get_current_epoch(state)):
        epoch_atts = state.current_epoch_attestations
    else:
        epoch_atts = state.previous_epoch_attestations
    plan_ctx: dict = {}   # per-epoch plan-key memo for attesting_indices
    head_roots: dict = {}  # slot -> block root (typically two slots/epoch)
    expected_target = None
    source_part = np.zeros(n, dtype=bool)
    target_part = np.zeros(n, dtype=bool)
    head_part = np.zeros(n, dtype=bool)
    incl_delay = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    incl_proposer = np.zeros(n, dtype=np.int64)
    for a in epoch_atts:
        data = a.data
        idx = attesting_indices(
            spec, state, data, a.aggregation_bits, plan_ctx)
        source_part[idx] = True
        d = int(a.inclusion_delay)
        upd = d < incl_delay[idx]
        upd_idx = idx[upd]
        incl_delay[upd_idx] = d
        incl_proposer[upd_idx] = int(a.proposer_index)
        if expected_target is None:
            expected_target = bytes(
                spec.get_block_root(state, spec.Epoch(prev_epoch)))
        if bytes(data.target.root) == expected_target:
            target_part[idx] = True
            slot = int(data.slot)
            head_root = head_roots.get(slot)
            if head_root is None:
                head_root = head_roots[slot] = bytes(
                    spec.get_block_root_at_slot(state, data.slot))
            if bytes(data.beacon_block_root) == head_root:
                head_part[idx] = True
    source_part &= ~slashed
    target_part &= ~slashed
    head_part &= ~slashed
    incl_delay[incl_delay == np.iinfo(np.int64).max] = 1  # unused lanes

    total_balance = int(spec.get_total_active_balance(state))
    sqrt_total = int(spec.integer_squareroot(spec.uint64(total_balance)))
    finality_delay = int(prev_epoch - state.finalized_checkpoint.epoch)

    return DeltaInputs(
        effective_balance=eff,
        eligible=eligible,
        source_part=source_part,
        target_part=target_part,
        head_part=head_part,
        incl_delay=incl_delay,
        incl_proposer=incl_proposer,
        total_balance=total_balance,
        sqrt_total=sqrt_total,
        finality_delay=finality_delay,
        base_reward_factor=int(spec.BASE_REWARD_FACTOR),
        base_rewards_per_epoch=int(spec.BASE_REWARDS_PER_EPOCH),
        proposer_reward_quotient=int(spec.PROPOSER_REWARD_QUOTIENT),
        inactivity_penalty_quotient=int(spec.INACTIVITY_PENALTY_QUOTIENT),
        min_epochs_to_inactivity_penalty=int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY),
        effective_balance_increment=int(spec.EFFECTIVE_BALANCE_INCREMENT),
    )


def delta_scalars(inp: DeltaInputs) -> np.ndarray:
    """THE scalar vector layout _deltas_kernel unpacks positionally —
    single definition so every caller (attestation_deltas, the fused
    merkle-resident program, the graft entry) stays in lockstep."""
    return np.array([
        inp.total_balance, inp.sqrt_total, inp.finality_delay,
        inp.base_reward_factor, inp.base_rewards_per_epoch,
        inp.proposer_reward_quotient, inp.inactivity_penalty_quotient,
        inp.min_epochs_to_inactivity_penalty,
        inp.effective_balance_increment,
    ], dtype=np.int64)


def _scalar_ints(scalars) -> list:
    """The delta_scalars() vector as Python ints (exact, and no device
    round trip per use)."""
    if isinstance(scalars, torch.Tensor):
        scalars = scalars.tolist()
    return [int(x) for x in scalars]


def _deltas_kernel(eff, eligible, source_part, target_part, head_part,
                   incl_delay, incl_proposer, scalars):
    """Deltas on int64/bool tensors of one device. ``scalars`` is in the
    delta_scalars() order: [total_balance, sqrt_total, finality_delay,
    BRF, BRPE, PRQ, IPQ, MIN_EPOCHS_LEAK, EBI]."""
    (total_balance, sqrt_total, finality_delay, brf, brpe, prq, ipq,
     min_leak, ebi) = _scalar_ints(scalars)

    base_reward = eff * brf // sqrt_total // brpe
    proposer_reward = base_reward // prq
    is_leak = finality_delay > min_leak

    rewards = torch.zeros_like(eff)
    penalties = torch.zeros_like(eff)

    total_incr = total_balance // ebi
    for part in (source_part, target_part, head_part):
        attesting_balance = torch.clamp(torch.where(part, eff, 0).sum(), min=ebi)
        att_incr = attesting_balance // ebi
        # during a leak: full compensation
        comp_reward = (base_reward if is_leak
                       else base_reward * att_incr // total_incr)
        rewards = rewards + torch.where(eligible & part, comp_reward, 0)
        penalties = penalties + torch.where(eligible & ~part, base_reward, 0)

    # inclusion delay: attester reward plus scatter-add of proposer rewards
    max_attester_reward = base_reward - proposer_reward
    rewards = rewards + torch.where(source_part, max_attester_reward // incl_delay, 0)
    prop_credit = torch.where(source_part, proposer_reward, 0)
    rewards = rewards.index_add_(0, incl_proposer, prop_credit)

    # inactivity leak
    if is_leak:
        leak_base = brpe * base_reward - proposer_reward
        leak_extra = eff * finality_delay // ipq
        penalties = penalties + torch.where(
            eligible, leak_base + torch.where(~target_part, leak_extra, 0), 0)

    return rewards, penalties


def epoch_step(balances, eff, eligible, source_part, target_part, head_part,
               incl_delay, incl_proposer, scalars):
    """Full epoch step on one device: deltas -> balance update clipped at
    zero (the torch twin of the reference's graft ``entry()`` step)."""
    rewards, penalties = _deltas_kernel(
        eff, eligible, source_part, target_part, head_part,
        incl_delay, incl_proposer, scalars)
    new_balances = balances + rewards
    return torch.where(penalties > new_balances, 0, new_balances - penalties)


def delta_device_cache(spec, state) -> tuple:
    """The device-residency key half for one epoch-kernel call: registry
    root + previous epoch — everything the registry-derived kernel
    inputs (effective balance, eligibility mask) are pure in.
    State-ful callers pass it to ``attestation_deltas`` /
    ``fused_epoch_balance_update`` so those uploads happen once per
    registry VERSION (stf/columns.device_buffer) instead of per call."""
    return (bytes(state.validators.hash_tree_root()),
            int(spec.get_previous_epoch(state)))


def registry_inputs(inp: DeltaInputs, device, device_cache: tuple = None,
                    n_pad: int = None):
    """(effective balance, eligibility) on ``device``, zero-padded to
    ``n_pad`` lanes.  With ``device_cache`` (from ``delta_device_cache``)
    they are resident buffers keyed by registry root, uploaded once per
    registry version; the per-epoch inputs upload per call, as they must."""
    n = inp.effective_balance.shape[0]
    n_pad = n if n_pad is None else n_pad

    def eff():
        return pad_lanes(inp.effective_balance, n_pad)

    def elig():
        return pad_lanes(inp.eligible.astype(bool), n_pad)

    if device_cache is None:
        return upload(eff(), device), upload(elig(), device)
    from consensus_specs_tpu_torch.stf import columns

    # device identity is bound by device_buffer itself (it appends
    # str(device) to every key) — callers key only their derivation
    root, prev_epoch = device_cache
    return (columns.device_buffer((root, "eff_pad", n_pad), eff, device),
            columns.device_buffer((root, "eligible_pad", prev_epoch, n_pad),
                                  elig, device))


def pad_lanes(a: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    n = a.shape[0]
    if n_pad == n:
        return a
    return np.concatenate([a, np.full(n_pad - n, fill, dtype=a.dtype)])


def attestation_deltas(inp: DeltaInputs, device, device_cache: tuple = None):
    """Compute (rewards, penalties) int64 numpy arrays from DeltaInputs,
    with the arithmetic on ``device``."""
    eff, elig = registry_inputs(inp, device, device_cache)
    rewards, penalties = _deltas_kernel(
        eff, elig,
        upload(inp.source_part.astype(bool), device),
        upload(inp.target_part.astype(bool), device),
        upload(inp.head_part.astype(bool), device),
        upload(inp.incl_delay, device),
        upload(inp.incl_proposer, device),
        delta_scalars(inp),
    )
    # host-sync: the one pull-back of the epoch kernel's outputs
    return rewards.cpu().numpy(), penalties.cpu().numpy()


def attestation_deltas_for_state(spec, state, device):
    """End-to-end: state -> (rewards, penalties) numpy arrays."""
    return attestation_deltas(extract_delta_inputs(spec, state), device,
                              device_cache=delta_device_cache(spec, state))


# ---------------------------------------------------------------------------
# vectorized epoch-phase twins (installed by the spec builder as
# semantics-preserving substitutions; each keeps the sequential original
# reachable via __wrapped__, differential tests in tests/spec/phase0/)
# ---------------------------------------------------------------------------


# -- phase0 matching-attestation scans ----------------------------------------

# one shared pass per (pendings version, roots version, slot, epoch)
# computing the matching-target AND matching-head sublists together —
# the spec's two per-pending listcomps re-walk every pending's ``a.data``
# view chain per call (and its sundry LRU keys on the FULL state root).
# Both key halves are memoized subtree roots, so a probe is cheap after
# any state-root computation; FIFO-bounded like every geometry memo.
_MATCHING_SCAN_CACHE: dict = {}
_MATCHING_SCAN_MAX = 4


def _matching_scan(spec, state, epoch: int) -> dict:
    prev_epoch = int(spec.get_previous_epoch(state))
    cur_epoch = int(spec.get_current_epoch(state))
    # get_matching_source_attestations' own precondition, verbatim
    assert int(epoch) in (prev_epoch, cur_epoch)
    atts = (state.current_epoch_attestations if int(epoch) == cur_epoch
            else state.previous_epoch_attestations)
    key = (bytes(atts.hash_tree_root()),
           bytes(state.block_roots.hash_tree_root()),
           int(state.slot), int(epoch))
    hit = _MATCHING_SCAN_CACHE.get(key)
    if hit is not None:
        return hit
    # expected target root evaluated at the FIRST pending (the spec's
    # listcomp evaluates get_block_root per item, so first-use raises
    # identically and an empty list never evaluates it); head roots
    # memoized per slot with the same first-use raise point
    expected_target = None
    head_roots: dict = {}
    target, head = [], []
    for a in atts:
        data = a.data
        if expected_target is None:
            expected_target = bytes(
                spec.get_block_root(state, spec.Epoch(int(epoch))))
        if bytes(data.target.root) != expected_target:
            continue
        target.append(a)
        slot = int(data.slot)
        head_root = head_roots.get(slot)
        if head_root is None:
            head_root = head_roots[slot] = bytes(
                spec.get_block_root_at_slot(state, data.slot))
        if bytes(data.beacon_block_root) == head_root:
            head.append(a)
    from consensus_specs_tpu_torch.stf import staging

    if len(_MATCHING_SCAN_CACHE) >= _MATCHING_SCAN_MAX:
        _MATCHING_SCAN_CACHE.pop(next(iter(_MATCHING_SCAN_CACHE)))
    value = {"target": target, "head": head}
    _MATCHING_SCAN_CACHE[key] = value
    staging.note_insert(_MATCHING_SCAN_CACHE, key)
    return value


def matching_target_attestations(spec, state, epoch) -> list:
    """``get_matching_target_attestations`` off the shared scan — same
    elements, same order, same assert/raise points."""
    return _matching_scan(spec, state, int(epoch))["target"]


def matching_head_attestations(spec, state, epoch) -> list:
    """``get_matching_head_attestations`` off the shared scan."""
    return _matching_scan(spec, state, int(epoch))["head"]


def reset_caches() -> None:
    """Drop the matching-scan memo (cold-start control; the registry
    column cache is root-keyed and self-invalidating, so it stays)."""
    _MATCHING_SCAN_CACHE.clear()


def participation_mask(spec, state, attestations, n: int) -> np.ndarray:
    mask = np.zeros(n, dtype=bool)
    plan_ctx: dict = {}  # per-scan plan-key memo
    for a in attestations:
        mask[attesting_indices(
            spec, state, a.data, a.aggregation_bits, plan_ctx)] = True
    return mask


def attesting_balance(spec, state, attestations) -> int:
    """get_attesting_balance: combined effective balance of unslashed
    participants (floored at one increment, per get_total_balance)."""
    cols = registry_columns(state)
    mask = participation_mask(spec, state, attestations, len(cols["slashed"]))
    mask &= ~cols["slashed"]
    total = int(np.sum(np.where(mask, cols["effective_balance"], 0),
                       dtype=np.uint64))
    return max(int(spec.EFFECTIVE_BALANCE_INCREMENT), total)


def total_active_balance(spec, state) -> int:
    cols = registry_columns(state)
    act = active_mask(cols, int(spec.get_current_epoch(state)))
    total = int(np.sum(np.where(act, cols["effective_balance"], 0),
                       dtype=np.uint64))
    return max(int(spec.EFFECTIVE_BALANCE_INCREMENT), total)


def active_validator_indices(spec, state, epoch) -> list:
    cols = registry_columns(state)
    return [int(i) for i in np.nonzero(active_mask(cols, int(epoch)))[0]]


def effective_balance_updates(spec, state) -> None:
    """Hysteresis update; only validators whose effective balance actually
    moves touch the tree (typically a handful per epoch).  The balance
    read is a resident-column probe (the rewards phase just flushed it)."""
    from consensus_specs_tpu_torch.stf import columns as stf_columns

    cols = registry_columns(state)
    bal = stf_columns.balance_column(state)
    eff = cols["effective_balance"]
    ebi = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    hyst = ebi // int(spec.HYSTERESIS_QUOTIENT)
    down = hyst * int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER)
    up = hyst * int(spec.HYSTERESIS_UPWARD_MULTIPLIER)
    new_eff = np.minimum(bal - bal % ebi, int(spec.MAX_EFFECTIVE_BALANCE))
    change = (bal + down < eff) | (eff + up < bal)
    for i in np.nonzero(change)[0]:
        state.validators[int(i)].effective_balance = int(new_eff[i])


def slashings_sweep(spec, state, multiplier: int) -> None:
    """process_slashings with the fork's proportional multiplier.  Reads
    the resident balance column; the sweep only copies and flushes when a
    validator is actually due (usually never)."""
    from consensus_specs_tpu_torch.stf import columns as stf_columns

    epoch = int(spec.get_current_epoch(state))
    total = int(spec.get_total_active_balance(state))
    sum_slash = sum(int(x) for x in state.slashings)
    adjusted = min(sum_slash * multiplier, total)
    cols = registry_columns(state)
    window = epoch + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    mask = cols["slashed"] & (cols["withdrawable_epoch"] == window)
    if not mask.any():
        return
    # exact python big-int arithmetic on the (few) affected validators —
    # penalty_numerator can exceed int64 in small-preset edge states
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    bal = stf_columns.staged_balances(state)
    for i in np.nonzero(mask)[0]:
        eff_i = int(cols["effective_balance"][i])
        penalty = eff_i // increment * adjusted // total * increment
        b = int(bal[i])
        bal[i] = 0 if penalty > b else b - penalty
    stf_columns.flush_balances(state, bal)


def registry_updates(spec, state) -> None:
    """process_registry_updates: vectorized scans, per-index mutations only
    for the (few) affected validators, in spec iteration order."""
    cols = registry_columns(state)  # snapshot before any mutation
    cur = int(spec.get_current_epoch(state))
    eff = cols["effective_balance"]

    # activation-queue eligibility: aee == FAR_FUTURE and eff == MAX
    elig_queue = (cols["activation_eligibility_epoch"] >= _SAT) & (
        eff == int(spec.MAX_EFFECTIVE_BALANCE)
    )
    # ejections: active now and eff <= EJECTION_BALANCE
    eject = active_mask(cols, cur) & (eff <= int(spec.config.EJECTION_BALANCE))
    for i in np.nonzero(elig_queue | eject)[0]:
        index = int(i)
        if elig_queue[i]:
            state.validators[index].activation_eligibility_epoch = cur + 1
        if eject[i]:
            spec.initiate_validator_exit(state, index)

    # activation dequeue: aee <= finalized and activation == FAR_FUTURE,
    # ordered by (aee, index).  The spec builds the queue AFTER the first
    # loop, so freshly-queued validators carry aee = cur+1 — which is
    # admissible whenever finalized >= cur+1 (artificial but legal states;
    # caught by tests/spec/phase0/test_registry_vectorization.py).
    aee = np.where(elig_queue, cur + 1, cols["activation_eligibility_epoch"])
    finalized = int(state.finalized_checkpoint.epoch)
    elig_act = (aee <= finalized) & (cols["activation_epoch"] >= _SAT)
    idxs = np.nonzero(elig_act)[0]
    order = np.lexsort((idxs, aee[idxs]))
    churn = int(spec.get_validator_churn_limit(state))
    target_epoch = int(spec.compute_activation_exit_epoch(cur))
    for i in idxs[order][:churn]:
        state.validators[int(i)].activation_epoch = target_epoch
