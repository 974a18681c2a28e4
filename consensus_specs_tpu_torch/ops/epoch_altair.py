"""Vectorized altair+ epoch processing: participation-flag rewards,
inactivity scores, and flag rotation as whole-registry column math
(reference semantics: specs/altair/beacon-chain.md process_rewards_and_
penalties / process_inactivity_updates / process_participation_flag_updates;
the sequential forms loop per validator per flag).

Port of ``consensus_specs_tpu/ops/epoch_altair.py``.  Same architecture as
the phase0 pipeline (ops/epoch.py): columns come off the Merkle backing in
one walk (ssz/bulk.py), arithmetic is exact int64 (bounds: eff <= 32e9 *
weight(<=14) * increments(<2^26) << 2^63), results are written back in one
bottom-up rebuild.  The per-deltas-pair floor-at-zero application order of
the spec is replicated exactly.  The per-flag reward loop runs on the host
(numpy) by default, or as int64 torch code on the spec's device with
``DEVICE_COLUMNS`` set.  Sequential originals stay on __wrapped__;
differential tests: tests/test_torch_epoch_altair.py.
"""
from __future__ import annotations

import numpy as np
import torch

from consensus_specs_tpu_torch._device import upload
from consensus_specs_tpu_torch.ops.epoch import (
    active_mask,
    registry_columns,
)

# Whether the per-flag reward loop runs as torch code on the spec's device
# over the resident participation column (stf/columns.device_column).  Off
# by default, as in the reference: the host loop is the policy.  Either
# path produces bit-identical deltas (exact int64; differential:
# tests/test_torch_epoch_altair.py).
DEVICE_COLUMNS = False

# fork -> inactivity penalty quotient constant name (altair raised by
# bellatrix; later forks keep bellatrix's)
INACTIVITY_QUOTIENT = {
    "altair": "INACTIVITY_PENALTY_QUOTIENT_ALTAIR",
}


def _inactivity_quotient(spec) -> int:
    name = INACTIVITY_QUOTIENT.get(
        spec.fork, "INACTIVITY_PENALTY_QUOTIENT_BELLATRIX")
    return int(getattr(spec, name))


def _participation_columns(spec, state):
    """Both epoch participation columns as READONLY resident arrays
    (stf/columns.py): after the block path's last mirror flush these are
    dict probes, not tree walks — the epoch phases below read the same
    physical arrays the engine registered, so a 4-phase transition stops
    paying ~8 full-column unpacks."""
    from consensus_specs_tpu_torch.stf import columns

    return (
        columns.participation_column(state, current=False),
        columns.participation_column(state, current=True),
    )


def _flag_deltas_device(spec, state, cols, eligible, in_leak,
                        active_increments, base_reward_per_increment):
    """Device twin of the per-flag reward/penalty loop: one int64 torch
    pass on the spec's device consuming the previous-epoch participation
    column as a device-resident buffer (``stf/columns.device_column`` —
    uploaded once per column VERSION and shared across epoch phases),
    instead of three host passes over a re-staged copy.  All arithmetic is
    the same exact int64 as the host loop (bounds in the module
    docstring)."""
    from consensus_specs_tpu_torch.stf import columns

    device = spec.device
    prev_epoch = int(spec.get_previous_epoch(state))
    flags_dev = columns.device_column(state, False, device)
    # registry-derived kernel inputs ride the root-keyed device-buffer
    # store: uploaded once per registry VERSION, not re-staged per call
    reg_root = bytes(state.validators.hash_tree_root())
    rewards, penalties = _flag_deltas_kernel(
        flags_dev,
        columns.device_buffer(
            (reg_root, "active", prev_epoch),
            lambda: active_mask(cols, prev_epoch), device),
        columns.device_buffer((reg_root, "slashed"),
                              lambda: cols["slashed"], device),
        columns.device_buffer(
            (reg_root, "eff_i64"),
            lambda: np.asarray(cols["effective_balance"], dtype=np.int64),
            device),
        upload(np.asarray(eligible, dtype=bool), device),
        [int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS],
        [
            int(spec.EFFECTIVE_BALANCE_INCREMENT),
            base_reward_per_increment,
            active_increments,
            int(spec.WEIGHT_DENOMINATOR),
            int(in_leak),
            int(spec.TIMELY_HEAD_FLAG_INDEX),
        ],
    )
    # host-sync: the one pull-back of the flag pass's outputs; the
    # balance fold below stays host-side
    rewards = rewards.cpu().numpy()
    penalties = penalties.cpu().numpy()
    return [(rewards[i], penalties[i]) for i in range(rewards.shape[0])]


def _flag_deltas_kernel(flags, active_prev, slashed, eff, eligible,
                        weights, scalars):
    """Per-flag rewards and penalties, ``[3, n]`` int64 each, on the
    device of the tensor inputs.  ``flags`` is the uint8 participation
    column, ``active_prev``/``slashed``/``eligible`` bool, ``eff`` int64;
    ``weights`` are the three flag weights and ``scalars`` [EBI, base
    reward per increment, active increments, WEIGHT_DENOMINATOR, in_leak,
    TIMELY_HEAD_FLAG_INDEX], as Python ints."""
    ebi, brpi, active_increments, weight_den, in_leak, head_index = scalars
    base_reward = (eff // ebi) * brpi
    rewards_out, penalties_out = [], []
    for flag_index in range(3):
        participating = (active_prev
                         & (((flags >> flag_index) & 1) != 0)
                         & ~slashed)
        participating_increments = (
            torch.where(participating, eff, 0).sum(dtype=torch.int64) // ebi)
        weight = weights[flag_index]
        if in_leak == 0:
            reward_numerator = base_reward * weight * participating_increments
            rewards_out.append(torch.where(
                eligible & participating,
                reward_numerator // (active_increments * weight_den),
                0))
        else:
            rewards_out.append(torch.zeros_like(eff))
        if flag_index != head_index:
            penalties_out.append(torch.where(
                eligible & ~participating,
                base_reward * weight // weight_den,
                0))
        else:
            penalties_out.append(torch.zeros_like(eff))
    return torch.stack(rewards_out), torch.stack(penalties_out)


def _eligible_mask(spec, state, cols):
    prev_epoch = int(spec.get_previous_epoch(state))
    return active_mask(cols, prev_epoch) | (
        cols["slashed"] & (prev_epoch + 1 < cols["withdrawable_epoch"])
    )


def _unslashed_participating_mask(spec, state, cols, flags, flag_index,
                                  epoch=None):
    if epoch is None:
        epoch = int(spec.get_previous_epoch(state))
    has_flag = (flags >> flag_index) & 1
    return active_mask(cols, epoch) & has_flag.astype(bool) & ~cols["slashed"]


def rewards_and_penalties(spec, state) -> None:
    """altair+ process_rewards_and_penalties over columns."""
    from consensus_specs_tpu_torch.ssz import bulk

    if int(spec.get_current_epoch(state)) == int(spec.GENESIS_EPOCH):
        return

    cols = registry_columns(state)
    prev_flags, _ = _participation_columns(spec, state)
    eff = cols["effective_balance"]
    eligible = _eligible_mask(spec, state, cols)

    ebi = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    total_active = int(spec.get_total_active_balance(state))
    active_increments = total_active // ebi
    base_reward_per_increment = (
        ebi * int(spec.BASE_REWARD_FACTOR)
        // int(spec.integer_squareroot(spec.uint64(total_active)))
    )
    base_reward = (eff // ebi) * base_reward_per_increment
    weight_denominator = int(spec.WEIGHT_DENOMINATOR)
    in_leak = bool(spec.is_in_inactivity_leak(state))
    weights = [int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS]
    timely_head_index = int(spec.TIMELY_HEAD_FLAG_INDEX)
    timely_target_index = int(spec.TIMELY_TARGET_FLAG_INDEX)

    if DEVICE_COLUMNS:
        deltas = _flag_deltas_device(
            spec, state, cols, eligible, in_leak, active_increments,
            base_reward_per_increment)
    else:
        deltas = []
        for flag_index, weight in enumerate(weights):
            participating = _unslashed_participating_mask(
                spec, state, cols, prev_flags, flag_index)
            participating_increments = (
                int(np.sum(np.where(participating, eff, 0),
                           dtype=np.uint64)) // ebi
            )
            rewards = np.zeros_like(eff)
            penalties = np.zeros_like(eff)
            if not in_leak:
                reward_numerator = (base_reward * weight
                                    * participating_increments)
                rewards = np.where(
                    eligible & participating,
                    reward_numerator // (active_increments * weight_denominator),
                    0,
                )
            if flag_index != timely_head_index:
                penalties = np.where(
                    eligible & ~participating,
                    base_reward * weight // weight_denominator,
                    0,
                )
            deltas.append((rewards, penalties))

    # inactivity penalties (altair/beacon-chain.md get_inactivity_penalty_deltas)
    # raw uint64 view: scores can exceed int63, so guard on the unsigned max
    scores_u64 = np.asarray(
        bulk._packed_to_numpy(state.inactivity_scores, 8, "<u8"))
    target_participating = _unslashed_participating_mask(
        spec, state, cols, prev_flags, timely_target_index)
    quotient = int(spec.config.INACTIVITY_SCORE_BIAS) * _inactivity_quotient(spec)
    affected = eligible & ~target_participating
    if int(scores_u64.max(initial=0)) < (1 << 27):
        # eff <= 32e9 < 2^35, so eff*score < 2^62: exact in int64.  Scores
        # grow by BIAS(4)/epoch, so this branch covers any realistic state.
        scores = scores_u64.astype(np.int64)
        inact_pen = np.where(affected, eff * scores // quotient, 0)
    else:  # huge scores: exact big-int per affected lane.  The sequential
        # spec's uint64 numerator (eff * score) overflows at 2^64 and
        # raises; mirror that exactly so both pipelines agree bit-for-bit
        # on every representable state.
        inact_pen = np.zeros_like(eff)
        for i in np.nonzero(affected)[0]:
            numerator = int(eff[i]) * int(scores_u64[i])
            if numerator >= 1 << 64:
                raise ValueError(
                    f"value {numerator} out of range for uint64")
            inact_pen[i] = numerator // quotient
    deltas.append((np.zeros_like(eff), inact_pen))

    # the balance column rides the resident store: the read is
    # a dict probe after any earlier phase touched it, and the flush
    # stages the written array on the identity fast path so the NEXT
    # phase (slashings, effective-balance hysteresis, the resident-merkle
    # upload) skips the tree walk too
    from consensus_specs_tpu_torch.stf import columns as stf_columns

    balances = stf_columns.balance_column(state)
    for rewards, penalties in deltas:
        balances = balances + rewards
        balances = np.where(penalties > balances, 0, balances - penalties)
    stf_columns.flush_balances(state, balances)


def justification_and_finalization(spec, state) -> None:
    """altair+ process_justification_and_finalization: target balances as
    column sums instead of python index sets."""
    if int(spec.get_current_epoch(state)) <= int(spec.GENESIS_EPOCH) + 1:
        return
    cols = registry_columns(state)
    prev_flags, cur_flags = _participation_columns(spec, state)
    eff = cols["effective_balance"]
    ebi = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    target = int(spec.TIMELY_TARGET_FLAG_INDEX)

    prev_mask = _unslashed_participating_mask(spec, state, cols, prev_flags, target)
    cur_mask = _unslashed_participating_mask(
        spec, state, cols, cur_flags, target,
        epoch=int(spec.get_current_epoch(state)))
    # get_total_balance floors at one increment
    prev_bal = max(ebi, int(np.sum(np.where(prev_mask, eff, 0), dtype=np.uint64)))
    cur_bal = max(ebi, int(np.sum(np.where(cur_mask, eff, 0), dtype=np.uint64)))
    spec.weigh_justification_and_finalization(
        state, spec.get_total_active_balance(state),
        spec.Gwei(prev_bal), spec.Gwei(cur_bal))


def inactivity_updates(spec, state) -> None:
    """altair+ process_inactivity_updates over columns."""
    from consensus_specs_tpu_torch.ssz import bulk

    if int(spec.get_current_epoch(state)) == int(spec.GENESIS_EPOCH):
        return

    cols = registry_columns(state)
    prev_flags, _ = _participation_columns(spec, state)
    eligible = _eligible_mask(spec, state, cols)
    target_participating = _unslashed_participating_mask(
        spec, state, cols, prev_flags, int(spec.TIMELY_TARGET_FLAG_INDEX))

    # raw uint64 view: int64 wrap would corrupt huge scores silently
    scores = np.asarray(
        bulk._packed_to_numpy(state.inactivity_scores, 8, "<u8"))
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    recovery = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)

    # sequential parity: uint64 increment overflow raises in the spec
    if int(scores.max(initial=0)) + bias >= 1 << 64:
        raise ValueError("inactivity score increment out of range for uint64")

    # increase/decrease per participation
    scores = np.where(
        eligible & target_participating,
        scores - np.minimum(np.uint64(1), scores),
        np.where(eligible, scores + np.uint64(bias), scores),
    )
    if not spec.is_in_inactivity_leak(state):
        scores = np.where(
            eligible, scores - np.minimum(np.uint64(recovery), scores), scores)
    bulk.set_packed_uint64_from_numpy(state.inactivity_scores, scores)


def participation_flag_updates(spec, state) -> None:
    """altair+ process_participation_flag_updates: rotate current into
    previous and zero current — two bulk writes instead of an O(n) list
    comprehension of fresh flag objects, registered with the resident
    store so the next epoch's readers keep hitting."""
    from consensus_specs_tpu_torch.stf import columns

    _, current = _participation_columns(spec, state)
    # the rotated array is the store's own readonly current column —
    # registering it under the previous column's new root just shares it
    columns.flush(state, current=False, col=current)
    columns.flush(state, current=True,
                  col=np.zeros(len(current), dtype=np.uint8))
