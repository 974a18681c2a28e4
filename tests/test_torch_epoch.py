"""Phase0 epoch deltas of the torch port against the JAX reference.

The same inputs, made with numpy from a fixed seed the way
``__graft_entry__._example_inputs`` makes them, go through
``consensus_specs_tpu.ops.epoch_jax`` (``_deltas_kernel``, ``epoch_step``)
and their torch counterparts in ``consensus_specs_tpu_torch.ops.epoch`` on
the CPU.  Exact equality: every output is an int64 Gwei amount.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import epoch_jax
from consensus_specs_tpu_torch.ops import epoch


def _inputs(n, finality_delay, seed=42):
    rng = np.random.default_rng(seed)
    eff = (rng.integers(16, 33, n) * 10**9).astype(np.int64)
    eligible = rng.random(n) < 0.95
    src = (rng.random(n) < 0.8) & eligible
    tgt = src & (rng.random(n) < 0.9)
    head = tgt & (rng.random(n) < 0.9)
    # a few eligible non-attesters with balances near zero, so the
    # penalties exceed the balance and the clip at zero is exercised
    eligible[:7] = True
    src[:7] = tgt[:7] = head[:7] = False
    total = int(np.sum(np.where(eligible, eff, 0), dtype=np.uint64))
    inp = epoch.DeltaInputs(
        effective_balance=eff,
        eligible=eligible,
        source_part=src,
        target_part=tgt,
        head_part=head,
        incl_delay=np.where(src, rng.integers(1, 9, n), 1).astype(np.int64),
        incl_proposer=rng.integers(0, n, n).astype(np.int64),
        total_balance=total,
        sqrt_total=int(np.sqrt(total)),
        finality_delay=finality_delay,
        base_reward_factor=64,
        base_rewards_per_epoch=4,
        proposer_reward_quotient=8,
        inactivity_penalty_quotient=2**26,
        min_epochs_to_inactivity_penalty=4,
        effective_balance_increment=10**9,
    )
    balances = (rng.integers(16, 33, n) * 10**9).astype(np.int64)
    balances[:7] = rng.integers(0, 1000, 7)
    return inp, balances


def _arrays(inp):
    return (inp.effective_balance, inp.eligible, inp.source_part,
            inp.target_part, inp.head_part, inp.incl_delay, inp.incl_proposer)


CASES = [(4096, 2), (4096, 5), (16_411, 2), (16_411, 5)]
IDS = ["4096-no-leak", "4096-leak", "16411-no-leak", "16411-leak"]


@pytest.mark.parametrize("n,finality_delay", CASES, ids=IDS)
def test_deltas_kernel_matches_reference(n, finality_delay):
    inp, _ = _inputs(n, finality_delay)
    scalars = epoch.delta_scalars(inp)
    ref_r, ref_p = jax.jit(epoch_jax._deltas_kernel)(
        *map(jnp.asarray, _arrays(inp)), jnp.asarray(scalars))
    got_r, got_p = epoch._deltas_kernel(
        *map(torch.as_tensor, _arrays(inp)), torch.as_tensor(scalars))
    assert got_r.dtype == torch.int64 and got_p.dtype == torch.int64
    assert np.array_equal(got_r.numpy(), np.asarray(ref_r))
    assert np.array_equal(got_p.numpy(), np.asarray(ref_p))
    assert (np.asarray(ref_p) > 0).any()
    if finality_delay > inp.min_epochs_to_inactivity_penalty:
        # the leak penalises the same validators more than the calm case
        calm, _ = _inputs(n, 2)
        _, calm_p = epoch._deltas_kernel(
            *map(torch.as_tensor, _arrays(calm)),
            torch.as_tensor(epoch.delta_scalars(calm)))
        assert int(got_p.sum()) > int(calm_p.sum())


@pytest.mark.parametrize("n,finality_delay", CASES, ids=IDS)
def test_epoch_step_matches_reference(n, finality_delay):
    inp, balances = _inputs(n, finality_delay)
    scalars = epoch.delta_scalars(inp)
    ref = jax.jit(epoch_jax.epoch_step)(
        jnp.asarray(balances), *map(jnp.asarray, _arrays(inp)),
        jnp.asarray(scalars))
    got = epoch.epoch_step(
        torch.as_tensor(balances), *map(torch.as_tensor, _arrays(inp)),
        scalars)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert (got == 0).any(), "the clip at zero was not exercised"


def test_attestation_deltas_host_entry_matches_reference():
    """The numpy-in/numpy-out entry the spec substitution calls, on cpu."""
    inp, _ = _inputs(4096, 5)
    ref_r, ref_p = epoch_jax.attestation_deltas(inp)
    got_r, got_p = epoch.attestation_deltas(inp, device="cpu")
    assert np.array_equal(got_r, ref_r)
    assert np.array_equal(got_p, ref_p)
