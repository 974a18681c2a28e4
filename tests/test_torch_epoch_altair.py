"""Altair epoch processing of the torch port against the JAX reference.

``consensus_specs_tpu_torch.ops.epoch_altair`` and
``consensus_specs_tpu.ops.epoch_altair`` run on the same states (built on
the reference's minimal preset with numpy-seeded participation flags,
slashings and inactivity scores, then decoded into the port's types):
each of the four epoch functions, the whole ``process_epoch``, in a calm
state and in an inactivity leak.  The per-flag deltas' device twin
(``_flag_deltas_device``, torch on the CPU here) is held against the
host loop and, on seeded inputs, against the reference's jitted
``_flag_deltas_kernel`` on the CPU.  Exact equality throughout: every
output is an integer or a root.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import epoch_altair as ref_epoch_altair
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu.testing.helpers.state import next_epoch
from consensus_specs_tpu_torch.ops import epoch_altair
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import bulk
from consensus_specs_tpu_torch.stf import attestations, columns

FUNCTIONS = ("rewards_and_penalties", "justification_and_finalization",
             "inactivity_updates", "participation_flag_updates")

_STATES = {}


def _mixed_state(leak: bool, seed: int = 4242):
    """A reference minimal altair state two epochs past genesis (in a leak:
    MIN_EPOCHS_TO_INACTIVITY_PENALTY + 2 more empty epochs), with seeded
    participation flags, slashed validators and inactivity scores; in the
    leak a third of the scores sit above 2^27, past the int64 fast path."""
    if leak not in _STATES:
        ref_spec = ref_get_spec("altair", "minimal")
        state = create_genesis_state(ref_spec, default_balances(ref_spec),
                                     default_activation_threshold(ref_spec))
        epochs = 2 + (int(ref_spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2
                      if leak else 0)
        for _ in range(epochs):
            next_epoch(ref_spec, state)
        rng = np.random.default_rng(seed)
        n = len(state.validators)
        for i in range(n):
            state.previous_epoch_participation[i] = int(rng.integers(0, 8))
            state.current_epoch_participation[i] = int(rng.integers(0, 8))
            state.inactivity_scores[i] = int(rng.integers(0, 100))
        for i in rng.choice(n, n // 16, replace=False):
            state.validators[int(i)].slashed = True
        if leak:
            for i in range(0, n, 3):
                state.inactivity_scores[i] = 2**28 + 12345
        assert bool(ref_spec.is_in_inactivity_leak(state)) == leak
        _STATES[leak] = (ref_spec, state)
    ref_spec, state = _STATES[leak]
    spec = get_spec("altair", "minimal", device="cpu")
    port_state = spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))
    return ref_spec, state.copy(), spec, port_state


@pytest.mark.parametrize("leak", [False, True], ids=["calm", "leak"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_epoch_function_matches_reference(name, leak):
    ref_spec, ref_state, spec, state = _mixed_state(leak)
    attestations.reset_caches()
    getattr(ref_epoch_altair, name)(ref_spec, ref_state)
    getattr(epoch_altair, name)(spec, state)
    assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())


@pytest.mark.parametrize("leak", [False, True], ids=["calm", "leak"])
def test_process_epoch_matches_reference(leak):
    ref_spec, ref_state, spec, state = _mixed_state(leak)
    attestations.reset_caches()
    ref_spec.process_epoch(ref_state)
    spec.process_epoch(state)
    assert bytes(state.encode_bytes()) == bytes(ref_state.encode_bytes())


@pytest.mark.parametrize("leak", [False, True], ids=["calm", "leak"])
def test_device_flag_deltas_equal_the_host_loop(leak, monkeypatch):
    """``DEVICE_COLUMNS`` on (torch on the spec's device, the CPU here)
    and off (the host loop, the default) give the same balances."""
    _, _, spec, state = _mixed_state(leak)
    assert epoch_altair.DEVICE_COLUMNS is False
    host, dev = state.copy(), state.copy()
    attestations.reset_caches()
    epoch_altair.rewards_and_penalties(spec, host)
    monkeypatch.setattr(epoch_altair, "DEVICE_COLUMNS", True)
    misses = columns.stats["device_misses"]
    epoch_altair.rewards_and_penalties(spec, dev)
    # the participation column and three registry columns went up once
    assert columns.stats["device_misses"] == misses + 4
    assert np.array_equal(bulk.packed_uint64_to_numpy(host.balances),
                          bulk.packed_uint64_to_numpy(dev.balances))
    assert bytes(host.hash_tree_root()) == bytes(dev.hash_tree_root())


def test_device_column_uploaded_once_per_version():
    """The participation tensor is keyed by the column's tree root: a
    second consumer of the same version gets the same tensor, a flush (a
    new root) uploads again."""
    _, _, _, state = _mixed_state(False)
    attestations.reset_caches()
    first = columns.device_column(state, False, "cpu")
    assert first.dtype == torch.uint8
    assert np.array_equal(first.numpy(), bulk.packed_uint8_to_numpy(
        state.previous_epoch_participation))
    assert columns.device_column(state, False, "cpu") is first
    col = columns.staged_view(state, current=False)
    col[:] = 0
    columns.flush(state, current=False, col=col)
    again = columns.device_column(state, False, "cpu")
    assert again is not first
    assert int(again.sum()) == 0


def _kernel_inputs(n, in_leak, seed):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 8, n).astype(np.uint8)
    active = rng.random(n) < 0.95
    slashed = rng.random(n) < 0.05
    eff = (rng.integers(1, 33, n) * 10**9).astype(np.int64)
    eligible = active | (slashed & (rng.random(n) < 0.5))
    ebi = 10**9
    # get_total_active_balance floors at one increment
    total = max(ebi, int(np.sum(np.where(active, eff, 0), dtype=np.uint64)))
    brpi = ebi * 64 // int(np.sqrt(total))
    weights = [14, 26, 14]
    scalars = [ebi, brpi, total // ebi, 64, int(in_leak), 2]
    return flags, active, slashed, eff, eligible, weights, scalars


@pytest.mark.parametrize("in_leak", [False, True], ids=["calm", "leak"])
@pytest.mark.parametrize("n", [1, 1000, 16_411])
def test_flag_deltas_kernel_matches_reference_jit(n, in_leak):
    flags, active, slashed, eff, eligible, weights, scalars = _kernel_inputs(
        n, in_leak, seed=n)
    want_r, want_p = ref_epoch_altair._ensure_jit()(
        jnp.asarray(flags), jnp.asarray(active), jnp.asarray(slashed),
        jnp.asarray(eff), jnp.asarray(eligible),
        jnp.asarray(weights, dtype=jnp.int64),
        jnp.asarray(scalars, dtype=jnp.int64))
    got_r, got_p = epoch_altair._flag_deltas_kernel(
        torch.from_numpy(flags), torch.from_numpy(active),
        torch.from_numpy(slashed), torch.from_numpy(eff),
        torch.from_numpy(eligible), weights, scalars)
    assert got_r.dtype == got_p.dtype == torch.int64
    assert got_r.shape == got_p.shape == (3, n)
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    if not in_leak and n > 1:
        assert got_r.numpy().any()
    if in_leak:
        assert not got_r.numpy().any()
