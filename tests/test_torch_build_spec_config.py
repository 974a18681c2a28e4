"""The port's ``build_spec(..., config=)`` against the reference's.

A config override builds a fresh spec whose intermediate forks carry the
same config; its ``process_epoch`` must give the reference's post-state
under the same override:

* minimal preset, phase0, altair and bellatrix: a genesis state of the
  reference's testing helpers with a queue of validators eligible for
  activation and a few below the ejection balance, under a churn limit
  and an ejection balance that both differ from the default;
* mainnet preset at 16,384 validators, the same three forks: the port's
  main-path state with a seeded activation queue appended, under a churn
  quotient that lets more of the queue in than the default;
* every override epoch also differs from the default-config epoch, so
  the override took effect.

And the build's bookkeeping: an override build leaves the cached spec in
``sys.modules`` and usable, and ``name=`` names the module.
"""
import sys

import numpy as np
import pytest

import bench
from consensus_specs_tpu.specs.builder import build_spec as ref_build_spec
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu_torch import scenario
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.specs.builder import build_spec

FORKS = ("phase0", "altair", "bellatrix")
FAR_FUTURE = 2**64 - 1


def _override(spec, **overrides):
    """``spec.config`` with ``overrides``, typed as the fields they replace
    (as ``with_config_overrides`` types them)."""
    return spec.config.replace(**{k: type(getattr(spec.config, k))(v)
                                  for k, v in overrides.items()})


def _to(spec, state):
    return spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))


def _epoch_root(spec, state) -> bytes:
    state = _to(spec, state)
    spec.process_epoch(state)
    return bytes(state.hash_tree_root())


def _minimal_pre_state(fork):
    """A reference genesis state a few epochs on, with a queue of 24
    validators eligible for activation and 3 below 20 ETH."""
    ref_spec = ref_get_spec(fork, "minimal")
    state = create_genesis_state(ref_spec, default_balances(ref_spec),
                                 default_activation_threshold(ref_spec))
    state.slot = 4 * int(ref_spec.SLOTS_PER_EPOCH) - 1
    for i in range(24):
        v = state.validators[i]
        v.activation_eligibility_epoch = 0
        v.activation_epoch = FAR_FUTURE
    for i in (40, 41, 42):
        state.validators[i].effective_balance = 18 * 10**9
    return state


@pytest.mark.parametrize("fork", FORKS)
def test_minimal_override_epoch_matches_reference(fork):
    overrides = {"CHURN_LIMIT_QUOTIENT": 8, "EJECTION_BALANCE": 20 * 10**9}
    pre = _minimal_pre_state(fork)
    ref_default = ref_get_spec(fork, "minimal")
    ref_spec = ref_build_spec(fork, "minimal",
                              config=_override(ref_default, **overrides))
    default = get_spec(fork, "minimal", device="cpu")
    spec = build_spec(fork, "minimal", device="cpu",
                      config=_override(default, **overrides))

    root = _epoch_root(spec, pre)
    assert root == _epoch_root(ref_spec, pre)
    assert root != _epoch_root(default, pre)
    # the intermediate forks were built with the override, not cached
    if fork != "phase0":
        assert spec.phase0 is not get_spec("phase0", "minimal", device="cpu")
        assert int(spec.phase0.config.CHURN_LIMIT_QUOTIENT) == 8


def _mainnet_pre_state(spec, build_state, n: int, queue: int, seed: int):
    """The main-path state at ``n`` validators (``build_state``: the
    port's or the reference's builder, which give the same bytes) with
    ``queue`` validators appended, eligible for activation at seeded
    epochs 0 or 1 (the finalized epoch is 0, so about half of them
    qualify)."""
    state = build_state(spec, n)
    rng = np.random.default_rng(seed)
    eligible = rng.integers(0, 2, queue)
    keys = rng.integers(0, 256, (queue, 48), dtype=np.uint8)
    lineage = hasattr(state, "inactivity_scores")
    for i in range(queue):
        state.validators.append(spec.Validator(
            pubkey=bytes(keys[i]),
            effective_balance=spec.MAX_EFFECTIVE_BALANCE,
            activation_eligibility_epoch=int(eligible[i]),
            activation_epoch=FAR_FUTURE,
            exit_epoch=FAR_FUTURE,
            withdrawable_epoch=FAR_FUTURE))
        state.balances.append(spec.MAX_EFFECTIVE_BALANCE)
        if lineage:
            state.previous_epoch_participation.append(0)
            state.current_epoch_participation.append(0)
            state.inactivity_scores.append(0)
    return state


@pytest.mark.parametrize("fork", FORKS)
def test_mainnet_override_epoch_at_16384_matches_reference(fork):
    default = get_spec(fork, "mainnet", device="cpu")
    spec = build_spec(fork, "mainnet", device="cpu",
                      config=_override(default, CHURN_LIMIT_QUOTIENT=1024))
    ref_default = ref_get_spec(fork, "mainnet")
    ref_spec = ref_build_spec(fork, "mainnet", config=_override(
        ref_default, CHURN_LIMIT_QUOTIENT=1024))
    # each package builds the same pre-state (a serialize round trip of
    # 16,384 validators costs seconds); the port's two specs share one
    pre = _mainnet_pre_state(default, scenario.build_state, 16384, 64, seed=0)
    ref_pre = _mainnet_pre_state(ref_default, bench.build_state, 16384, 64, seed=0)
    assert bytes(pre.hash_tree_root()) == bytes(ref_pre.hash_tree_root())

    roots = []
    for s, state in ((spec, pre.copy()), (ref_spec, ref_pre), (default, pre)):
        s.process_epoch(state)
        roots.append(bytes(state.hash_tree_root()))
    assert roots[0] == roots[1]
    assert roots[0] != roots[2]


def test_override_build_keeps_the_cached_spec():
    cached = get_spec("phase0", "minimal", device="cpu")
    override = build_spec("phase0", "minimal", device="cpu",
                          config=_override(cached, EJECTION_BALANCE=20 * 10**9))
    assert override is not cached
    assert override.__name__ != cached.__name__
    assert sys.modules[cached.__name__] is cached
    assert sys.modules[override.__name__] is override
    assert get_spec("phase0", "minimal", device="cpu") is cached
    assert int(cached.config.EJECTION_BALANCE) == 16 * 10**9
    assert int(override.config.EJECTION_BALANCE) == 20 * 10**9
    # the cached spec still runs
    state = cached.BeaconState()
    cached.process_slots(state, 1)
    assert int(state.slot) == 1


def test_name_is_honoured():
    name = "consensus_specs_tpu_torch.specs.named_for_a_test"
    spec = build_spec("altair", "minimal", device="cpu", name=name)
    assert spec.__name__ == name
    assert sys.modules[name] is spec
    assert spec.BeaconState.__module__ == name
