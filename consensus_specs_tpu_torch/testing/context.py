"""Test decorator DSL (reference: test/context.py).

Same surface as the reference: tests declare forks/presets/BLS behavior
via decorators; the context resolves spec modules from the builder and
feeds cached genesis states in as ``state``.  States are cached as
immutable backings and re-wrapped per test — O(1) snapshot/restore
(reference: context.py:105-125).

The specs are built for one device, the context's: ``set_spec_device``
sets it and returns the one before.  Its default is the CUDA card, as at
every entry point of the port; the CPU tests ask for ``"cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from random import Random
from typing import Any, Callable, Sequence

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs import available_forks, get_spec
from consensus_specs_tpu_torch.specs.builder import LRUDict, build_spec

from .exceptions import SkippedTest
from .helpers.constants import (
    ALL_FORK_UPGRADES,
    ALL_PHASES,
    FORKS_BEFORE_ALTAIR,
    FORKS_BEFORE_BELLATRIX,
    FORKS_BEFORE_CAPELLA,
    MAINNET,
    MINIMAL,
)
from .helpers.genesis import create_genesis_state
from .utils import vector_test, with_meta_tags

# Defaults; mutated by tests/conftest.py from CLI flags (reference:
# test/conftest.py:30-93).  Only forks with a built spec source run.
DEFAULT_TEST_PRESET = MINIMAL
DEFAULT_PYTEST_FORKS = tuple(f for f in ALL_PHASES if f in available_forks())
DEFAULT_BLS_ACTIVE = True

# the device the context builds its specs for (None: the CUDA card)
_spec_device = None

is_pytest = True


@dataclass(frozen=True)
class ForkMeta:
    pre_fork_name: str
    post_fork_name: str
    fork_epoch: int


class _SpecTargets:
    """Lazy {preset: {fork: spec-module}} mapping (reference builds all
    eight eagerly, context.py:73-86; lazy keeps test startup fast)."""

    def __init__(self):
        self._presets = {MINIMAL, MAINNET}

    def __getitem__(self, preset_name):
        assert preset_name in self._presets
        return _ForkTargets(preset_name)


class _ForkTargets:
    def __init__(self, preset_name):
        self.preset_name = preset_name

    def __getitem__(self, fork):
        return get_spec(fork, self.preset_name, _spec_device)


spec_targets = _SpecTargets()


def set_spec_device(device):
    """Build the context's specs for ``device`` (None: the CUDA card);
    returns the device set before."""
    global _spec_device
    previous, _spec_device = _spec_device, device
    return previous


def spec_device():
    """The device the context builds its specs for (None: the CUDA card)."""
    return _spec_device


def dump_skipping_message(reason: str) -> None:
    message = f"[Skipped test] {reason}"
    if is_pytest:
        import pytest

        pytest.skip(message)
    else:
        raise SkippedTest(message)


# ---------------------------------------------------------------------------
# State factories
# ---------------------------------------------------------------------------


def default_activation_threshold(spec):
    return spec.MAX_EFFECTIVE_BALANCE


def zero_activation_threshold(spec):
    return 0


def default_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def scaled_churn_balances(spec):
    num_validators = spec.config.CHURN_LIMIT_QUOTIENT * (2 + spec.config.MIN_PER_EPOCH_CHURN_LIMIT)
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def low_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    low_balance = 18 * 10**9
    return [low_balance] * num_validators


def misc_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    balances = [spec.MAX_EFFECTIVE_BALANCE * 2 * i // num_validators for i in range(num_validators)]
    rng = Random(1234)
    rng.shuffle(balances)
    return balances


def misc_balances_in_default_range_with_many_validators(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8 * 2
    floor = spec.config.EJECTION_BALANCE + spec.EFFECTIVE_BALANCE_INCREMENT
    balances = [
        max(spec.MAX_EFFECTIVE_BALANCE * 2 * i // num_validators, floor) for i in range(num_validators)
    ]
    rng = Random(1234)
    rng.shuffle(balances)
    return balances


def low_single_balance(spec):
    return [1]


def large_validator_set(spec):
    num_validators = 2 * spec.SLOTS_PER_EPOCH * spec.MAX_COMMITTEES_PER_SLOT * spec.TARGET_COMMITTEE_SIZE
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


_custom_state_cache = LRUDict(10)


def with_custom_state(balances_fn: Callable[[Any], Sequence[int]],
                      threshold_fn: Callable[[Any], int]):
    def deco(fn):
        def entry(*args, spec, phases, **kw):
            # key on config *content* so override-specs don't collide or
            # miss (object ids are recyclable)
            cfg_key = tuple(sorted(
                (k, bytes(v) if isinstance(v, bytes) else v)
                for k, v in spec.config.to_dict().items()
            ))
            key = (spec.fork, spec.preset_name, str(spec.device), cfg_key,
                   balances_fn, threshold_fn)
            if key not in _custom_state_cache:
                state = create_genesis_state(
                    spec=spec,
                    validator_balances=balances_fn(spec),
                    activation_threshold=threshold_fn(spec),
                )
                _custom_state_cache[key] = state.get_backing()
            # re-wrap the immutable backing — zero-copy snapshot
            state = spec.BeaconState.view_from_backing(_custom_state_cache[key])
            kw["state"] = state
            return fn(*args, spec=spec, phases=phases, **kw)

        return entry

    return deco


with_state = with_custom_state(default_balances, default_activation_threshold)


def single_phase(fn):
    """Drop the multi-fork ``phases`` mapping for single-fork tests."""

    def entry(*args, **kw):
        kw.pop("phases", None)
        return fn(*args, **kw)

    return entry


# ---------------------------------------------------------------------------
# BLS switching
# ---------------------------------------------------------------------------


def bls_switch(fn):
    def entry(*args, **kw):
        old_state = bls.bls_active
        bls.bls_active = kw.pop("bls_active", DEFAULT_BLS_ACTIVE)
        res = fn(*args, **kw)
        if res is not None:
            yield from res
        bls.bls_active = old_state

    return entry


def never_bls(fn):
    def entry(*args, **kw):
        kw["bls_active"] = False
        return bls_switch(fn)(*args, **kw)

    return with_meta_tags({"bls_setting": 2})(entry)


def always_bls(fn):
    def entry(*args, **kw):
        kw["bls_active"] = True
        return bls_switch(fn)(*args, **kw)

    return with_meta_tags({"bls_setting": 1})(entry)


# ---------------------------------------------------------------------------
# Core composition
# ---------------------------------------------------------------------------


def spec_test(fn):
    # vector_test must wrap bls_switch so yielded data is fully drained
    # before the BLS flag is restored
    return vector_test()(bls_switch(fn))


def spec_state_test(fn):
    return spec_test(with_state(single_phase(fn)))


def spec_configured_state_test(conf):
    overrides = with_config_overrides(conf)

    def decorator(fn):
        return spec_test(overrides(with_state(single_phase(fn))))

    return decorator


def expect_assertion_error(fn):
    bad = False
    try:
        fn()
        bad = True
    except AssertionError:
        pass
    except IndexError:
        # The spec isn't explicit on bounds checks; an IndexError counts
        # as a failed assert (reference: context.py:280-291)
        pass
    except ValueError:
        # Our checked uintN arithmetic raises ValueError on overflow /
        # underflow — spec rule: uint64 overflow makes a transition
        # invalid (beacon-chain.md:1238)
        pass
    if bad:
        raise AssertionError("expected an assertion error, but got none.")


# ---------------------------------------------------------------------------
# Fork / preset selection
# ---------------------------------------------------------------------------


def _get_run_phases(phases, kw):
    if "phase" in kw:
        phase = kw.pop("phase")
        if phase not in phases:
            dump_skipping_message(f"doesn't support this fork: {phase}")
            return None
        return [phase]
    return set(phases).intersection(DEFAULT_PYTEST_FORKS)


def _run_test_case_with_phases(fn, phases, other_phases, kw, args, is_fork_transition=False):
    run_phases = _get_run_phases(phases, kw)
    if run_phases is None or len(run_phases) == 0:
        if not is_fork_transition:
            dump_skipping_message("none of the recognized phases are executable, skipping test.")
        return None

    available_phases = set(run_phases)
    if other_phases is not None:
        available_phases |= set(other_phases)

    preset_name = kw.pop("preset", DEFAULT_TEST_PRESET)
    targets = spec_targets[preset_name]
    phase_dir = {phase: targets[phase] for phase in available_phases}

    ret = None
    for phase in run_phases:
        ret = fn(spec=targets[phase], phases=phase_dir, *args, **kw)
    return ret


def with_phases(phases, other_phases=None):
    def decorator(fn):
        def wrapper(*args, **kw):
            if "fork_metas" in kw:
                fork_metas = kw.pop("fork_metas")
                if "phase" in kw:
                    phase = kw["phase"]
                    _phases = [phase]
                    _other_phases = [ALL_FORK_UPGRADES[phase]]
                    ret = _run_test_case_with_phases(
                        fn, _phases, _other_phases, kw, args, is_fork_transition=True)
                else:
                    for fork_meta in fork_metas:
                        _phases = [fork_meta.pre_fork_name]
                        _other_phases = [fork_meta.post_fork_name]
                        ret = _run_test_case_with_phases(
                            fn, _phases, _other_phases, kw, args, is_fork_transition=True)
            else:
                ret = _run_test_case_with_phases(fn, phases, other_phases, kw, args)
            return ret

        return wrapper

    return decorator


def with_all_phases(fn):
    return with_phases(ALL_PHASES)(fn)


def with_all_phases_except(exclusion_phases):
    def decorator(fn):
        return with_phases([p for p in ALL_PHASES if p not in exclusion_phases])(fn)

    return decorator


with_altair_and_later = with_all_phases_except([ "phase0" ])
with_bellatrix_and_later = with_all_phases_except(["phase0", "altair"])
with_capella_and_later = with_all_phases_except(["phase0", "altair", "bellatrix"])


def with_presets(preset_bases, reason=None):
    available_presets = set(preset_bases)

    def decorator(fn):
        def wrapper(*args, spec, **kw):
            if spec.config.PRESET_BASE not in available_presets:
                message = f"doesn't support this preset base: {spec.config.PRESET_BASE}."
                if reason is not None:
                    message = f"{message} Reason: {reason}"
                dump_skipping_message(message)
                return None
            return fn(*args, spec=spec, **kw)

        return wrapper

    return decorator


def with_config_overrides(config_overrides):
    """Run the test against a fresh spec copy with config fields
    overridden; yields the effective config for vector output
    (reference: context.py:502-534)."""

    def decorator(fn):
        def wrapper(*args, spec, **kw):
            new_config = spec.config.replace(**{
                k: type(getattr(spec.config, k))(v) for k, v in config_overrides.items()
            })
            spec = build_spec(spec.fork, spec.preset_name, spec.device,
                              config=new_config)

            output_config = {
                k: (int(v) if isinstance(v, int) else ("0x" + bytes(v).hex()) if isinstance(v, bytes) else str(v))
                for k, v in new_config.to_dict().items()
            }
            yield "config", "data", output_config

            out = fn(*args, spec=spec, **kw)
            if out is not None:
                yield from out

        return wrapper

    return decorator


def is_post_altair(spec):
    return spec.fork not in FORKS_BEFORE_ALTAIR


def is_post_bellatrix(spec):
    return spec.fork not in FORKS_BEFORE_BELLATRIX


def is_post_capella(spec):
    return spec.fork not in FORKS_BEFORE_CAPELLA


def only_generator(reason):
    def _decorator(inner):
        def _wrapper(*args, **kwargs):
            if is_pytest:
                dump_skipping_message(reason)
                return None
            return inner(*args, **kwargs)

        return _wrapper

    return _decorator


# ---------------------------------------------------------------------------
# Fork transition tests (reference: context.py:570-662)
# ---------------------------------------------------------------------------


def set_fork_metas(fork_metas: Sequence[ForkMeta]):
    def decorator(fn):
        def wrapper(*args, **kwargs):
            return fn(*args, fork_metas=fork_metas, **kwargs)

        return wrapper

    return decorator


def with_fork_metas(fork_metas: Sequence[ForkMeta]):
    """Construct a "transition" test from one fork to the next; the test
    receives spec, post_spec, pre_tag/post_tag and fork_epoch."""
    run_yield_fork_meta = yield_fork_meta(fork_metas)
    run_with_phases = with_phases(ALL_PHASES)
    run_set_fork_metas = set_fork_metas(fork_metas)

    def decorator(fn):
        return run_set_fork_metas(run_with_phases(spec_test(with_state(run_yield_fork_meta(fn)))))

    return decorator


def yield_fork_meta(fork_metas: Sequence[ForkMeta]):
    def decorator(fn):
        def wrapper(*args, **kw):
            phases = kw.pop("phases")
            spec = kw["spec"]
            try:
                fork_meta = next(filter(lambda m: m.pre_fork_name == spec.fork, fork_metas))
            except StopIteration:
                dump_skipping_message(f"doesn't support this fork: {spec.fork}")
                return

            post_spec = phases[fork_meta.post_fork_name]

            pre_fork_counter = 0

            def pre_tag(obj):
                nonlocal pre_fork_counter
                pre_fork_counter += 1
                return obj

            def post_tag(obj):
                return obj

            yield "post_fork", "meta", fork_meta.post_fork_name

            has_fork_epoch = False
            if fork_meta.fork_epoch:
                kw["fork_epoch"] = fork_meta.fork_epoch
                has_fork_epoch = True
                yield "fork_epoch", "meta", fork_meta.fork_epoch

            result = fn(*args, post_spec=post_spec, pre_tag=pre_tag, post_tag=post_tag, **kw)
            if result is not None:
                for part in result:
                    if part[0] == "fork_epoch":
                        has_fork_epoch = True
                    yield part
            assert has_fork_epoch

            if pre_fork_counter > 0:
                yield "fork_block", "meta", pre_fork_counter - 1

        return wrapper

    return decorator
