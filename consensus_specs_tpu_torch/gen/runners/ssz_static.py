"""ssz_static vector generator: every container type of every fork/preset,
fuzzed across all six randomization modes (reference capability:
tests/generators/ssz_static/main.py).

Per case: value.yaml (encoded), serialized.ssz_snappy, roots.yaml.
"""
from __future__ import annotations

from inspect import getmembers, isclass
from random import Random
from typing import Iterable

from consensus_specs_tpu_torch.debug import random_value
from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.gen import gen_runner, gen_typing
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch.ssz.types import Container
from consensus_specs_tpu_torch.testing.context import spec_targets

MAX_BYTES_LENGTH = 1000
MAX_LIST_LENGTH = 10

TESTGEN_FORKS = ("phase0", "altair", "bellatrix", "capella")


def create_test_case(rng: Random, typ, mode, chaos: bool):
    value = random_value.get_random_ssz_object(
        rng, typ, MAX_BYTES_LENGTH, MAX_LIST_LENGTH, mode, chaos
    )
    yield "value", "data", encode(value)
    yield "serialized", "ssz", serialize(value)
    yield "roots", "data", {"root": "0x" + hash_tree_root(value).hex()}


def get_spec_ssz_types(spec):
    return [
        (name, value) for (name, value) in getmembers(spec, isclass)
        if issubclass(value, Container) and value is not Container
    ]


def ssz_static_cases(fork_name, preset_name, seed, name, ssz_type, mode,
                     chaos, count) -> Iterable[gen_typing.TestCase]:
    random_mode_name = mode.to_name()
    rng = Random(seed)
    for i in range(count):
        yield gen_typing.TestCase(
            fork_name=fork_name,
            preset_name=preset_name,
            runner_name="ssz_static",
            handler_name=name,
            suite_name=f"ssz_{random_mode_name}{'_chaos' if chaos else ''}",
            case_name=f"case_{i}",
            case_fn=lambda: create_test_case(rng, ssz_type, mode, chaos),
        )


def create_provider(fork_name, preset_name, seed, mode, chaos,
                    cases_if_random) -> gen_typing.TestProvider:
    def cases_fn() -> Iterable[gen_typing.TestCase]:
        count = cases_if_random if chaos or mode.is_changing() else 1
        spec = spec_targets[preset_name][fork_name]
        for i, (name, ssz_type) in enumerate(get_spec_ssz_types(spec)):
            yield from ssz_static_cases(
                fork_name, preset_name, seed * 1000 + i, name, ssz_type,
                mode, chaos, count,
            )

    return gen_typing.TestProvider(prepare=lambda: None, make_cases=cases_fn)


def settings():
    """(seed, preset, mode, chaos, cases a type if random) of each
    provider: every mode and chaos at minimal, then ``mode_random`` at
    mainnet, 5 cases a type."""
    out = []
    seed = 1
    mode_random = random_value.RandomizationMode.mode_random
    for mode in random_value.RandomizationMode:
        out.append((seed, "minimal", mode, False, 30))
        seed += 1
    out.append((seed, "minimal", mode_random, True, 30))
    seed += 1
    out.append((seed, "mainnet", mode_random, False, 5))
    return out


def main(argv=None, device=None):
    return gen_runner.sum_counts(gen_runner.run_generator("ssz_static", [
        create_provider(fork, preset_name, seed, mode, chaos, cases_if_random)
        for (seed, preset_name, mode, chaos, cases_if_random) in settings()
    ], argv=argv, device=device) for fork in TESTGEN_FORKS)

if __name__ == "__main__":
    main()
