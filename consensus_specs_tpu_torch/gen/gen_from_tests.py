"""Reflection bridge: pytest-style spec test modules -> vector providers
(reference capability: gen_helpers/gen_from_tests/gen.py:13-132).

Discovers ``test_*`` functions in a module, invokes them in generator
mode (``generator_mode=True`` flows through the decorator DSL down to
vector_test), and wraps the yielded parts as TestCases for gen_runner.

The runners name their sources as case files of the JAX package's
``tests/spec/`` tree (``"phase0/sanity/test_slots.py"``), which
``testing.reference_cases.load`` executes, rewritten to the port, so that
the cases run on the port's specs.
"""
from __future__ import annotations

from inspect import getmembers, isfunction
from typing import Callable, Dict, Iterable, List, Union

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.testing import reference_cases

from .gen_runner import run_generator, sum_counts
from .gen_typing import TestCase, TestProvider

ALL_PRESETS = ("minimal", "mainnet")
TESTGEN_FORKS = ("phase0", "altair", "bellatrix", "capella")


def generate_from_tests(runner_name: str, handler_name: str, src,
                        fork_name: str, preset_name: str,
                        bls_active: bool = True,
                        phase: str = None) -> Iterable[TestCase]:
    fn_names = [
        name for (name, _) in getmembers(src, isfunction)
        if name.startswith("test_")
    ]
    if phase is None:
        phase = fork_name

    print(f"generating test vectors from tests source: {src.__name__}")
    for name in fn_names:
        tfn = getattr(src, name)
        case_name = name[len("test_"):] if name.startswith("test_") else name
        yield TestCase(
            fork_name=fork_name,
            preset_name=preset_name,
            runner_name=runner_name,
            handler_name=handler_name,
            suite_name="pyspec_tests",
            case_name=case_name,
            case_fn=(
                lambda tfn=tfn: tfn(
                    generator_mode=True, phase=phase, preset=preset_name,
                    bls_active=bls_active,
                )
            ),
        )


def get_provider(create_provider_fn: Callable[..., TestProvider],
                 fork_name: str, preset_name: str,
                 all_mods: Dict[str, Dict[str, Union[List[str], str]]],
                 ) -> Iterable[TestProvider]:
    for handler_name, mod_name in all_mods[fork_name].items():
        if not isinstance(mod_name, list):
            mod_name = [mod_name]
        yield create_provider_fn(
            fork_name=fork_name,
            preset_name=preset_name,
            handler_name=handler_name,
            tests_src_mod_name=mod_name,
        )


def get_create_provider_fn(runner_name: str) -> Callable[..., TestProvider]:
    def prepare_fn() -> None:
        # fastest host backend for generation, like the reference's milagro
        bls.use_fastest()

    def create_provider(fork_name: str, preset_name: str,
                        handler_name: str,
                        tests_src_mod_name: List[str]) -> TestProvider:
        def cases_fn() -> Iterable[TestCase]:
            for case_file in tests_src_mod_name:
                tests_src = reference_cases.load(case_file)
                yield from generate_from_tests(
                    runner_name=runner_name,
                    handler_name=handler_name,
                    src=tests_src,
                    fork_name=fork_name,
                    preset_name=preset_name,
                )

        return TestProvider(prepare=prepare_fn, make_cases=cases_fn)

    return create_provider


def run_state_test_generators(runner_name: str,
                              all_mods: Dict[str, Dict[str, str]],
                              presets: Iterable[str] = ALL_PRESETS,
                              forks: Iterable[str] = TESTGEN_FORKS,
                              argv=None, device=None) -> dict:
    """One ``run_generator`` a preset and fork; returns its counts summed."""
    return sum_counts(
        run_generator(runner_name, get_provider(
            create_provider_fn=get_create_provider_fn(runner_name),
            fork_name=fork_name,
            preset_name=preset_name,
            all_mods=all_mods,
        ), argv=argv, device=device)
        for preset_name in presets for fork_name in forks
        if fork_name in all_mods)


def combine_mods(dict_1: Dict, dict_2: Dict) -> Dict:
    """Merge handler->module maps; shared handlers become lists."""
    merged = {**dict_2, **dict_1}
    for key in dict_1.keys() & dict_2.keys():
        vals: List[str] = []
        for v in (dict_2[key], dict_1[key]):
            vals.extend(v if isinstance(v, list) else [v])
        merged[key] = vals
    return merged
