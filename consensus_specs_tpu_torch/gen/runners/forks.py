"""Fork-upgrade vector generator (reference capability:
tests/generators/forks/main.py): upgrade_to_<fork> transition cases;
tests run against the PRE-fork spec with the post-fork spec in phases.
"""
from __future__ import annotations

from typing import Iterable

from consensus_specs_tpu_torch.gen import gen_runner
from consensus_specs_tpu_torch.gen.gen_from_tests import generate_from_tests
from consensus_specs_tpu_torch.gen.gen_typing import TestProvider
from consensus_specs_tpu_torch.testing import reference_cases


def make_cross_fork_provider(tests_src_mod_name: str, preset_name: str,
                             pre_fork: str, post_fork: str,
                             runner_name: str = "fork",
                             handler_name: str = "fork") -> TestProvider:
    """Provider over a module whose tests run pre-fork with the post fork
    in phases (shared by the forks and transition runners)."""
    def cases_fn() -> Iterable:
        tests_src = reference_cases.load(tests_src_mod_name)
        yield from generate_from_tests(
            runner_name=runner_name,
            handler_name=handler_name,
            src=tests_src,
            fork_name=post_fork,
            preset_name=preset_name,
            phase=pre_fork,
        )

    return TestProvider(prepare=lambda: None, make_cases=cases_fn)


_create_provider = make_cross_fork_provider


def main(argv=None, device=None):
    specs = [
        ("altair/test_fork.py", "phase0", "altair"),
        ("bellatrix/test_fork.py", "altair", "bellatrix"),
        ("capella/test_fork.py", "bellatrix", "capella"),
    ]
    providers = [
        _create_provider(mod, preset, pre, post)
        for (mod, pre, post) in specs
        for preset in ("minimal", "mainnet")
    ]
    return gen_runner.run_generator("forks", providers, argv=argv, device=device)


if __name__ == "__main__":
    main()
