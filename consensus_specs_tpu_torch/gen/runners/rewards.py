"""Rewards vector generator (reference capability:
tests/generators/rewards/main.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    mods = {
        "basic": "phase0/rewards/test_basic.py",
        "leak": "phase0/rewards/test_leak.py",
        "random": "phase0/rewards/test_random.py",
    }
    altair_mods = {"basic": "altair/rewards/test_basic.py"}
    return {
        "phase0": mods,
        "altair": altair_mods,
        "bellatrix": altair_mods,
        "capella": altair_mods,
    }


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="rewards", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
