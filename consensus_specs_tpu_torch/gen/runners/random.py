"""Randomized-scenario vector generator (reference capability:
tests/generators/random/main.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    return {
        "phase0": {"random": "phase0/random/test_random.py"},
        "altair": {"random": "altair/random/test_random.py"},
        "bellatrix": {"random": "bellatrix/random/test_random.py"},
        "capella": {"random": "capella/random/test_random.py"},
    }


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="random", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
