"""Finality vector generator (reference capability:
tests/generators/finality/main.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    # the finality suite is phase0-scoped (later forks change the
    # attestation flow); registering other forks would emit empty suites
    mods = {"finality": "phase0/test_finality.py"}
    return {"phase0": mods}


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="finality", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
