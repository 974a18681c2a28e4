"""Sanity vector generator (reference capability:
tests/generators/sanity/main.py): blocks + slots handlers across all
forks, generated from the pytest-mode test modules via reflection.
"""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import (
    combine_mods,
    run_state_test_generators,
)


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    phase_0_mods = {
        "blocks": "phase0/sanity/test_blocks.py",
        "slots": "phase0/sanity/test_slots.py",
    }
    altair_mods = combine_mods(
        {"blocks": "altair/sanity/test_blocks.py"}, phase_0_mods)
    bellatrix_mods = combine_mods(
        {"blocks": "bellatrix/sanity/test_blocks.py"}, altair_mods)
    return {
        "phase0": phase_0_mods,
        "altair": altair_mods,
        "bellatrix": bellatrix_mods,
        "capella": bellatrix_mods,
    }


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="sanity", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
