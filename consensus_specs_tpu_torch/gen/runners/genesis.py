"""Genesis vector generator (reference capability:
tests/generators/genesis/main.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    mods = {
        "initialization": "phase0/genesis/test_initialization.py",
        "validity": "phase0/genesis/test_validity.py",
    }
    bellatrix_mods = {
        "initialization": "bellatrix/genesis/test_initialization.py",
    }
    return {"phase0": mods, "bellatrix": bellatrix_mods}


def main(argv=None, device=None):
    # mainnet genesis = MIN_GENESIS_ACTIVE_VALIDATOR_COUNT (16384) deposit
    # signature verifications per case; the reference likewise excludes
    # mainnet generation from CI (tests/generators/README.md)
    return run_state_test_generators(
        runner_name="genesis", all_mods=handler_files(), presets=("minimal",),
        argv=argv, device=device,
    )


if __name__ == "__main__":
    main()
