"""Epoch-processing vector generator (reference capability:
tests/generators/epoch_processing/main.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import (
    combine_mods,
    run_state_test_generators,
)


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    phase_0_mods = {
        key: "phase0/epoch_processing/test_process_" + key + ".py"
        for key in (
            "justification_and_finalization",
            "registry_updates",
            "slashings",
            "effective_balance_updates",
        )
    }
    phase_0_mods["resets_and_rotations"] = (
        "phase0/epoch_processing/test_resets_and_rotations.py"
    )
    _new_altair_mods = {
        "inactivity_updates": (
            "altair/epoch_processing/test_process_inactivity_updates.py"
        ),
        "participation_flag_updates": (
            "altair/epoch_processing/test_participation_and_sync_committee_updates.py"
        ),
    }
    altair_mods = combine_mods(_new_altair_mods, phase_0_mods)
    _new_capella_mods = {
        "full_withdrawals": (
            "capella/epoch_processing/test_process_full_withdrawals.py"
        ),
    }
    capella_mods = combine_mods(_new_capella_mods, altair_mods)
    return {
        "phase0": phase_0_mods,
        "altair": altair_mods,
        "bellatrix": altair_mods,
        "capella": capella_mods,
    }


def main(argv=None, device=None):
    return run_state_test_generators(
        runner_name="epoch_processing", all_mods=handler_files(), argv=argv,
        device=device,
    )


if __name__ == "__main__":
    main()
