"""Operations vector generator (reference capability:
tests/generators/operations/main.py): per-operation block-processing
handlers across forks, generated from the pytest-mode test modules.
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
        key: "phase0/block_processing/test_process_" + key + ".py"
        for key in (
            "attestation",
            "attester_slashing",
            "block_header",
            "deposit",
            "proposer_slashing",
            "voluntary_exit",
        )
    }
    _new_altair_mods = {
        "sync_aggregate": [
            "altair/test_sync_aggregate.py",
            "altair/test_sync_aggregate_random.py",
        ],
    }
    altair_mods = combine_mods(_new_altair_mods, phase_0_mods)
    _new_bellatrix_mods = {
        "execution_payload": "bellatrix/test_process_execution_payload.py",
    }
    bellatrix_mods = combine_mods(_new_bellatrix_mods, altair_mods)
    _new_capella_mods = {
        "withdrawals": "capella/test_withdrawals.py",
        "bls_to_execution_change": "capella/test_bls_to_execution_change.py",
    }
    capella_mods = combine_mods(_new_capella_mods, bellatrix_mods)

    return {
        "phase0": phase_0_mods,
        "altair": altair_mods,
        "bellatrix": bellatrix_mods,
        "capella": capella_mods,
    }


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="operations", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
