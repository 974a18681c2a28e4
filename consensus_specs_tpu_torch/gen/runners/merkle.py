"""Merkle single-proof vector generator (reference capability:
tests/generators/merkle/main.py — the 15th runner).

Emits ``<preset>/<fork>/merkle/single_proof/pyspec_tests/<case>/`` with a
``state.ssz_snappy`` part and a ``proof.yaml`` data part per
docs/formats/merkle/single_proof.md.
"""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    single_proof = {"single_proof": "altair/merkle/test_single_proof.py"}
    return {
        "altair": single_proof,
        "bellatrix": single_proof,
    }


def main(argv=None, device=None):
    return run_state_test_generators(runner_name="merkle", all_mods=handler_files(),
                              argv=argv, device=device)


if __name__ == "__main__":
    main()
