"""Fork-choice vector generator (reference capability:
tests/generators/fork_choice/main.py): step-scripted tick/block/
attestation/attester_slashing scenarios with store checks, generated
from the fork-choice test module across forks."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen.gen_from_tests import run_state_test_generators


def handler_files():
    """Each fork's handlers and the case files, relative to the JAX
    package's ``tests/spec/``, that their cases come from."""
    # reference handler taxonomy (tests/generators/fork_choice/main.py):
    # get_head / on_block / ex_ante, plus on_merge_block from bellatrix
    mods = {
        "get_head": ["phase0/test_fork_choice.py",
                     "phase0/fork_choice/test_get_head.py"],
        "ex_ante": "phase0/fork_choice/test_ex_ante.py",
        "on_block": "phase0/fork_choice/test_on_block.py",
    }
    return {
        "phase0": mods,
        "altair": mods,
        "bellatrix": {**mods,
                      "on_merge_block":
                          "bellatrix/fork_choice/test_on_merge_block.py"},
        "capella": mods,
    }


def main(argv=None, device=None):
    return run_state_test_generators(
        runner_name="fork_choice", all_mods=handler_files(), argv=argv, device=device)


if __name__ == "__main__":
    main()
