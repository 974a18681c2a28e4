"""Cross-fork transition vector generator (reference capability:
tests/generators/transition/main.py): scenarios straddling a fork
boundary, tests run under the pre-fork spec with the post fork in
phases."""
from __future__ import annotations

from consensus_specs_tpu_torch.gen import gen_runner
from consensus_specs_tpu_torch.gen.runners.forks import make_cross_fork_provider


def main(argv=None, device=None):
    from consensus_specs_tpu_torch.testing.helpers.constants import ALL_PRE_POST_FORKS

    # Reference taxonomy (tests/generators/transition/main.py): EVERY
    # module emits under handler "core", for every pre/post fork pair.
    modules = (
        "altair/test_transition.py",
        "altair/transition/test_activations_and_exits.py",
        "altair/transition/test_leaking.py",
        "altair/transition/test_operations.py",
        "altair/transition/test_slashing.py",
    )
    providers = [
        make_cross_fork_provider(
            mod, preset, pre_fork, post_fork,
            runner_name="transition", handler_name="core")
        for preset in ("minimal", "mainnet")
        for mod in modules
        for pre_fork, post_fork in ALL_PRE_POST_FORKS
    ]
    return gen_runner.run_generator("transition", providers, argv=argv, device=device)


if __name__ == "__main__":
    main()
