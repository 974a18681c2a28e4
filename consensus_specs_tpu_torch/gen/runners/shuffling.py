"""Shuffling vector generator (reference capability:
tests/generators/shuffling/main.py): 30 seeds x 10 counts of the full
swap-or-not mapping, minimal + mainnet round counts.

The mapping is produced by the vectorized whole-permutation kernel
(ops/shuffle.py) — itself differentially pinned to compute_shuffled_index
— so generation at count=9999 is instant.
"""
from __future__ import annotations

from typing import Iterable

from consensus_specs_tpu_torch.gen import gen_runner, gen_typing
from consensus_specs_tpu_torch.ops.shuffle import compute_shuffle_permutation
from consensus_specs_tpu_torch.testing.context import spec_targets

COUNTS = (0, 1, 2, 3, 5, 10, 33, 100, 1000, 9999)


def shuffling_case_fn(spec, seed: bytes, count: int):
    perm = compute_shuffle_permutation(seed, count, int(spec.SHUFFLE_ROUND_COUNT))
    yield "mapping", "data", {
        "seed": "0x" + seed.hex(),
        "count": count,
        "mapping": [int(x) for x in perm],
    }


def create_provider(preset_name: str) -> gen_typing.TestProvider:
    def cases_fn() -> Iterable[gen_typing.TestCase]:
        spec = spec_targets[preset_name]["phase0"]
        for seed_init in range(30):
            seed = spec.hash(seed_init.to_bytes(4, "little"))
            for count in COUNTS:
                yield gen_typing.TestCase(
                    fork_name="phase0",
                    preset_name=preset_name,
                    runner_name="shuffling",
                    handler_name="core",
                    suite_name="shuffle",
                    case_name=f"shuffle_0x{seed.hex()}_{count}",
                    case_fn=(
                        lambda spec=spec, seed=bytes(seed), count=count:
                        shuffling_case_fn(spec, seed, count)
                    ),
                )

    return gen_typing.TestProvider(prepare=lambda: None, make_cases=cases_fn)


def main(argv=None, device=None):
    return gen_runner.run_generator(
        "shuffling", [create_provider("minimal"), create_provider("mainnet")],
        argv=argv, device=device,
    )


if __name__ == "__main__":
    main()
