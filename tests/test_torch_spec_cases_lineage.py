"""The JAX package's altair, bellatrix and capella spec cases on port-built
specs.

The counterpart of ``tests/test_torch_spec_cases_phase0.py`` for the case
directories of the altair lineage (``tests/spec/altair/``, ``bellatrix/``,
``capella/``), through the same loader and context: tier-1 runs the files
of ``reference_cases.TIER1`` on CPU-built specs, every other loadable case
is ``slow``, each case has a ``cuda`` variant that skips without a card.

``EXCLUDED`` names each lineage file the loader cannot resolve, and the
case directories of the forks the port does not build yet
(``custody_game``, ``sharding``, ``experimental``: A18), with what each
waits for; a test holds the table to exactly that set.
"""
import pytest

from consensus_specs_tpu_torch.testing import reference_cases
from tests.torch_spec_cases import (  # noqa: F401
    DEVICES,
    case_context,
    params,
    unloadable_tier1,
    unresolved_files,
)

FORKS = ("altair", "bellatrix", "capella")
UNBUILT = ("custody_game", "sharding", "experimental")

_A18 = "the research forks, specs/src/{} (A18)"

EXCLUDED = {
    "altair/sanity/test_stf_engine_differential.py":
        "the reference's bench.py and tests/chaos corpus, through phase0's "
        "engine differential",
    "altair/test_attestation_kernel.py":
        "pytest-native: a module fixture over the reference spec builder's "
        "participation scope",
    "custody_game/test_block_processing.py": _A18.format("custody_game.py"),
    "custody_game/test_chunk_challenge_matrix.py": _A18.format("custody_game.py"),
    "custody_game/test_epoch_processing.py": _A18.format("custody_game.py"),
    "custody_game/test_sanity_blocks.py": _A18.format("custody_game.py"),
    "experimental/test_experimental_forks.py":
        _A18.format("eip4844.py, sharding.py, das.py and custody_game.py"),
    "sharding/test_shard_header_sanity.py": _A18.format("sharding.py"),
    "sharding/test_shard_work_lifecycle.py": _A18.format("sharding.py"),
    "sharding/test_start_shard.py": _A18.format("sharding.py"),
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("relpath,name", params(FORKS))
def test_reference_case(case_context, relpath, name):
    reference_cases.cases(relpath)[name]()


def test_excluded_is_what_the_loader_cannot_resolve():
    cannot = unresolved_files(FORKS + UNBUILT)
    assert set(cannot) == set(EXCLUDED), cannot
    # every case directory is either a fork the port builds or listed here
    tops = {f.split("/")[0] for f in reference_cases.case_files()}
    assert tops == {"phase0", *FORKS, *UNBUILT}


def test_tier1_subset_is_loadable():
    assert unloadable_tier1(FORKS) == []
