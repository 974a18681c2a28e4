"""The JAX package's altair, bellatrix and capella spec cases, and those of
the research forks, on port-built specs.

The counterpart of ``tests/test_torch_spec_cases_phase0.py`` for the case
directories of the altair lineage (``tests/spec/altair/``, ``bellatrix/``,
``capella/``) and of the research forks (``custody_game/``, ``sharding/``,
``experimental/``, whose file also runs eip4844 and das), through the
same loader and context: tier-1 runs the files of
``reference_cases.TIER1`` on CPU-built specs, every other loadable case is
``slow``, each case has a ``cuda`` variant that skips without a card.
The research forks' files take plain pytest fixtures, which the loader
supplies (their own, their autouse ones and ``custody_game/conftest.py``).

``EXCLUDED`` names each file the loader cannot resolve, with what each
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

FORKS = ("altair", "bellatrix", "capella", *reference_cases.RESEARCH_DIRECTORIES)

EXCLUDED = {
    "altair/sanity/test_stf_engine_differential.py":
        "the reference's bench.py and tests/chaos corpus, through phase0's "
        "engine differential",
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("relpath,name", params(FORKS))
def test_reference_case(case_context, relpath, name):
    reference_cases.cases(relpath)[name]()


def test_excluded_is_what_the_loader_cannot_resolve():
    cannot = unresolved_files(FORKS)
    assert set(cannot) == set(EXCLUDED), cannot
    # every case directory is phase0's or one of these
    tops = {f.split("/")[0] for f in reference_cases.case_files()}
    assert tops == {"phase0", *FORKS}


def test_tier1_subset_is_loadable():
    assert unloadable_tier1(FORKS) == []
