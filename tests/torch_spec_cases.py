"""Shared by the port's spec-case files (``tests/test_torch_spec_cases_*.py``):
the cases as pytest parameters, and the context they run in."""
import pytest
import torch

from consensus_specs_tpu_torch.testing import reference_cases

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def params(forks):
    """A parameter for each loadable case in the directories of ``forks``:
    ``slow`` unless the port's ``TIER1`` subset holds its file and the case
    is not one of its ``TIER1_SLOW_CASES``."""
    tier1 = reference_cases.TIER1
    slow = set(reference_cases.TIER1_SLOW_CASES)
    return [pytest.param(f, name, id=f"{f}::{name}",
                         marks=() if f.startswith(tier1) and (f, name) not in slow
                         else pytest.mark.slow)
            for f, name in reference_cases.loadable_cases(forks)]


def unloadable_tier1(forks):
    """The ``TIER1`` entries of ``forks`` that match no loadable file."""
    files = {f for f, _ in reference_cases.loadable_cases(forks)}
    return [p for p in reference_cases.TIER1 if p.split("/")[0] in forks
            and not any(f.startswith(p) for f in files)]


def unresolved_files(forks):
    """The files in the directories of ``forks`` that the loader cannot
    resolve, with its reasons."""
    return {f: reason for f in reference_cases.case_files()
            if f.split("/")[0] in forks
            for reason in [reference_cases.unresolved(f)] if reason}


@pytest.fixture
def case_context(request, device):
    """The port's test context on ``device`` with the session's
    ``--preset``, ``--fork`` and ``--disable-bls``, restored afterwards."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the specs are built for the card")
    option = request.config.getoption
    forks = option("--fork")
    with reference_cases.configured(
            device, preset=option("--preset"),
            forks=forks.split(",") if forks else None,
            bls_active=not option("--disable-bls")):
        yield
