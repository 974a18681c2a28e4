"""The JAX package's phase0 spec cases on port-built specs.

Every case of ``tests/spec/phase0/`` that the port's loader
(``consensus_specs_tpu_torch/testing/reference_cases.py``) can resolve
runs here: the reference file stays the case's one text, its imports
rewritten to the port, its specs built by the port's builder for the
case's device.  A case under ``@with_all_phases`` runs on every fork the
port builds, phase0 to capella, as in the reference's own run.  The cases
are read from each file's syntax tree, so collecting imports none of them.

* tier-1 runs the files of the port's ``reference_cases.TIER1`` subset
  on CPU-built specs (``chip_smoke.py`` runs them on the card); every other
  loadable case is ``slow``;
* each case also has a ``cuda`` variant, which builds its specs on the
  card and skips without one;
* ``EXCLUDED`` names each phase0 file the loader cannot resolve, with
  what it waits for, and a test holds the table to exactly that set;
* the loader itself: the rewrite minds the prefix (the reference's name
  is a prefix of the port's), the names come from the syntax tree, and a
  loaded case module binds the port and never the reference.

The context reads the session's ``--preset``, ``--fork`` and
``--disable-bls`` as the reference's conftest does, checks signatures
with the native BLS backend, and restores every global afterwards.
"""
import sys

import pytest

from consensus_specs_tpu_torch.testing import reference_cases
from tests.torch_spec_cases import (  # noqa: F401
    DEVICES,
    case_context,
    params,
    unloadable_tier1,
    unresolved_files,
)

FORKS = ("phase0",)

EXCLUDED = {
    "phase0/fork_choice/test_engine_bench.py":
        "the reference's bench.py; its twin is chip_smoke.py phase 10a "
        "(the bench's fork-choice ingest row at 400,000 validators)",
    "phase0/fork_choice/test_engine_differential.py":
        "pytest-native (parametrized over its replay cases); its twins are "
        "tests/test_torch_forkchoice_cases.py (the replays under the port's "
        "engine_mode) and tests/test_torch_forkchoice.py (random DAGs, a "
        "finalizing chain, the batched fold, a warm store, segment_sum)",
    "phase0/fork_choice/test_node_differential.py":
        "pytest-native (parametrized over its replay cases); its twins are "
        "tests/test_torch_forkchoice_cases.py (the replays with a Node "
        "mirror) and tests/test_torch_node.py (the firehose, the admission "
        "gate's delivery orders, recovery)",
    "phase0/sanity/test_stf_engine_differential.py":
        "the reference's bench.py and tests/chaos corpus, run through the "
        "reference package",
    "phase0/test_epoch_kernel.py":
        "JAX internals: ops/epoch_jax",
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("relpath,name", params(FORKS))
def test_reference_case(case_context, relpath, name):
    reference_cases.cases(relpath)[name]()


def test_excluded_is_what_the_loader_cannot_resolve():
    cannot = unresolved_files(FORKS)
    assert set(cannot) == set(EXCLUDED), cannot


def test_tier1_subset_is_loadable():
    assert unloadable_tier1(FORKS) == []


def test_rewrite_minds_the_prefix():
    reference = reference_cases.REFERENCE
    port = reference_cases.PORT
    text = (f"from {reference}.testing.context import x\n"
            f"import {reference}\n"
            f"from {port}.ssz import bulk\n")
    assert reference_cases.rewrite(text) == (
        f"from {port}.testing.context import x\n"
        f"import {port}\n"
        f"from {port}.ssz import bulk\n")


def test_case_names_include_assigned_cases():
    names = reference_cases.case_names("phase0/random/test_random.py")
    assert "test_random_0" in names and "test_random_leak_1" in names


def test_loaded_module_binds_the_port():
    module = reference_cases.load("phase0/sanity/test_slots.py")
    assert module.__name__ == f"{reference_cases.PACKAGE}.phase0.sanity.test_slots"
    assert module.spec_state_test.__module__ == (
        f"{reference_cases.PORT}.testing.context")
    reference = reference_cases.REFERENCE
    assert all(getattr(v, "__module__", "").split(".")[0] != reference
               for v in vars(module).values())
    assert sys.modules[module.__name__] is module
