"""The reference's fork-choice scenarios replayed through the port's
fork-choice engine and node.

Twins of ``phase0/fork_choice/test_engine_differential.py`` and
``test_node_differential.py`` of the JAX package's ``tests/spec/``, which
the port's case loader cannot take (they are pytest-native: parametrized
over their replay cases).  Every case of ``test_get_head.py``,
``test_ex_ante.py`` and ``test_on_block.py`` runs on a CPU-built spec
under the port's ``engine_mode()``: each helper-driven store mutation is
mirrored into a shadow, and the shadow's head and checkpoints must equal
the literal spec walk's after every step.  The shadow is the port's
``ForkChoiceEngine`` (the default mirror) or a ``Node`` (engine-backed
``on_block`` through the batched stf engine, journal off).  BLS off, as
in the reference's replays.

* phase0: every case with both mirrors;
* altair: every case with the engine mirror (``slow``), and the
  reference's spot set of three with the node mirror;
* a case that needs the mainnet preset skips at minimal, so it is
  ``slow``.
"""
import ast

import pytest

from consensus_specs_tpu_torch.node import Node
from consensus_specs_tpu_torch.testing import reference_cases
from consensus_specs_tpu_torch.testing.helpers.fork_choice import engine_mode

FILES = ("phase0/fork_choice/test_get_head.py",
         "phase0/fork_choice/test_ex_ante.py",
         "phase0/fork_choice/test_on_block.py")
# one scenario a file: a head walk under votes, an ex-ante boost
# interaction, an on_block reject path (the reference's altair spot set)
ALTAIR_SPOT = {"test_shorter_chain_but_heavier_weight",
               "test_ex_ante_vanilla",
               "test_on_block_future_block"}


def _mainnet_only(relpath):
    """Cases of ``relpath`` whose decorators ask for the mainnet preset,
    read from its syntax tree."""
    tree = ast.parse((reference_cases.CASES_ROOT / relpath).read_text())
    return {node.name for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and any("with_presets([MAINNET]" in ast.unparse(d)
                    for d in node.decorator_list)}


def _node_mirror(spec, genesis_state, anchor):
    return Node(spec, genesis_state, anchor, journal=False)


MIRRORS = {"engine": None, "node": _node_mirror}


def _params():
    out = []
    for relpath in FILES:
        mainnet = _mainnet_only(relpath)
        for name in reference_cases.case_names(relpath):
            for phase in ("phase0", "altair"):
                for mirror in MIRRORS:
                    if phase == "altair" and mirror == "node" \
                            and name not in ALTAIR_SPOT:
                        continue
                    slow = name in mainnet or (
                        phase == "altair" and mirror == "engine")
                    out.append(pytest.param(
                        relpath, name, phase, mirror,
                        id=f"{relpath.rsplit('/', 1)[-1]}::{name}-{phase}-{mirror}",
                        marks=pytest.mark.slow if slow else ()))
    return out


@pytest.mark.parametrize("relpath,name,phase,mirror", _params())
def test_replay_through_the_port(relpath, name, phase, mirror):
    with reference_cases.configured("cpu", bls_active=False):
        with engine_mode(mirror_factory=MIRRORS[mirror]):
            reference_cases.cases(relpath)[name](phase=phase, bls_active=False)
