"""The torch port stands alone: no JAX and nothing of the reference package.

* a subprocess with ``jax`` blocked and an import blocker for
  ``consensus_specs_tpu`` imports every module of the port and builds the
  minimal phase0, altair, bellatrix and capella specs on the CPU (a
  subprocess, because the test session itself imports jax); through the
  port's ``testing/`` it then loads one of the reference's spec case
  files and runs its config-override case on a CPU-built spec, the
  device BLS backend (``ops/bls``) decides one batch on the CPU, and the
  ``"torch"`` hashing backend hashes one tree through its wave route;
* a static scan of the port's sources finds no such import;
* without ``device=`` the port runs on CUDA or raises — never quietly on
  the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

PORT = "consensus_specs_tpu_torch"
REFERENCE = "consensus_specs_tpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError


class _BlockReference:
    def find_spec(self, name, path=None, target=None):
        if name == "consensus_specs_tpu" or name.startswith("consensus_specs_tpu."):
            raise ImportError(f"the port imported the reference: {name}")
        return None


sys.meta_path.insert(0, _BlockReference())

import consensus_specs_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)

from consensus_specs_tpu_torch.specs import get_spec

spec = get_spec("phase0", "minimal", device="cpu")
assert spec.SLOTS_PER_EPOCH == 8
# the altair build runs its installs (epoch_altair, the participation
# scope, the sync aggregate index) and the engine knows the fork
altair = get_spec("altair", "minimal", device="cpu")
assert altair.phase0 is spec and altair.SYNC_COMMITTEE_SIZE == 32
from consensus_specs_tpu_torch.stf import engine
assert "altair" in engine.FAST_FORKS
# the ladder on to capella: bellatrix's execution engine stub, capella's
# withdrawals, and the engine's bellatrix fast path
capella = get_spec("capella", "minimal", device="cpu")
assert capella.bellatrix.altair is altair and capella.MAX_WITHDRAWALS_PER_PAYLOAD == 16
assert "bellatrix" in engine.FAST_FORKS and "capella" not in engine.FAST_FORKS
# the test framework and its loader: a reference case file, rewritten to
# the port, runs on a CPU-built spec (its override builds a spec anew)
from consensus_specs_tpu_torch.testing import context, reference_cases
cases = reference_cases.cases("phase0/sanity/test_slots.py")
with reference_cases.configured("cpu", forks=("phase0",), bls_active=False):
    cases["test_epoch_ejections_under_raised_ejection_balance"]()
assert context.spec_device() is None
# the device BLS backend decides a batch (its plain pipeline on the CPU)
from consensus_specs_tpu_torch.crypto.bls import native
from consensus_specs_tpu_torch.ops import bls as device_bls
pk, sig = native.SkToPk(3), native.Sign(3, b"no jax")
previous = device_bls.set_device("cpu")
try:
    assert device_bls.batch_fast_aggregate_verify(
        [[pk], [pk]], [b"no jax", b"other"], [sig, sig]) == [True, False]
finally:
    device_bls.set_device(previous)
# the SSZ hasher's wave route (the tree floor lowered for a small tree)
from consensus_specs_tpu_torch.ssz import hashing
from consensus_specs_tpu_torch.ssz.types import List, uint64
want = bytes(List[uint64, 1024](*range(200)).hash_tree_root())
hashing.set_backend("torch", device="cpu")
hashing.MIN_DEVICE_TREE = 1
try:
    assert hashing.get_wave_hasher() is not None
    assert bytes(List[uint64, 1024](*range(200)).hash_tree_root()) == want
finally:
    hashing.set_backend("hashlib")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "consensus_specs_tpu" or m.startswith("consensus_specs_tpu."))
assert leaked == ["jax"], leaked  # only the blocking None entry
print("imported", len(names), "modules")
"""


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT_SCRIPT],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def _is_forbidden(module: str) -> bool:
    """jax, or the reference package — never the port, whose name the
    reference's is a prefix of."""
    for banned in ("jax", REFERENCE):
        if module == banned or module.startswith(banned + "."):
            return True
    return False


def test_forbidden_name_check_respects_the_prefix():
    assert _is_forbidden("consensus_specs_tpu")
    assert _is_forbidden("consensus_specs_tpu.ops.sha256_jax")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("consensus_specs_tpu_torch")
    assert not _is_forbidden("consensus_specs_tpu_torch.ops.sha256")
    assert not _is_forbidden("jaxlike")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_static_scan_finds_no_jax_or_reference_import():
    sources = sorted((ROOT / PORT).rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bls_phase_clock.py",
        ROOT / "sha256_pipes.py"]
    assert len(sources) > 20
    offenders = [(str(p.relative_to(ROOT)), name)
                 for p in sources for name in _imports(p) if _is_forbidden(name)]
    assert offenders == []


def test_hashing_lazy_backends_name_only_the_port():
    from consensus_specs_tpu_torch.ssz import hashing

    assert hashing._LAZY_BACKENDS == {"torch": f"{PORT}.ops.sha256"}


def test_get_spec_without_device_refuses_a_host_without_cuda(monkeypatch):
    from consensus_specs_tpu_torch.specs import get_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_spec("phase0", "minimal")
    # the explicit CPU request still builds
    assert get_spec("phase0", "minimal", device="cpu").SLOTS_PER_EPOCH == 8


def test_built_specs_are_named_by_device():
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec("phase0", "minimal", device="cpu")
    assert spec.__name__ == f"{PORT}.specs.phase0_minimal_cpu"
    assert sys.modules[spec.__name__] is spec
