"""The torch port stands alone: no JAX and nothing of the reference package.

* a subprocess with ``jax`` and ``yaml`` blocked and an import blocker for
  ``consensus_specs_tpu`` imports every module of the port (the vector
  layer's ``gen``, every ``gen.runners`` main, ``gen.consumer``,
  ``gen.vector_yaml``, ``debug`` and ``config.config_util`` among them),
  writes and replays the ``bls`` and ``ssz_generic`` vectors and reads a
  config file without PyYAML, and builds the
  minimal phase0, altair, bellatrix and capella specs on the CPU (a
  subprocess, because the test session itself imports jax); through the
  port's ``testing/`` it then loads one of the reference's spec case
  files and runs its config-override case on a CPU-built spec, the
  device BLS backend (``ops/bls``) decides one batch on the CPU, and the
  ``"torch"`` hashing backend hashes one tree through its wave route, and
  the node's serving path (``forkchoice``, ``persist``, ``query``,
  ``node``) serves a minimal firehose with a query reader and a
  checkpoint store, equal to its literal replay, and the KZG and Fr
  layer (``crypto.fr``, ``crypto.kzg``, ``ops.fr``, ``ops.kzg``) runs an
  NTT and a lane product on the CPU, the four research specs build and
  a fixture-taking research case file runs, and the survival and
  network-facing layer (``node.adversary``, ``telemetry.soak``, ``p2p``,
  ``deposit_contract``, ``evm``) serves an adversarial firehose equal to
  its literal replay, draws the soak's fault plans, and runs the vendored
  deposit contract's bytecode to ``DepositTree``'s root, and the process
  fabric's six modules (``dist``) import (no fabric is started);
* a static scan of the port's sources finds no such import, nor one of
  ``yaml``, and covers the vector layer's files, the serving path's, the
  research layer's, the survival and network-facing layer's and the
  process fabric's;
* without ``device=`` the port runs on CUDA or raises — never quietly on
  the CPU (the soak's ``run_soak`` among its entry points).
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
sys.modules["yaml"] = None  # the port reads and writes YAML without PyYAML


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
VECTOR_LAYER = ["gen", "gen.consumer", "gen.vector_yaml", "gen.gen_runner",
                "gen.gen_from_tests", "gen.snappy", "debug", "debug.encode",
                "debug.decode", "debug.random_value", "config.config_util"] + [
    "gen.runners." + r for r in (
        "bls", "epoch_processing", "finality", "fork_choice", "forks",
        "genesis", "merkle", "operations", "random", "rewards", "sanity",
        "shuffling", "ssz_generic", "ssz_static", "transition")]
missing = [m for m in VECTOR_LAYER if "consensus_specs_tpu_torch." + m not in names]
assert missing == [], missing

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
# the vector layer without PyYAML: generate and replay two runners' trees
# on the CPU, and read a config file
import tempfile
from pathlib import Path
from consensus_specs_tpu_torch.config import config_util
from consensus_specs_tpu_torch.gen import consumer
from consensus_specs_tpu_torch.gen.runners import bls as bls_runner, ssz_generic
from consensus_specs_tpu_torch.crypto import bls
bls.use_native()
with tempfile.TemporaryDirectory() as tree:
    assert bls_runner.main(argv=["-o", tree, "-d", "cpu"])["generated"] == 33
    assert ssz_generic.main(argv=["-o", tree, "-d", "cpu"])["failed"] == 0
    stats = consumer.consume_tree(tree, device="cpu")
    assert stats["pass"] > 600 and stats["skip"] == 0, stats
    config = Path(tree) / "config.yaml"
    config.write_text("PRESET_BASE: 'minimal'\nGENESIS_FORK_VERSION: 0x00000001\n")
    assert config_util.load_config_file(config) == {
        "PRESET_BASE": "minimal", "GENESIS_FORK_VERSION": b"\x00\x00\x00\x01"}
# the node's serving path: fork choice, the checkpoint store, the query
# engine and the node service, a minimal firehose with query readers
SERVING_LAYER = ["forkchoice", "forkchoice.proto_array", "forkchoice.batch",
                 "forkchoice.engine", "persist", "persist.atomic",
                 "persist.store", "query", "query.resident",
                 "query.streamproof", "query.engine", "query.coldstart",
                 "query.harness", "node", "node.ingest", "node.admission",
                 "node.service", "node.firehose"]
missing = [m for m in SERVING_LAYER if "consensus_specs_tpu_torch." + m not in names]
assert missing == [], missing
from consensus_specs_tpu_torch.node import firehose
from consensus_specs_tpu_torch.persist.store import CheckpointStore
from consensus_specs_tpu_torch.query import harness
from consensus_specs_tpu_torch.testing.helpers.genesis import create_genesis_state
bls.bls_active = False
genesis = create_genesis_state(spec, context.default_balances(spec),
                               context.default_activation_threshold(spec))
corpus = firehose.build_corpus(spec, genesis, n_epochs=2, gossip_target=64)
with tempfile.TemporaryDirectory() as ckpt:
    store = CheckpointStore(ckpt)
    run = harness.run_query_load(spec, genesis, corpus, n_query_threads=1,
                                 checkpoint_store=store)
    store.close()
assert run["query_load"]["errors"] == 0
literal = firehose.replay_journal_literal(spec, genesis, corpus.anchor_block,
                                          run["node"].journal)
firehose.assert_parity(spec, run["node"], literal)
bls.bls_active = True
# KZG and Fr with the research forks: the host field and commitments, the
# device NTT and lane product (a few bit-planes) on the CPU, the four
# research specs and the loader's fixture-taking research case files
RESEARCH_LAYER = ["crypto.fr", "crypto.kzg", "ops.fr", "ops.kzg"]
missing = [m for m in RESEARCH_LAYER if "consensus_specs_tpu_torch." + m not in names]
assert missing == [], missing
import numpy as np
import torch
from consensus_specs_tpu_torch.crypto import fr, kzg
from consensus_specs_tpu_torch.crypto.bls.curve import g1_generator
from consensus_specs_tpu_torch.ops import fr as ops_fr, kzg as ops_kzg
values = list(range(1, 9))
assert ops_fr.ntt_device(values, device="cpu") == fr.fft(values)
points = kzg.setup_lagrange(4)
scalars = [3, 0, 5, 15]
px, py = (torch.as_tensor(a) for a in ops_kzg.points_to_limbs(points))
bits = torch.as_tensor(ops_kzg.to_bits(scalars)[-4:])  # 4-bit scalars
lanes = ops_kzg.limbs_to_points(*(a.numpy() for a in ops_kzg.msm_lanes(px, py, bits)))
assert lanes == [p.mul(s) for p, s in zip(points, scalars)]
for fork in ("eip4844", "sharding", "custody_game", "das"):
    assert get_spec(fork, "minimal", device="cpu").fork == fork
custody = reference_cases.cases("custody_game/test_epoch_processing.py")
with reference_cases.configured("cpu", bls_active=False):
    custody["test_reveal_deadlines_no_slash_within_grace"]()
# the survival and network-facing layer: an adversarial firehose, the
# soak's fault plans, the gossip ids, the deposit contract on the EVM
SURVIVAL_LAYER = ["node.adversary", "telemetry.soak", "p2p",
                  "deposit_contract", "evm", "evm.keccak"]
missing = [m for m in SURVIVAL_LAYER if "consensus_specs_tpu_torch." + m not in names]
assert missing == [], missing
import json
from consensus_specs_tpu_torch import deposit_contract, evm, p2p
from consensus_specs_tpu_torch.gen.snappy import compress
from consensus_specs_tpu_torch.node import adversary
from consensus_specs_tpu_torch.telemetry import soak
bls.bls_active = False
adv = adversary.build_adversarial_corpus(spec, genesis, n_epochs=3, gossip_target=64)
served = adversary.run_adversarial_firehose(spec, genesis, adv, producer_timeout=60.0)
firehose.assert_parity(spec, served["node"], firehose.replay_journal_literal(
    spec, genesis, adv.anchor_block, served["node"].journal))
bls.bls_active = True
sites = soak._stf_sites()
assert soak._epoch_plan(0, 90001, sites, breaker_trip=True).faults()
assert len(p2p.compute_message_id(compress(b"no jax"))) == 20
artifact = json.loads((Path(deposit_contract.__file__).parent / "vendor" /
                       "deposit_contract" / "deposit_contract.json").read_text())
contract = evm.deploy(bytes.fromhex(artifact["bytecode"][2:]))
assert contract.call("get_deposit_root()", [], [], static=True) == \
    deposit_contract.DepositTree().get_root()
# the process fabric: imported (walk_packages above), no fabric started
DIST_LAYER = ["dist", "dist.codec", "dist.dispatch", "dist.fabric",
              "dist.worker", "dist.workloads"]
missing = [m for m in DIST_LAYER if "consensus_specs_tpu_torch." + m not in names]
assert missing == [], missing
context.is_pytest = True
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "consensus_specs_tpu" or m.startswith("consensus_specs_tpu."))
assert leaked == ["jax"], leaked  # only the blocking None entry
assert sys.modules["yaml"] is None
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


def test_static_scan_finds_no_yaml_import_and_covers_the_vector_layer():
    port = ROOT / PORT
    sources = sorted(port.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    vector_layer = [port / "gen" / "consumer.py", port / "gen" / "vector_yaml.py",
                    port / "gen" / "gen_runner.py", port / "debug" / "__init__.py",
                    port / "config" / "config_util.py"] + sorted(
        (port / "gen" / "runners").glob("*.py"))
    assert len(vector_layer) == 5 + 16 and set(vector_layer) <= set(sources)
    offenders = [(str(p.relative_to(ROOT)), name) for p in sources
                 for name in _imports(p)
                 if name == "yaml" or name.startswith("yaml.")]
    assert offenders == []


def test_static_scan_covers_the_serving_layer():
    port = ROOT / PORT
    serving = [f for d in ("forkchoice", "persist", "query", "node")
               for f in sorted((port / d).glob("*.py"))]
    assert len(serving) == 19  # node/adversary.py among them
    assert set(serving) <= set(port.rglob("*.py"))
    assert [(str(p.relative_to(ROOT)), name) for p in serving
            for name in _imports(p) if _is_forbidden(name)] == []


def test_static_scan_covers_the_research_layer():
    port = ROOT / PORT
    research = [port / "crypto" / "fr.py", port / "crypto" / "kzg.py",
                port / "ops" / "fr.py", port / "ops" / "kzg.py"] + [
        port / "specs" / "src" / f"{fork}.py"
        for fork in ("eip4844", "sharding", "custody_game", "das")]
    assert all(p.is_file() for p in research)
    assert set(research) <= set(port.rglob("*.py"))
    assert [(str(p.relative_to(ROOT)), name) for p in research
            for name in _imports(p) if _is_forbidden(name)] == []


def test_static_scan_covers_the_survival_and_network_layer():
    port = ROOT / PORT
    layer = [port / "node" / "adversary.py", port / "telemetry" / "soak.py",
             port / "p2p.py", port / "deposit_contract.py",
             port / "evm" / "__init__.py", port / "evm" / "keccak.py"]
    assert all(p.is_file() for p in layer)
    assert set(layer) <= set(port.rglob("*.py"))
    assert [(str(p.relative_to(ROOT)), name) for p in layer
            for name in _imports(p) if _is_forbidden(name)] == []
    # the vendored artifact is the port's own copy: no source of the port
    # names the JAX package's vendor directory
    assert not [str(p.relative_to(ROOT)) for p in port.rglob("*.py")
                if "consensus_specs_tpu/vendor" in p.read_text()]


def test_static_scan_covers_the_process_fabric():
    port = ROOT / PORT
    layer = sorted((port / "dist").glob("*.py"))
    assert [p.name for p in layer] == [
        "__init__.py", "codec.py", "dispatch.py", "fabric.py", "worker.py",
        "workloads.py"]
    assert set(layer) <= set(port.rglob("*.py"))
    assert [(str(p.relative_to(ROOT)), name) for p in layer
            for name in _imports(p) if _is_forbidden(name)] == []
    # the workers are the port's own module, never the reference's
    fabric = (port / "dist" / "fabric.py").read_text()
    assert '"-m", "consensus_specs_tpu_torch.dist.worker"' in fabric


def test_soak_without_a_device_needs_cuda(monkeypatch, tmp_path):
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.telemetry import soak
    from consensus_specs_tpu_torch.testing import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (context.spec_device(), bls.backend_name(), bls.bls_active)
    out = tmp_path / "soak.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        soak.run_soak("bounded", out_path=str(out))
    with pytest.raises(RuntimeError, match="CUDA"):
        soak.run_endurance(minutes=1.0, out_path=str(out))
    assert not out.exists()
    assert (context.spec_device(), bls.backend_name(), bls.bls_active) == before


def test_research_layer_without_a_device_needs_cuda(monkeypatch):
    from consensus_specs_tpu_torch.crypto import kzg
    from consensus_specs_tpu_torch.ops import fr as ops_fr
    from consensus_specs_tpu_torch.ops import kzg as ops_kzg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops_fr.ntt_device([1, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        ops_kzg.batch_scalar_mul(kzg.setup_lagrange(2), [1, 2])


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
