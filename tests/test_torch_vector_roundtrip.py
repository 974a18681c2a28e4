"""The port's vector generators and consumer against the JAX package's.

Tier-1: the port (specs built for the CPU) and the reference each write a
small vector tree with native BLS on both sides: the ``bls`` runner, one
``ssz_static`` provider (phase0, minimal, ``mode_random``, 2 cases a
type), phase0 ``sanity/slots`` and phase0 ``epoch_processing/
effective_balance_updates``.  The trees must be byte-identical, file for
file; the port's consumer must pass every case of both, and the
reference's consumer every case of the port's.  Every comparison is
exact.

``slow``: the port's minimal twin of ``tests/test_vector_consumer.py``'s
round trips (each runner at the minimal preset through the port's
consumer, and the corruption, ``INCOMPLETE``, CLI and config-override
checks), all on CPU-built specs.
"""
from pathlib import Path

import pytest

from consensus_specs_tpu.gen import consumer as ref_consumer
from consensus_specs_tpu.gen import gen_runner as ref_gen_runner
from consensus_specs_tpu.gen.gen_from_tests import (
    get_create_provider_fn as ref_state_provider,
)
from consensus_specs_tpu.gen.runners import bls as ref_bls
from consensus_specs_tpu.gen.runners import ssz_static as ref_ssz_static
from consensus_specs_tpu.testing import context as ref_context
from consensus_specs_tpu_torch.crypto import bls as port_bls
from consensus_specs_tpu_torch.gen import consumer, gen_runner, vector_yaml
from consensus_specs_tpu_torch.gen.gen_from_tests import get_create_provider_fn
from consensus_specs_tpu_torch.gen.runners import bls as port_bls_runner
from consensus_specs_tpu_torch.gen.runners import ssz_static
from consensus_specs_tpu_torch.testing import context

# (runner, handler, case file under tests/spec/) of the state cases
STATE_HANDLERS = (
    ("sanity", "slots", "phase0/sanity/test_slots.py"),
    ("epoch_processing", "effective_balance_updates",
     "phase0/epoch_processing/test_process_effective_balance_updates.py"),
)
SSZ_CASES = 2


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = (context.is_pytest, ref_context.is_pytest, port_bls.backend_name())
    yield
    context.is_pytest, ref_context.is_pytest = saved[:2]
    port_bls.use_backend(saved[2])


def _ssz_setting():
    """The ssz_static runner's minimal ``mode_random`` setting (its seed)."""
    return next(s for s in ssz_static.settings()
                if s[1] == "minimal" and s[2].name == "mode_random" and not s[3])


def generate_reference_tree(out: Path) -> None:
    argv = ["-o", str(out)]
    ref_bls.main(argv=argv)
    seed, preset, mode, chaos, _ = _ssz_setting()
    ref_mode = ref_ssz_static.random_value.RandomizationMode[mode.name]
    ref_gen_runner.run_generator("ssz_static", [ref_ssz_static.create_provider(
        "phase0", preset, seed, ref_mode, chaos, SSZ_CASES)], argv=argv)
    for runner, handler, path in STATE_HANDLERS:
        module = "tests.spec." + path[:-len(".py")].replace("/", ".")
        ref_gen_runner.run_generator(runner, [ref_state_provider(runner)(
            fork_name="phase0", preset_name="minimal", handler_name=handler,
            tests_src_mod_name=[module])], argv=argv)


def generate_port_tree(out: Path) -> None:
    argv = ["-o", str(out), "-d", "cpu"]
    port_bls_runner.main(argv=argv)
    seed, preset, mode, chaos, _ = _ssz_setting()
    gen_runner.run_generator("ssz_static", [ssz_static.create_provider(
        "phase0", preset, seed, mode, chaos, SSZ_CASES)], argv=argv)
    for runner, handler, path in STATE_HANDLERS:
        gen_runner.run_generator(runner, [get_create_provider_fn(runner)(
            fork_name="phase0", preset_name="minimal", handler_name=handler,
            tests_src_mod_name=[path])], argv=argv)


def tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    port = tmp_path_factory.mktemp("port")
    saved = (context.is_pytest, ref_context.is_pytest, port_bls.backend_name())
    try:
        generate_reference_tree(ref)
        generate_port_tree(port)
    finally:
        context.is_pytest, ref_context.is_pytest = saved[:2]
        port_bls.use_backend(saved[2])
    return ref, port


def test_trees_are_byte_identical(trees):
    ref, port = (tree_bytes(t) for t in trees)
    assert sorted(port) == sorted(ref)
    assert [name for name in ref if port[name] != ref[name]] == []
    # the tree holds what was asked for: 33 bls cases, 2 cases of every
    # phase0 container, the slots and effective-balance cases
    names = list(port)
    assert sum(n.endswith("/data.yaml") for n in names) == 33
    assert sum(n.endswith("/roots.yaml") for n in names) == 27 * SSZ_CASES
    assert any("/sanity/slots/" in n for n in names)
    assert any("/epoch_processing/effective_balance_updates/" in n for n in names)
    assert not any(n.endswith("INCOMPLETE") or n.endswith("error_log.txt")
                   for n in names)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_port_consumer_passes_every_case(trees, which):
    tree = trees[0] if which == "reference" else trees[1]
    cases = sum(1 for _ in tree.glob("*/*/*/*/*/*"))
    port_bls.use_native()
    stats = consumer.consume_tree(tree, device="cpu")
    assert stats == {"pass": cases, "skip": 0}


def test_reference_consumer_passes_the_port_tree(trees):
    cases = sum(1 for _ in trees[1].glob("*/*/*/*/*/*"))
    assert ref_consumer.consume_tree(trees[1]) == {"pass": cases, "skip": 0}


def test_consumer_without_a_card_raises(trees, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        consumer.consume_tree(trees[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        consumer.main([str(trees[1])])


# -- slow: the minimal twin of tests/test_vector_consumer.py ----------------


@pytest.fixture
def _native_bls():
    port_bls.use_native()


def _generate(tmp_path, runner, argv_extra=()):
    import importlib

    main = importlib.import_module(
        f"consensus_specs_tpu_torch.gen.runners.{runner}").main
    argv = ["-o", str(tmp_path), "-d", "cpu"]
    if runner not in ("bls", "ssz_generic"):
        argv += ["-l", "minimal"]
    counts = main(argv=[*argv, *argv_extra])
    assert counts["failed"] == 0


@pytest.mark.slow
@pytest.mark.usefixtures("_native_bls")
@pytest.mark.parametrize("runners,preset,least", [
    (("operations",), "minimal", 51),
    (("sanity", "epoch_processing"), "minimal", 41),
    (("shuffling", "ssz_static"), "minimal", 51),
    (("forks", "genesis"), "minimal", 4),
    (("bls", "transition"), None, 31),
    (("rewards",), "minimal", 21),
    (("fork_choice",), "minimal", 10),
    (("merkle",), "minimal", 4),
    (("ssz_generic",), None, 100),
])
def test_runner_roundtrip(tmp_path, runners, preset, least):
    for runner in runners:
        _generate(tmp_path, runner)
    consumed = set(runners) | ({"fork"} if "forks" in runners else set())
    stats = consumer.consume_tree(tmp_path, preset=preset, runners=consumed,
                                  device="cpu")
    assert stats["pass"] >= least
    assert stats["skip"] == 0


def _corrupt_first(tmp_path, part: str, change) -> Path:
    for path in sorted(Path(tmp_path).rglob(part)):
        data = vector_yaml.load(path.read_text())
        if change(data):
            path.write_text(vector_yaml.dump(data))
            return path
    raise AssertionError(f"no {part} to corrupt")


@pytest.mark.slow
def test_consumer_detects_corruption(tmp_path):
    _generate(tmp_path, "shuffling")

    def bump(data):
        if not data["mapping"]:
            return False
        data["mapping"][0] = int(data["mapping"][0]) + 1
        return True

    _corrupt_first(tmp_path, "mapping.yaml", bump)
    with pytest.raises(consumer.VectorFailure):
        consumer.consume_tree(tmp_path, preset="minimal", runners={"shuffling"},
                              device="cpu")


@pytest.mark.slow
def test_incomplete_cases_skipped(tmp_path):
    _generate(tmp_path, "shuffling")
    case = next(p for p in Path(tmp_path).rglob("mapping.yaml")).parent
    (case / "INCOMPLETE").write_text("")
    stats = consumer.consume_tree(tmp_path, preset="minimal",
                                  runners={"shuffling"}, device="cpu")
    assert stats["skip"] == 1


@pytest.mark.slow
def test_cli_entrypoint(tmp_path, capsys):
    _generate(tmp_path, "shuffling")
    consumer.main([str(tmp_path), "--preset", "minimal", "--runner", "shuffling",
                   "--device", "cpu"])
    assert "passed" in capsys.readouterr().out


@pytest.mark.slow
@pytest.mark.usefixtures("_native_bls")
def test_config_override_vectors_roundtrip(tmp_path):
    _generate(tmp_path, "sanity")
    override_cases = [p.parent for p in Path(tmp_path).rglob("config.yaml")]
    assert override_cases, "no config-override vectors generated"
    stats = consumer.consume_tree(tmp_path, preset="minimal", runners={"sanity"},
                                  device="cpu")
    assert stats["pass"] > 0
    for case in override_cases:
        (case / "config.yaml").unlink()
    with pytest.raises(consumer.VectorFailure):
        consumer.consume_tree(tmp_path, preset="minimal", runners={"sanity"},
                              device="cpu")


@pytest.mark.slow
@pytest.mark.usefixtures("_native_bls")
def test_fork_choice_and_merkle_corruption_detected(tmp_path):
    _generate(tmp_path, "fork_choice")
    _generate(tmp_path, "merkle")

    def bump_head(steps):
        for step in steps:
            if "checks" in step and "head" in step["checks"]:
                step["checks"]["head"]["slot"] = int(step["checks"]["head"]["slot"]) + 1
                return True
        return False

    def flip_branch(proof):
        proof["branch"][0] = "0x" + "ab" * 32
        return True

    _corrupt_first(tmp_path, "steps.yaml", bump_head)
    with pytest.raises(consumer.VectorFailure):
        consumer.consume_tree(tmp_path, preset="minimal", runners={"fork_choice"},
                              device="cpu")
    _corrupt_first(tmp_path, "proof.yaml", flip_branch)
    with pytest.raises(consumer.VectorFailure):
        consumer.consume_tree(tmp_path, preset="minimal", runners={"merkle"},
                              device="cpu")
