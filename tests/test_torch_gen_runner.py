"""The port's vector-generation driver against the JAX package's.

The reference's lifecycle cases (every part kind, resume without and with
``--force``, an ``INCOMPLETE`` case regenerated, an error left
``INCOMPLETE`` and logged, a skip removing its directory, the preset
filter) run through both packages' ``run_generator`` on the same
providers: the two output trees must hold the same files with the same
bytes and the same ``INCOMPLETE`` tags (the error log's tracebacks name
each package's files, so of the log only its presence and the case's
name are compared).  Then ``combine_mods``, the reflection bridge on a
case file loaded by the port's ``testing/reference_cases`` (its parts
equal the reference's on the same case), the returned counts, and the
device rule: without ``-d`` a host with no card raises.
"""
import pytest
import torch

from consensus_specs_tpu.gen import gen_runner as ref_gen_runner
from consensus_specs_tpu.gen.gen_from_tests import combine_mods as ref_combine_mods
from consensus_specs_tpu.gen.gen_from_tests import (
    generate_from_tests as ref_generate_from_tests,
)
from consensus_specs_tpu.gen.gen_typing import TestCase as RefTestCase
from consensus_specs_tpu.gen.gen_typing import TestProvider as RefTestProvider
from consensus_specs_tpu.testing import context as ref_context
from consensus_specs_tpu.testing.exceptions import SkippedTest as RefSkippedTest
from consensus_specs_tpu_torch.gen import gen_runner, gen_typing, vector_yaml
from consensus_specs_tpu_torch.gen.gen_from_tests import (
    combine_mods,
    generate_from_tests,
)
from consensus_specs_tpu_torch.gen.snappy import decompress
from consensus_specs_tpu_torch.testing import context, reference_cases
from consensus_specs_tpu_torch.testing.exceptions import SkippedTest

PACKAGES = {
    "reference": (ref_gen_runner.run_generator, RefTestCase, RefTestProvider,
                  RefSkippedTest, []),
    "port": (gen_runner.run_generator, gen_typing.TestCase,
             gen_typing.TestProvider, SkippedTest,
             ["-d", "cpu"]),
}


@pytest.fixture(autouse=True)
def _restore_pytest_flags():
    saved = context.is_pytest, ref_context.is_pytest
    yield
    context.is_pytest, ref_context.is_pytest = saved


def _cases(package, calls):
    """The lifecycle's case functions, for ``package``'s types."""
    _, case_type, _, skipped, _ = PACKAGES[package]

    def parts():
        calls.append("parts")
        yield "pre", "ssz", b"\x01\x02\x03" * 40
        yield "mapping", "data", {"a": 1, "seed": "0x" + "ab" * 32,
                                  "list": list(range(40)), "none": None}
        yield "bls_setting", "meta", 2
        yield "blocks_count", "meta", 0

    def data_only():
        calls.append("data")
        yield "x", "data", 1

    def boom():
        yield "x", "data", 1
        raise RuntimeError("boom")

    def skip():
        raise skipped("not applicable")
        yield  # pragma: no cover

    def empty():
        return iter(())

    def case(name, fn, preset="minimal"):
        return case_type(fork_name="phase0", preset_name=preset,
                         runner_name="demo", handler_name="h", suite_name="s",
                         case_name=name, case_fn=fn)

    return [case("case_parts", parts), case("case_data", data_only),
            case("case_bad", boom), case("case_skip", skip),
            case("case_empty", empty), case("case_mainnet", data_only, "mainnet")]


def _run(package, out, cases, extra=()):
    run, _, provider, _, device_args = PACKAGES[package]
    prov = provider(prepare=lambda: None, make_cases=lambda: iter(cases))
    return run("demo", [prov], argv=["-o", str(out), *device_args, *extra])


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and p.name != "testgen_error_log.txt"}


def _lifecycle(package, root):
    """Run the lifecycle's steps; the tree after each, and the calls."""
    calls, snapshots = [], []
    cases = _cases(package, calls)
    root.mkdir()
    _run(package, root, cases)
    snapshots.append(_tree(root))
    _run(package, root, cases)  # resume: the complete cases are skipped
    snapshots.append(_tree(root))
    incomplete = root / "minimal/phase0/demo/h/s/case_data"
    (incomplete / "INCOMPLETE").write_text("\n")
    (incomplete / "stale.yaml").write_text("junk\n")
    _run(package, root, cases)  # the tagged case is wiped and regenerated
    snapshots.append(_tree(root))
    _run(package, root, cases, ["-f"])
    snapshots.append(_tree(root))
    (root / "filtered").mkdir()
    _run(package, root / "filtered", cases, ["-l", "mainnet"])
    snapshots.append(_tree(root))
    return snapshots, calls


def test_lifecycle_trees_equal_the_reference(tmp_path):
    ref, ref_calls = _lifecycle("reference", tmp_path / "reference")
    port, port_calls = _lifecycle("port", tmp_path / "port")
    assert port == ref
    assert port_calls == ref_calls
    final = port[-1]
    case = "minimal/phase0/demo/h/s/"
    assert decompress(final[case + "case_parts/pre.ssz_snappy"]) == b"\x01\x02\x03" * 40
    assert vector_yaml.load(final[case + "case_parts/meta.yaml"].decode()) == {
        "bls_setting": 2, "blocks_count": 0}
    assert case + "case_bad/INCOMPLETE" in final
    assert not any(name.startswith(case + "case_skip") for name in final)
    assert not any(name.startswith(case + "case_empty") for name in final)
    assert not any(name.startswith("filtered/minimal") for name in final)
    assert "filtered/mainnet/phase0/demo/h/s/case_mainnet/x.yaml" in final
    for root in (tmp_path / "reference", tmp_path / "port"):
        log = (root / "testgen_error_log.txt").read_text()
        assert "case_bad" in log and "boom" in log


def test_run_generator_returns_its_counts(tmp_path):
    counts = _run("port", tmp_path, _cases("port", []))
    # the empty case is neither generated nor failed (its directory goes)
    assert counts == {"collected": 6, "generated": 3, "skipped": 1, "failed": 1}


def test_without_a_card_the_default_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prov = gen_typing.TestProvider(prepare=lambda: None,
                                   make_cases=lambda: iter(()))
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_runner.run_generator("demo", [prov], argv=["-o", str(tmp_path)])
    from consensus_specs_tpu_torch.gen.runners import ssz_generic

    with pytest.raises(RuntimeError, match="CUDA"):
        ssz_generic.main(argv=["-o", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    # the device is the context's for the run only
    assert context.spec_device() is None


def test_combine_mods_as_the_reference():
    a = {"x": "phase0/a.py", "y": "phase0/y.py"}
    b = {"x": "altair/b.py", "z": ["altair/z.py", "altair/z2.py"]}
    assert combine_mods(a, b) == ref_combine_mods(a, b)
    assert combine_mods(a, b)["x"] == ["altair/b.py", "phase0/a.py"]


def test_reflection_bridge_on_a_port_loaded_case_file():
    import tests.spec.phase0.sanity.test_slots as ref_module

    module = reference_cases.load("phase0/sanity/test_slots.py")
    kwargs = dict(runner_name="sanity", handler_name="slots",
                  fork_name="phase0", preset_name="minimal")
    port_cases = list(generate_from_tests(src=module, **kwargs))
    ref_cases = list(ref_generate_from_tests(src=ref_module, **kwargs))
    assert [c.case_name for c in port_cases] == [c.case_name for c in ref_cases]
    assert port_cases and all(not c.case_name.startswith("test_")
                              for c in port_cases)
    case = next(c for c in port_cases if c.case_name == "slots_1")
    ref_case = next(c for c in ref_cases if c.case_name == "slots_1")
    context.is_pytest = ref_context.is_pytest = False
    with reference_cases.configured("cpu", forks=("phase0",)):
        parts = list(case.case_fn())
    ref_parts = list(ref_case.case_fn())
    assert {kind for _, kind, _ in parts} >= {"ssz", "meta"}
    assert [(n, k, bytes(v) if k == "ssz" else v) for n, k, v in parts] == [
        (n, k, bytes(v) if k == "ssz" else v) for n, k, v in ref_parts]
