"""The port's soak-endurance harness (``telemetry/soak.py``) against the
JAX package's.

* the fault sites the walk draws from and every epoch's fault plan equal
  the reference's;
* the RSS flatness verdict on fixed series, and the names and caps of
  the bounded structures sampled off the telemetry bus, equal the
  reference's;
* the report path never names the JAX package's ``SOAK.json``, and the
  walk's settings (the testing context's device, the BLS switch and
  backend, the recorder's ring) are restored after it;
* a two-epoch phase0 walk on a CPU-built spec (the fewest epochs at which
  the reference's own walk passes: at one epoch its breaker cannot probe
  its way closed): the epoch-0 trip fires, the breaker closes, the
  fault-free rerun takes the fast path on every block;
* ``slow``: that walk against the reference's (the same per-block roots,
  fired faults, breaker counters and rerun), about 9 s on the CPU with
  both corpora built, and the bounded profile, as in the reference.
"""
import json

import pytest

from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.telemetry import recorder as ref_recorder
from consensus_specs_tpu.telemetry import soak as ref_soak
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.telemetry import recorder, soak
from consensus_specs_tpu_torch.testing import context


@pytest.fixture
def own_snapshots(tmp_path, monkeypatch):
    """The soak's pre-states go through the cold-start snapshot seam:
    keep both packages' snapshots in this test's directory."""
    monkeypatch.setenv("CSTPU_SNAPSHOT_DIR", str(tmp_path / "snapshots"))
    return tmp_path


def _plan(plan):
    return [(f.site, f.nth, f.kind, f.sticky, f.proc) for f in plan.faults()]


def test_stf_sites_equal_the_references():
    sites = soak._stf_sites()
    assert sites == ref_soak._stf_sites()
    assert "stf.engine.operations" in sites


@pytest.mark.parametrize("seed", [90001, 7])
def test_epoch_plans_equal_the_references(seed):
    sites = soak._stf_sites()
    for epoch in range(32):
        trip = epoch == 0
        ours = soak._epoch_plan(epoch, seed, sites, breaker_trip=trip)
        assert _plan(ours) == _plan(
            ref_soak._epoch_plan(epoch, seed, sites, breaker_trip=trip))
        assert all(kind in ("error", "corrupt") for _, _, kind, _, _
                   in _plan(ours))


@pytest.mark.parametrize("series", [
    [],
    [100.0],
    [100.0, 101.0],
    [None, 300.0, None, 310.0],
    [200.0 + i for i in range(32)],
    [100.0] * 8 + [400.0] * 8,
    [512.0, 600.0, 650.0, 700.0, 705.0, 820.0, 900.0, 1000.0],
])
def test_rss_flatness_equals_the_references(series):
    assert soak.rss_flatness(series) == ref_soak.rss_flatness(series)


def test_bounded_cache_sizes_name_the_references_structures():
    from consensus_specs_tpu import stf as ref_stf  # noqa: F401  (providers)
    from consensus_specs_tpu_torch import stf  # noqa: F401  (providers)

    ours = soak.bounded_cache_sizes()
    theirs = ref_soak.bounded_cache_sizes()
    assert [e["name"] for e in ours] == [e["name"] for e in theirs]
    assert {e["name"]: e["cap"] for e in ours} == \
        {e["name"]: e["cap"] for e in theirs}
    assert soak._pipeline_inflight_cap() == ref_soak._pipeline_inflight_cap()


def test_report_path_is_the_ports_own():
    path = soak.default_out_path()
    assert path.endswith("SOAK_torch.json")
    assert "SOAK.json" not in path


def test_walk_settings_are_restored(own_snapshots):
    prev = (context.spec_device(), bls.backend_name(), bls.bls_active,
            recorder.enabled(), recorder.stats()["cap"])
    bls.bls_active = False
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with soak._soak_environment("cpu", 64) as device:
                assert device == "cpu" and context.spec_device() == "cpu"
                assert bls.bls_active and recorder.stats()["cap"] == 64
                raise RuntimeError("inside")
        assert (context.spec_device(), bls.backend_name(), bls.bls_active,
                recorder.enabled(), recorder.stats()["cap"]) == \
            (prev[0], prev[1], False, prev[3], prev[4])
    finally:
        bls.bls_active = prev[2]


def _port_walk(epochs: int):
    report = {"out_path": None, "forks": [], "failure": None}
    with soak._soak_environment("cpu", soak.PROFILES["bounded"]["ring_cap"]):
        return soak._soak_fork("phase0", epochs, 90001, report)


def test_two_epoch_walk_trips_and_recovers(own_snapshots):
    section = _port_walk(2)
    assert section["blocks"] == 16 and section["faulted_epochs"] == 1
    assert section["fired"] == [["stf.engine.operations", n, "error"]
                                for n in (1, 2, 3)]
    walk = section["walk_stats"]
    assert walk["breaker_trips"] == 1 and walk["breaker_state"] == "closed"
    assert section["rerun_stats"] == {
        "fast_blocks": 16, "replayed_blocks": 0, "replay_reasons": {}}
    for sample in section["cache_samples"]:
        for entry in sample["sizes"]:
            if entry["cap"]:
                assert entry["size"] <= entry["cap"], entry


@pytest.mark.slow
def test_two_epoch_walk_equals_the_references(own_snapshots):
    saved = (ref_bls.backend_name(), ref_bls.bls_active,
             ref_recorder.enabled(), ref_recorder.stats()["cap"])
    ref_bls.use_fastest()
    ref_bls.bls_active = True
    ref_recorder.enable(cap=soak.PROFILES["bounded"]["ring_cap"])
    ref_recorder.reset()
    try:
        ref_section = ref_soak._soak_fork(
            "phase0", 2, 90001, {"out_path": str(own_snapshots / "ref.json"),
                                 "forks": [], "failure": None})
        ref_roots = ref_soak._build_corpus("phase0", 2)[3]
    finally:
        ref_bls.use_backend(saved[0])
        ref_bls.bls_active = saved[1]
        ref_recorder.enable(cap=saved[3])
        if not saved[2]:
            ref_recorder.disable()
    section = _port_walk(2)
    with soak._soak_environment("cpu", 64):
        roots = soak._build_corpus("phase0", 2)[3]
    assert roots == ref_roots and len(roots) == 16
    for key in ("blocks", "epochs", "faulted_epochs", "fired", "walk_stats",
                "rerun_stats"):
        assert section[key] == ref_section[key], key
    assert [s["breaker_state"] for s in section["cache_samples"]] == \
        [s["breaker_state"] for s in ref_section["cache_samples"]]


def _check_report(report, expected_forks):
    """The reference suite's report check (``tests/soak/test_soak.py``)."""
    assert report["failure"] is None
    assert [s["fork"] for s in report["forks"]] == list(expected_forks)
    for section in report["forks"]:
        assert section["walk_stats"]["breaker_state"] == "closed"
        assert section["walk_stats"]["breaker_trips"] >= 1
        assert section["rerun_stats"]["replayed_blocks"] == 0
        assert section["rerun_stats"]["fast_blocks"] == section["blocks"]
        assert section["fired"], "no scheduled fault fired"
        for sample in section["cache_samples"]:
            for entry in sample["sizes"]:
                if entry["cap"]:
                    assert entry["size"] <= entry["cap"], entry
        rss = [s["rss_mb"] for s in section["cache_samples"]]
        assert all(r is None or r > 0 for r in rss)
        flat = section["rss_flatness"]
        if flat is not None:
            assert flat["flat"], flat
            assert flat["final_mb"] > 0 and flat["budget_mb"] >= 128.0
    assert report["snapshot"]["providers"]["stf.engine"]
    kinds = [e["kind"] for e in report["timeline"]]
    assert "breaker_open" in kinds and "breaker_close" in kinds
    assert kinds.index("breaker_open") < kinds.index("breaker_close")


@pytest.mark.slow
def test_soak_bounded(own_snapshots):
    out = own_snapshots / "soak.json"
    report = soak.run_soak("bounded", out_path=str(out), device="cpu")
    _check_report(report, ("phase0", "altair"))
    on_disk = json.loads(out.read_text())
    assert on_disk["profile"] == "bounded" and on_disk["failure"] is None
    assert on_disk["device"] == "cpu" and on_disk["timeline"]
