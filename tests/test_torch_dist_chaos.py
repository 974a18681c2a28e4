"""The port's process fabric under injected failures, the counterpart of
the JAX package's ``tests/chaos/test_dist_chaos.py``: a worker killed
mid-chunk, heartbeats starved, reply frames corrupted on the wire, spawns
dying, dispatch sends failing, no survivors, the breaker's demote, probe
and recover cycle, the verify lane's bisection under a kill, and scoped
plans.  Each must leave results bit-identical to the in-process twin
(and, for the roots and the bisection, to the JAX package's), keep
serving (the executor ladder demotes, never halts), and account every
re-dispatch.

Every outcome comes from a fault plan, never from a race against the
clock.  The cross-process half of each schedule ships to the workers via
``CSTPU_FAULTS`` with per-process scope (``site@nth=kind@procK``), which
the port's ``faults.py`` arms from ``CSTPU_DIST_PROC`` at import.

``COVERED_SITES`` closes the port's fault registry over its ``dist.*``
sites, as the reference's ``tests/chaos/test_registry_complete.py`` does.
"""
import hashlib
import warnings

import numpy as np
import pytest

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.dist import dispatch, fabric as fabmod, workloads
from consensus_specs_tpu_torch.dist.dispatch import (
    FabricDown,
    FabricExecutor,
    TaskSpec,
)
from consensus_specs_tpu_torch.dist.fabric import Fabric, FabricUnavailable

F = faults.Fault

COVERED_SITES = {"dist.spawn", "dist.dispatch", "dist.reply",
                 "dist.heartbeat", "dist.worker.exec"}


@pytest.fixture(autouse=True)
def _fresh_stats():
    dispatch.reset_stats()
    fabmod.reset_stats()
    yield


def _echo_expect(bodies):
    return [hashlib.sha256(b).digest() + b for b in bodies]


def _run_echo(fab, n=8, **opts):
    bodies = [f"c{i}".encode() for i in range(n)]
    out = dispatch.run_tasks(
        fab, [TaskSpec("echo", {}, b) for b in bodies],
        deadline_s=opts.pop("deadline_s", 60.0), **opts)
    return [body for _, body in out], _echo_expect(bodies)


# -- worker killed mid-chunk ---------------------------------------------------


def test_worker_kill_mid_chunk_redispatches_with_parity():
    """proc1 dies (os._exit) while its 2nd chunk is in flight — no reply,
    the channel EOFs — and every chunk it held goes back out to the
    survivor.  The batch result is byte-identical."""
    plan = faults.FaultPlan([F("dist.worker.exec", nth=2, kind="crash",
                               proc="proc1")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            got, want = _run_echo(fab)
    assert got == want
    snap = dispatch.snapshot()
    assert snap["redispatched_chunks"] > 0
    assert snap["worker_losses"] == 1
    assert fabmod.snapshot()["channel_losses"] >= 1


def test_merkle_root_parity_under_worker_kill():
    """Roots, not just echoes: the chunked uint64 list root under a kill
    schedule equals the JAX package's SSZ root AND the in-process twin."""
    from consensus_specs_tpu.ssz.types import List as RefList, uint64

    rng = np.random.default_rng(20)
    arr = rng.integers(0, 2**63 - 1, size=1024, dtype=np.int64)
    limit = 4096
    oracle = bytes(RefList[uint64, limit]([int(x) for x in arr])
                   .hash_tree_root())
    plan = faults.FaultPlan([F("dist.worker.exec", nth=1, kind="crash",
                               proc="proc2")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            ex = FabricExecutor(fab)
            root, mode = workloads.uint64_list_root(
                ex, arr, limit, n_chunks=2, deadline_s=60.0)
    assert mode == "fabric"  # the ladder did NOT need to demote
    assert root == oracle
    assert dispatch.snapshot()["redispatched_chunks"] > 0


# -- heartbeat starvation ------------------------------------------------------


def test_heartbeat_starvation_demotes_to_inprocess_without_halting():
    """A sticky coordinator-side drop of every beat starves liveness for
    BOTH workers past the timeout; with no survivors the batch is
    FabricDown — and the executor ladder serves it in-process anyway.
    The chunks sleep far past the timeout, so no reply can beat it."""
    plan = faults.FaultPlan([F("dist.heartbeat", nth=1, sticky=True,
                               proc="proc0")])
    bodies = [b"hb-0", b"hb-1"]
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.05) as fab:
            ex = FabricExecutor(fab)

            def on_fabric(f):
                out = dispatch.run_tasks(
                    f, [TaskSpec("sleep_echo", {"seconds": 60.0}, b)
                        for b in bodies],
                    deadline_s=120.0, heartbeat_timeout_s=0.5)
                return [body for _, body in out]

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got, mode = ex.run(on_fabric, lambda: _echo_expect(bodies))
    assert mode == "inprocess"  # demoted, never halted
    assert any(issubclass(c.category, RuntimeWarning) for c in caught) \
        or dispatch._DEGRADE_WARNED  # the one-time operator warning fired
    assert got == _echo_expect(bodies)
    snap = dispatch.snapshot()
    assert snap["heartbeat_timeouts"] >= 1
    assert snap["fallback_runs"] == 1
    assert fabmod.snapshot()["heartbeats_dropped"] >= 1
    assert plan.fired  # the seam actually starved


# -- corrupt reply frames ------------------------------------------------------


def test_corrupt_reply_frame_is_detected_and_redispatched():
    """A flipped byte in a reply envelope fails the digest check — a
    DETECTED miss: the replying worker is demoted (frame sync is gone),
    its chunks re-dispatch, and the merged result is byte-identical."""
    plan = faults.FaultPlan([F("dist.reply", nth=1, kind="corrupt",
                               proc="proc0")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            got, want = _run_echo(fab)
    assert got == want
    assert fabmod.snapshot()["corrupt_replies"] == 1
    snap = dispatch.snapshot()
    assert snap["redispatched_chunks"] > 0
    assert snap["worker_losses"] == 1
    assert plan.fired


# -- spawn failures ------------------------------------------------------------


def test_spawn_failure_runs_on_survivors():
    plan = faults.FaultPlan([F("dist.spawn", nth=2)])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            assert len(fab.alive_workers()) == 1
            got, want = _run_echo(fab, n=4)
    assert got == want
    assert fabmod.snapshot()["spawn_failures"] == 1
    assert plan.fired


def test_all_spawns_failing_raises_fabric_unavailable():
    plan = faults.FaultPlan([F("dist.spawn", nth=1, sticky=True)])
    with faults.inject(plan):
        fab = Fabric(n_workers=2, heartbeat_interval=0.1)
        with pytest.raises(FabricUnavailable):
            fab.start()
        fab.close()
    assert fabmod.snapshot()["spawn_failures"] == 2
    assert faults.process_scope() is None  # close() restored the scope


def test_all_spawns_failing_demotes_through_the_ladder():
    """Even a fabric that can never spawn serves: the executor falls back
    to the in-process twin on FabricUnavailable."""
    bodies = [b"s0", b"s1"]
    plan = faults.FaultPlan([F("dist.spawn", nth=1, sticky=True)])
    with faults.inject(plan):
        fab = Fabric(n_workers=2, heartbeat_interval=0.1)
        ex = FabricExecutor(fab)
        got, mode = ex.run(
            lambda f: pytest.fail("fabric_fn must not run with 0 workers"),
            lambda: _echo_expect(bodies))
        fab.close()
    assert mode == "inprocess"
    assert got == _echo_expect(bodies)
    assert dispatch.snapshot()["fallback_runs"] == 1


# -- dispatch-side send failures -----------------------------------------------


def test_dispatch_error_loses_the_worker_and_redispatches():
    plan = faults.FaultPlan([F("dist.dispatch", nth=1, proc="proc0")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            got, want = _run_echo(fab)
    assert got == want
    snap = dispatch.snapshot()
    assert snap["redispatched_chunks"] > 0
    assert snap["worker_losses"] == 1
    assert plan.fired


def test_no_survivors_is_fabric_down_not_a_hang():
    """Sticky dispatch failure kills every send: the batch must surface
    FabricDown promptly (the ladder's cue), never wedge the loop."""
    plan = faults.FaultPlan([F("dist.dispatch", nth=1, sticky=True,
                               proc="proc0")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            with pytest.raises(FabricDown):
                _run_echo(fab, n=4)


# -- the breaker ladder: demote -> probe -> recover ----------------------------


def test_breaker_demote_probe_recover_cycle():
    """Three consecutive fabric failures trip the breaker; while open,
    runs demote straight to in-process; the BREAKER_PROBE_INTERVAL-th
    demoted run probes (after respawning the dead workers) and recovery
    closes the breaker.  Every run returns the correct value."""
    bodies = [b"b0", b"b1", b"b2", b"b3"]
    want = _echo_expect(bodies)

    def on_fabric(f):
        out = dispatch.run_tasks(
            f, [TaskSpec("echo", {}, b) for b in bodies], deadline_s=60.0)
        return [body for _, body in out]

    modes = []
    with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
        ex = FabricExecutor(fab)
        # phase A: every send fails -> FabricDown x3 -> breaker opens
        plan = faults.FaultPlan([F("dist.dispatch", nth=1, sticky=True,
                                   proc="proc0")])
        with faults.inject(plan):
            for _ in range(dispatch.BREAKER_THRESHOLD):
                got, mode = ex.run(on_fabric, lambda: list(want))
                assert got == want
                modes.append(mode)
        assert ex.breaker_open
        assert dispatch.snapshot()["breaker_trips"] == 1
        assert dispatch.snapshot()["breaker_state"] == "open"

        # phase B: fault cleared; open breaker demotes runs 1..N-1, the
        # N-th probes a RESPAWNED fabric and recovers
        for _ in range(dispatch.BREAKER_PROBE_INTERVAL):
            got, mode = ex.run(on_fabric, lambda: list(want))
            assert got == want
            modes.append(mode)
        assert not ex.breaker_open
        # phase C: recovered — fabric serves again
        got, mode = ex.run(on_fabric, lambda: list(want))
        assert got == want
        modes.append(mode)

    n_demoted = dispatch.BREAKER_THRESHOLD + dispatch.BREAKER_PROBE_INTERVAL - 1
    assert modes == ["inprocess"] * n_demoted + ["fabric", "fabric"]
    snap = dispatch.snapshot()
    assert snap["breaker_probes"] == 1
    assert snap["recoveries"] == 1
    assert snap["breaker_state"] == "closed"
    assert snap["fallback_runs"] == n_demoted
    assert fabmod.snapshot()["respawns"] >= 2  # the probe repaired the pool


# -- the verify lane: bisection naming across the boundary ---------------------


def _sig_entry(sks, msg, valid=True):
    from consensus_specs_tpu_torch.crypto.bls import native

    signed = msg if valid else hashlib.sha256(msg).digest()
    sig = native.Aggregate([native.Sign(sk, signed) for sk in sks])
    flat = b"".join(native.pubkey_affine(native.SkToPk(sk)) for sk in sks)
    return (len(sks), flat, bytes(msg), sig)


def test_bisection_names_same_entry_under_worker_kill():
    """Chunked ``first_invalid`` through the fabric — WITH a worker
    killed mid-run — names the exact entry the JAX package's in-process
    bisection names."""
    from consensus_specs_tpu.stf import verify as ref_verify

    entries = [_sig_entry([3 * i + 1, 3 * i + 2], bytes([i]) * 32,
                          valid=(i != 9))
               for i in range(12)]
    want = ref_verify.first_invalid(entries)
    assert want == 9  # the oracle names the planted failure
    plan = faults.FaultPlan([F("dist.worker.exec", nth=1, kind="crash",
                               proc="proc2")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1, device="cpu") as fab:
            ex = FabricExecutor(fab)
            got, mode = workloads.batch_first_invalid(
                ex, entries, n_chunks=2, deadline_s=120.0)
    assert mode == "fabric"
    assert got == want  # same leftmost failure, same name
    assert dispatch.snapshot()["redispatched_chunks"] > 0


# -- cross-process plan transport ---------------------------------------------


def test_scoped_plan_reaches_only_the_addressed_worker():
    """One plan string, two workers: the crash addressed to proc1 fires
    there and ONLY there (the worker's faults.py took its scope from
    CSTPU_DIST_PROC) — proc2 serves the whole batch."""
    plan = faults.FaultPlan([F("dist.worker.exec", nth=1, kind="crash",
                               proc="proc1")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
            got, want = _run_echo(fab, n=6)
            survivors = {w.name for w in fab.alive_workers()}
    assert got == want
    assert survivors == {"proc2"}
    assert dispatch.snapshot()["worker_losses"] == 1


# -- the port's fault registry -------------------------------------------------


def test_dist_sites_are_registered_and_covered():
    """The process-boundary seams exist in the port's own registry AND
    each carries a case here: coordinator-side (spawn, dispatch, reply,
    heartbeat) and the worker-side execution probe a scoped plan crosses
    the process boundary to reach."""
    import consensus_specs_tpu_torch.dist.worker  # noqa: F401

    dist_sites = {n for n in faults.registry() if n.startswith("dist.")}
    assert dist_sites == COVERED_SITES
