"""Soak-endurance harness (the telemetry subsystem's fourth layer).

The chaos suite proves containment per fault; the benches prove speed per
run.  Neither watches the system *over time* — a breaker that recovers in
a 10-block test can still wedge open across epochs, a bounded cache can
still creep, and a regression between headline benches is invisible.
The soak run closes that gap: a long seeded random block/attestation
walk, epochs alternately faulted (seeded ``FaultPlan`` schedules over the
stf seams, error + corrupt kinds — crashes are chaos-suite territory:
native degradation is one-way by design and would fail the recovery
claim vacuously) and clean, with four endurance assertions:

* **breaker recovery** — the first faulted epoch deterministically trips
  the breaker (three consecutive injected errors); by the end of the
  walk's trailing clean epochs the breaker must be CLOSED again, through
  its own probe machinery (never re-armed by the harness);
* **root parity throughout** — every block's post-state root matches the
  literal spec replay, faults or no faults;
* **cache coherence** — a fault-free re-run of the whole walk over the
  SAME process-global caches takes the fast path on every block
  (``replayed_blocks == 0``): no fault in any epoch stranded a poisoned
  entry;
* **memory flatness** — after every epoch, each bounded cache/ring
  (attestation plans, geometry memos, verified triples, resident
  columns, sync seats, the flight-recorder ring, the causal-timeline
  ring) is sampled off the telemetry bus and must sit at or under its
  registered cap; AND the process RSS itself is sampled per epoch —
  cap checks prove each *known* structure is bounded, the RSS series
  proves nothing UNKNOWN is growing either.  After a warmup quarter the walk's RSS must stay
  within a bounded-growth budget of its warmup level.

The run emits a JSON report (``SOAK_torch.json`` at the repository root
unless ``out_path`` names another file; never the JAX package's
``SOAK.json``): profile, per-epoch cache samples, the engine/verify
counters, the full telemetry snapshot, and the flight recorder's last-N
timeline — the artifact IS the post-mortem when an
assertion trips (written before the failure is raised).

Profiles: ``bounded`` (phase0 + altair, 32 epochs each — long enough for
finality to advance, FIFO memos to rotate, and the plan cache to shed old
epochs) is the default; ``deep`` (96 epochs each) is the slow endurance
tier.  Orthogonal to both, ``run_endurance`` loops the bounded corpus
under a WALL-CLOCK budget (``CSTPU_SOAK_MINUTES``) and asserts the same
flatness envelope over the whole multi-pass RSS series — the multi-hour
flat-RSS lever.  An ambient ``CSTPU_FAULTS`` schedule stays armed during
the walk's clean epochs (extra chaos, same assertions) but is masked
during the verification re-run, which must be genuinely fault-free to
prove coherence.

The walk runs on the specs of one device: ``run_soak(..., device=)`` and
``run_endurance(..., device=)`` build them through the testing context
(``testing.context.set_spec_device``), None meaning the CUDA card (which
raises on a host without one), and restore the context's device, the BLS
switch and backend and the recorder's ring on exit.  Run it with

    python -m consensus_specs_tpu_torch.telemetry.soak [bounded|deep|endurance]
        [--device cpu] [--out PATH]
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

PROFILES = {
    # ring_cap sizes the flight recorder to hold the WHOLE walk (still a
    # bound — flatness is asserted against it like every other cap); the
    # default 512-event ring is tuned for serving, not endurance reports
    "bounded": {"forks": ("phase0", "altair"), "epochs": 32,
                "ring_cap": 4096},
    "deep": {"forks": ("phase0", "altair"), "epochs": 96,
             "ring_cap": 16384},
}

# the seams soak schedules draw from: every stf site the chaos suite
# already proves containment for, minus nothing — kinds are restricted
# instead (error/corrupt only, see module docstring)
_SOAK_KINDS = ("error", "corrupt")


class SoakFailure(AssertionError):
    """An endurance assertion failed; the report carries the post-mortem."""


# RSS flatness budget: after the warmup quarter (caches filling, native
# pools spinning up), growth to the END of the walk must stay under
# max(_RSS_BUDGET_MB, _RSS_BUDGET_FRAC * warmup level) — loose enough
# that allocator noise and page-cache jitter never flake the gate,
# tight enough that a leaked per-epoch structure (the failure mode cap
# checks cannot see) trips it within one soak
_RSS_BUDGET_MB = 128.0
_RSS_BUDGET_FRAC = 0.25


def process_rss_mb() -> Optional[float]:
    """Current resident-set size of this process in MB — /proc-based on
    Linux (current residency, the flatness signal), falling back to
    ru_maxrss (peak; still monotone-growth-detecting) elsewhere; None
    when neither source works (the flatness assert then skips rather
    than flaking)."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:
        return None


def rss_flatness(samples) -> Optional[dict]:
    """The bounded-growth verdict over a per-epoch RSS series: compares
    the end of the walk against the post-warmup level (first quarter,
    minimum one epoch) and returns {baseline_mb, final_mb, growth_mb,
    budget_mb, flat}; None when the series is too short or unsampled."""
    series = [s for s in samples if s is not None]
    if len(series) < 2:
        return None
    warmup = max(1, len(series) // 4)
    baseline = min(series[warmup - 1:warmup + 1])
    final = series[-1]
    budget = max(_RSS_BUDGET_MB, _RSS_BUDGET_FRAC * baseline)
    growth = final - baseline
    return {"baseline_mb": round(baseline, 1), "final_mb": round(final, 1),
            "growth_mb": round(growth, 1), "budget_mb": round(budget, 1),
            "warmup_epochs": warmup, "flat": growth <= budget}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_out_path() -> str:
    """Where a run writes its report unless told otherwise: the
    repository root's ``SOAK_torch.json`` (git-ignored)."""
    return os.path.join(_repo_root(), "SOAK_torch.json")


def _stf_sites() -> List[str]:
    from consensus_specs_tpu_torch import faults, stf  # noqa: F401  (registers sites)

    return sorted(n for n in faults.registry() if n.startswith("stf."))


def _build_corpus(fork: str, epochs: int):
    """(spec, pre_state, signed_blocks, per-block literal roots) for an
    ``epochs``-long full-block walk (the chaos corpus pattern, longer)."""
    from consensus_specs_tpu_torch.query import coldstart
    from consensus_specs_tpu_torch.testing.context import (
        spec_state_test,
        with_phases,
    )
    from consensus_specs_tpu_torch.testing.helpers.attestations import (
        next_slots_with_attestations,
    )
    from consensus_specs_tpu_torch.testing.helpers.state import next_epoch

    out = {}

    @with_phases([fork])
    @spec_state_test
    def build(spec, state):
        next_epoch(spec, state)
        # the soak's pre-state rides the universal cold-start seam —
        # restored byte-identical from the snapshot artifact when one
        # matches (CSTPU_NO_CHECKPOINT_SYNC=1 forces the literal build),
        # built and snapshotted otherwise
        pre = coldstart.restore_or_build(
            spec, len(state.validators), state.copy, label="soak")
        _, signed, _ = next_slots_with_attestations(
            spec, pre.copy(), epochs * int(spec.SLOTS_PER_EPOCH),
            True, True)
        s = pre.copy()
        roots = []
        for sb in signed:
            spec.state_transition(s, sb, True)
            roots.append(bytes(s.hash_tree_root()))
        out["corpus"] = (spec, pre, signed, roots)
        yield None

    build(phase=fork)  # DEFAULT_BLS_ACTIVE: signatures are real
    return out["corpus"]


def _pipeline_inflight_cap() -> int:
    # the engine's speculation window is a constant here (the reference
    # reads it from CSTPU_PIPELINE_DEPTH, default 2)
    from consensus_specs_tpu_torch.stf import engine

    return engine._WINDOW_DEPTH + 1


def bounded_cache_sizes() -> List[dict]:
    """(name, size, cap) of every bounded structure the telemetry bus
    reports — the memory-flatness sample."""
    import consensus_specs_tpu_torch.node.admission  # noqa: F401  (registers provider)
    import consensus_specs_tpu_torch.query  # noqa: F401  (registers provider)

    from . import snapshot

    providers = snapshot()["providers"]
    plan = providers.get("stf.plan_cache", {})
    verify = providers.get("stf.verify", {})
    columns = providers.get("stf.columns", {})
    sync = providers.get("stf.sync", {})
    ring = providers.get("flight_recorder", {})
    samples = [
        {"name": "stf.plan_cache.plan", "size": plan.get("plan_size", 0),
         "cap": plan.get("plan_cap", 0)},
        {"name": "stf.verify.memo", "size": verify.get("memo_size", 0),
         "cap": verify.get("memo_cap", 0)},
        {"name": "stf.columns.store", "size": columns.get("size", 0),
         "cap": columns.get("cap", 0)},
        # the residency stores + the pipeline's in-flight queue:
        # bounded like everything else, flatness-asserted per epoch
        {"name": "stf.columns.balances",
         "size": columns.get("balance_size", 0),
         "cap": columns.get("balance_cap", 0)},
        {"name": "stf.columns.device_buffers",
         "size": columns.get("device_size", 0),
         "cap": columns.get("device_cap", 0)},
        {"name": "stf.pipeline.inflight",
         "size": providers.get("stf.pipeline", {}).get("depth", 0),
         # the engine's bound: window_depth + the current block's dispatch
         "cap": _pipeline_inflight_cap()},
        {"name": "stf.sync.rows_memo",
         "size": sync.get("rows_memo_size", 0), "cap": sync.get("cap", 0)},
        {"name": "flight_recorder.ring", "size": ring.get("events", 0),
         "cap": ring.get("cap", 0)},
        # the causal-timeline ring: bounded like the flight
        # recorder's, flatness-asserted the same way
        {"name": "timeline.ring",
         "size": providers.get("timeline", {}).get("events", 0),
         "cap": providers.get("timeline", {}).get("cap", 0)},
    ]
    # the node admission survival structures: orphan pool,
    # parked ring, dead-letter ring, seen-set, and the peer-score table
    # all carry caps on the bus — a soak (or the adversarial firehose)
    # proves they stay bounded over every epoch
    adm = providers.get("node.admission", {})
    for name, size_key, cap_key in (
            ("node.admission.orphans", "orphan_pool_depth",
             "orphan_pool_cap"),
            ("node.admission.parked", "parked_depth", "parked_cap"),
            ("node.admission.dead_letters", "dead_letter_depth",
             "dead_letter_cap"),
            ("node.admission.seen", "seen_size", "seen_cap"),
            ("node.admission.scores", "scores_size", "scores_cap"),
            ("node.admission.aggregation", "agg_depth", "agg_cap")):
        samples.append({"name": name, "size": adm.get(size_key, 0),
                        "cap": adm.get(cap_key, 0)})
    for key in ("ctx_size", "ctx_lookup_size", "plan_ctx_lookup_size",
                "active_size", "proposer_size"):
        samples.append({"name": f"stf.plan_cache.{key[:-5]}",
                        "size": plan.get(key, 0),
                        "cap": plan.get("geometry_cap", 0)})
    # the durable checkpoint store: checkpoints on disk are a
    # bounded ring like everything else — prune-on-finalization must
    # hold the depth at its cap over any number of epochs
    persist = providers.get("persist", {})
    samples.append({"name": "persist.checkpoints",
                    "size": persist.get("size", 0),
                    "cap": persist.get("cap", 0)})
    # the historical read path: the live query engine's
    # artifact index, proof cache, and resident-state set are bounded
    # LRUs on the bus — flatness-asserted like every other cache (when
    # no engine is live the gauges are absent and cap=0 skips the check)
    q = providers.get("query", {})
    for name, size_key, cap_key in (
            ("query.artifact_index", "artifact_index_size",
             "artifact_index_cap"),
            ("query.proof_cache", "proof_cache_size", "proof_cache_cap"),
            ("query.resident", "resident_size", "resident_cap")):
        samples.append({"name": name, "size": q.get(size_key, 0),
                        "cap": q.get(cap_key, 0)})
    return samples


def _epoch_plan(epoch_index: int, seed: int, sites: List[str],
                breaker_trip: bool):
    """The fault schedule of one faulted epoch: a deterministic breaker
    trip (three consecutive early errors) on the first, seeded random
    error/corrupt draws on the rest."""
    from consensus_specs_tpu_torch import faults

    if breaker_trip:
        trip = [faults.Fault("stf.engine.operations", nth=n)
                for n in (1, 2, 3)]
        extra = faults.FaultPlan.seeded(
            seed + epoch_index, sites, n_faults=2, max_nth=6,
            kinds=_SOAK_KINDS).faults()
        return faults.FaultPlan(trip + extra)
    return faults.FaultPlan.seeded(
        seed + epoch_index, sites, n_faults=3, max_nth=8,
        kinds=_SOAK_KINDS)


def _fresh_engine_env() -> None:
    from consensus_specs_tpu_torch import stf
    from consensus_specs_tpu_torch.stf import attestations as stf_attestations
    from consensus_specs_tpu_torch.stf import verify as stf_verify

    stf.reset_stats()
    stf_verify.reset_memo()
    stf_verify.reset_degraded()
    stf_attestations.reset_caches()


def _soak_fork(fork: str, epochs: int, seed: int, report: dict) -> dict:
    """One fork's endurance walk; returns the fork's report section and
    raises ``SoakFailure`` (after dumping) on any broken assertion."""
    from consensus_specs_tpu_torch import faults, stf

    t0 = time.perf_counter()
    spec, pre, blocks, roots = _build_corpus(fork, epochs)
    t_corpus = time.perf_counter() - t0
    sites = _stf_sites()
    spe = int(spec.SLOTS_PER_EPOCH)
    epoch_chunks = [blocks[i:i + spe] for i in range(0, len(blocks), spe)]
    # faulted prefix, clean tail: the LAST TWO epochs always run clean so
    # the breaker has >= 2*SLOTS_PER_EPOCH blocks to probe its way closed
    n_faulted = max(1, len(epoch_chunks) - 2)

    _fresh_engine_env()
    section: dict = {"fork": fork, "blocks": len(blocks),
                     "epochs": len(epoch_chunks), "faulted_epochs": n_faulted,
                     "fired": [], "cache_samples": []}
    t0 = time.perf_counter()
    s = pre.copy()
    applied = 0
    for e, chunk in enumerate(epoch_chunks):
        plan = (_epoch_plan(e, seed, sites, breaker_trip=(e == 0))
                if e < n_faulted else None)
        ctx = faults.inject(plan) if plan is not None else _ambient()
        with ctx:
            for sb in chunk:
                stf.apply_signed_blocks(spec, s, [sb], True)
                if bytes(s.hash_tree_root()) != roots[applied]:
                    _fail(report, section,
                          f"{fork}: root diverged from the literal replay "
                          f"at block {applied} (epoch {e})")
                applied += 1
        if plan is not None:
            section["fired"].extend(
                [site, hit, kind] for site, hit, kind in plan.fired)
        sample = {"epoch": e, "sizes": bounded_cache_sizes(),
                  "rss_mb": process_rss_mb(),
                  "breaker_state": stf.stats["breaker_state"]}
        section["cache_samples"].append(sample)
        for entry in sample["sizes"]:
            if entry["cap"] and entry["size"] > entry["cap"]:
                _fail(report, section,
                      f"{fork}: {entry['name']} grew past its cap after "
                      f"epoch {e}: {entry['size']} > {entry['cap']}")

    # RSS flatness: the per-epoch series must show bounded
    # growth past warmup — cap checks bound every KNOWN structure, this
    # catches a leak in anything the bus doesn't know about
    section["rss_flatness"] = rss_flatness(
        [s["rss_mb"] for s in section["cache_samples"]])
    if section["rss_flatness"] is not None \
            and not section["rss_flatness"]["flat"]:
        rf = section["rss_flatness"]
        _fail(report, section,
              f"{fork}: process RSS grew {rf['growth_mb']} MB past the "
              f"post-warmup level ({rf['baseline_mb']} MB), over the "
              f"{rf['budget_mb']} MB flatness budget")

    t_walk = time.perf_counter() - t0
    section["walk_stats"] = {
        **{k: stf.stats[k] for k in
           ("fast_blocks", "replayed_blocks", "breaker_trips",
            "breaker_probes", "breaker_skipped", "breaker_state")},
        "replay_reasons": dict(stf.stats["replay_reasons"]),
    }
    if stf.stats["breaker_state"] != "closed":
        _fail(report, section,
              f"{fork}: breaker still open after the clean tail "
              f"({stf.stats['breaker_trips']} trips, "
              f"{stf.stats['breaker_probes']} probes)")
    if n_faulted and not section["fired"]:
        _fail(report, section,
              f"{fork}: no scheduled fault ever fired — the walk "
              "exercised nothing")

    # cache coherence: fault-free re-run over the SAME caches (ambient
    # CSTPU_FAULTS masked by an empty plan) must be all-fast.  The
    # degraded mark is cleared the way an operator would after ambient
    # crash chaos — the claim under test is cache state, not the ladder
    from consensus_specs_tpu_torch.stf import verify as stf_verify

    stf.reset_stats()
    stf_verify.reset_degraded()
    t0 = time.perf_counter()
    s2 = pre.copy()
    with faults.inject(faults.FaultPlan([])):
        for i, sb in enumerate(blocks):
            stf.apply_signed_blocks(spec, s2, [sb], True)
            if bytes(s2.hash_tree_root()) != roots[i]:
                _fail(report, section,
                      f"{fork}: re-run root diverged at block {i}")
    # host seconds of the corpus build, the faulted walk (its RSS and cap
    # samples included) and the fault-free rerun
    section["seconds"] = {"corpus": t_corpus, "walk": t_walk,
                          "rerun": time.perf_counter() - t0}
    section["rerun_stats"] = {
        "fast_blocks": stf.stats["fast_blocks"],
        "replayed_blocks": stf.stats["replayed_blocks"],
        "replay_reasons": dict(stf.stats["replay_reasons"]),
    }
    if stf.stats["replayed_blocks"] != 0:
        _fail(report, section,
              f"{fork}: fault-free re-run replayed "
              f"{stf.stats['replayed_blocks']} blocks — a fault stranded "
              f"poisoned cache state: {stf.stats['replay_reasons']}")
    return section


def _ambient():
    """No-op context: the walk's clean epochs run under whatever ambient
    plan (CSTPU_FAULTS) is armed — soak under operator chaos is a
    supported mode."""
    import contextlib

    return contextlib.nullcontext()


def _fail(report: dict, section: dict, message: str) -> None:
    """Dump the post-mortem (the report + flight-recorder timeline), then
    raise — a failed soak carries its own flight data."""
    from . import recorder

    report["failure"] = message
    _finalize(report, section)
    _write(report)
    recorder.disable()
    raise SoakFailure(f"{message} (post-mortem: {report['out_path']})")


def _finalize(report: dict, *sections: dict) -> None:
    from . import recorder, snapshot

    for section in sections:
        if section is not None and section not in report["forks"]:
            report["forks"].append(section)
    report["snapshot"] = snapshot()
    report["timeline"] = recorder.timeline()


def _write(report: dict) -> None:
    path = report["out_path"]
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, default=str)
    # durable-io: the soak report is a human-readable run report, rewritten
    # per soak — not an integrity-checked artifact (no digest by design)
    os.replace(tmp, path)


@contextlib.contextmanager
def _soak_environment(device, ring_cap: int):
    """The process-wide settings a walk runs under, restored on exit: the
    testing context's spec device (``device``; None is the CUDA card,
    which raises here on a host without one), BLS on through the fastest
    host backend, and the flight recorder's ring at ``ring_cap``."""
    from consensus_specs_tpu_torch._device import resolve_device
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.testing import context

    from . import recorder

    resolved = str(resolve_device(device))
    prev_device = context.set_spec_device(resolved)
    prev_backend = bls.backend_name()
    prev_bls = bls.bls_active
    was_recording = recorder.enabled()
    prev_cap = recorder.stats()["cap"]
    try:
        bls.use_fastest()
        bls.bls_active = True
        recorder.enable(cap=ring_cap)
        recorder.reset()
        yield resolved
    finally:
        context.set_spec_device(prev_device)
        bls.use_backend(prev_backend)
        bls.bls_active = prev_bls
        # restore the PRE-RUN bound (an operator-configured ambient
        # recorder must not come back shrunk to the default)
        recorder.enable(cap=prev_cap)
        if not was_recording:
            recorder.disable()


def run_soak(profile: str = "bounded", seed: int = 90001,
             out_path: Optional[str] = None, device=None) -> Dict:
    """Run the soak-endurance walk on specs built for ``device`` (None:
    the CUDA card) and write its report to ``out_path`` (default
    ``default_out_path()``).  Returns the report dict; raises
    ``SoakFailure`` on any broken endurance assertion (the report is
    written first, either way)."""
    if profile not in PROFILES:
        raise ValueError(f"unknown soak profile {profile!r} "
                         f"(one of {sorted(PROFILES)})")
    cfg = PROFILES[profile]
    out_path = out_path or default_out_path()
    with _soak_environment(device, cfg["ring_cap"]) as resolved:
        report: Dict = {"profile": profile, "seed": seed, "config": dict(cfg),
                        "device": resolved, "out_path": out_path,
                        "forks": [], "failure": None}
        for fork in cfg["forks"]:
            report["forks"].append(
                _soak_fork(fork, cfg["epochs"], seed, report))
        _finalize(report)
        _write(report)
    return report


def run_endurance(minutes: Optional[float] = None,
                  out_path: Optional[str] = None, device=None) -> Dict:
    """Wall-clock-budgeted endurance mode (``CSTPU_SOAK_MINUTES``): build
    the bounded corpus once on specs built for ``device`` (None: the CUDA
    card), then loop fault-free full passes over it until the budget
    expires, sampling every bounded cap and the process RSS after each
    epoch and asserting the SAME flatness envelope over the whole
    multi-pass series — the multi-hour flat-RSS lever.  At least one full
    pass always completes, however small the budget; a started pass
    always finishes (root parity is per block, so the series stays
    pass-aligned).  Clean passes run under whatever ambient
    ``CSTPU_FAULTS`` plan is armed, like the walk's clean epochs —
    containment keeps parity either way."""
    from consensus_specs_tpu_torch import stf

    if minutes is None:
        minutes = float(os.environ.get("CSTPU_SOAK_MINUTES", "0") or 0.0)
    if minutes <= 0:
        raise ValueError(
            "endurance soak needs a positive wall-clock budget "
            "(CSTPU_SOAK_MINUTES=<minutes> or minutes=...)")
    cfg = PROFILES["bounded"]
    out_path = out_path or default_out_path()
    section: Dict = {"mode": "endurance", "budget_minutes": minutes,
                     "passes": 0, "blocks_applied": 0, "cache_samples": []}
    with _soak_environment(device, cfg["ring_cap"]) as resolved:
        report: Dict = {"profile": "endurance",
                        "config": {**cfg, "minutes": minutes},
                        "device": resolved, "out_path": out_path,
                        "forks": [], "failure": None}
        corpora = {fork: _build_corpus(fork, cfg["epochs"])
                   for fork in cfg["forks"]}
        _fresh_engine_env()
        start = time.monotonic()
        deadline = start + minutes * 60.0
        while section["passes"] == 0 or time.monotonic() < deadline:
            for fork in cfg["forks"]:
                spec, pre, blocks, roots = corpora[fork]
                spe = int(spec.SLOTS_PER_EPOCH)
                s = pre.copy()
                applied = 0
                with _ambient():
                    for off in range(0, len(blocks), spe):
                        for sb in blocks[off:off + spe]:
                            stf.apply_signed_blocks(spec, s, [sb], True)
                            if bytes(s.hash_tree_root()) != roots[applied]:
                                _fail(report, section,
                                      f"{fork}: root diverged from the "
                                      f"literal replay at block {applied} "
                                      f"(pass {section['passes']})")
                            applied += 1
                            section["blocks_applied"] += 1
                        sample = {"pass": section["passes"], "fork": fork,
                                  "epoch": off // spe,
                                  "sizes": bounded_cache_sizes(),
                                  "rss_mb": process_rss_mb(),
                                  "breaker_state": stf.stats["breaker_state"]}
                        section["cache_samples"].append(sample)
                        for entry in sample["sizes"]:
                            if entry["cap"] and entry["size"] > entry["cap"]:
                                _fail(report, section,
                                      f"{fork}: {entry['name']} grew past "
                                      f"its cap in pass "
                                      f"{section['passes']}: "
                                      f"{entry['size']} > {entry['cap']}")
            section["passes"] += 1
        section["elapsed_s"] = round(time.monotonic() - start, 1)
        section["walk_stats"] = {
            **{k: stf.stats[k] for k in
               ("fast_blocks", "replayed_blocks", "breaker_trips",
                "breaker_probes", "breaker_skipped", "breaker_state")},
            "replay_reasons": dict(stf.stats["replay_reasons"]),
        }
        # the endurance claim: over however many passes the budget
        # bought, RSS past warmup stays inside the same bounded-growth
        # envelope the per-walk soak asserts — a per-pass leak (the
        # failure mode a single bounded walk cannot see) compounds
        # across passes and trips this within a handful of them
        section["rss_flatness"] = rss_flatness(
            [smp["rss_mb"] for smp in section["cache_samples"]])
        if section["rss_flatness"] is not None \
                and not section["rss_flatness"]["flat"]:
            rf = section["rss_flatness"]
            _fail(report, section,
                  f"endurance: process RSS grew {rf['growth_mb']} MB past "
                  f"the post-warmup level ({rf['baseline_mb']} MB) across "
                  f"{section['passes']} passes, over the {rf['budget_mb']} "
                  f"MB flatness budget")
        _finalize(report, section)
        _write(report)
    return report


def main(argv=None) -> Dict:
    import argparse

    parser = argparse.ArgumentParser(
        description="Soak-endurance walk of the port's block engine.")
    parser.add_argument("profile", nargs="?", default="bounded",
                        choices=sorted(PROFILES) + ["endurance"])
    parser.add_argument("--device", default=None,
                        help="device the specs are built for (default: the "
                             "CUDA card; 'cpu' runs on the host)")
    parser.add_argument("--out", default=None,
                        help=f"report path (default {default_out_path()})")
    args = parser.parse_args(argv)
    if args.profile == "endurance":
        report = run_endurance(out_path=args.out, device=args.device)
    else:
        report = run_soak(args.profile, out_path=args.out, device=args.device)
    print(f"soak green ({args.profile}): {report['out_path']} written")
    return report


if __name__ == "__main__":  # pragma: no cover - operator entry point
    main()
