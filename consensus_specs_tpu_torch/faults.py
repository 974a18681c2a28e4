"""Deterministic fault injection: named probes + seeded fault plans.

The engines' whole correctness story rests on containment contracts —
"any trouble rolls the block back and replays the literal spec"
(stf/engine.py), "validation precedes any vote landing"
(forkchoice/batch.py).  Those contracts are only real if failure is a
first-class tested path, so every fragile seam registers a named **fault
site** at import time and probes it on the hot path:

    _SITE = faults.site("stf.verify.native_call")   # module scope
    ...
    _SITE()                    # probe: no-op unless a plan targets it
    value = _SITE(value)       # probe that can corrupt a flowing value

Disabled (the default), a probe is one module-global load and a None
check — nothing to measure in a phase breakdown.  A **FaultPlan** arms
sites with (fire-on-Nth-hit → action) rules:

* ``error``   — raise ``InjectedFault`` (a RuntimeError: the generic
  "something broke mid-phase" the rollback contract must contain);
* ``crash``   — raise ``InjectedBackendCrash`` (an OSError: a native
  backend dying under the caller, feeding the degradation ladder);
* ``corrupt`` — return a deterministically corrupted COPY of the probed
  value (bit flip / off-by-one), modeling poisoned buffers.  On a
  valueless probe it degenerates to ``error``.

Plans activate via ``with faults.inject(plan):`` (tests) or the
``CSTPU_FAULTS`` environment variable (bench/CI chaos runs), e.g.::

    CSTPU_FAULTS="stf.verify.native_call@2=error,stf.sync.rows_memo=corrupt"

Each directive is ``site[@nth][=kind][@procK]`` (nth defaults to 1, kind
to ``error``); ``@nth+`` makes the fault sticky (fires on every hit from
the Nth on).  The trailing ``@procK`` scopes the fault to ONE process of
the dist fabric (``proc0`` is the coordinator, ``proc1..N`` the
workers): the coordinator ships the whole plan to every worker via env,
and each process arms only the faults addressed to it.  With no fabric
active (no process scope set) the scope is ignored and the fault is
armed everywhere — existing plans behave identically.
``FaultPlan.seeded`` draws a reproducible random schedule over
a site subset — the chaos differential suite (tests/chaos/) replays
seeded block walks under such plans and asserts the containment
contracts hold byte-exactly.

Site names are unique by construction (``site()`` raises on a duplicate)
and the registry is closed over by tests/chaos/test_registry_complete.py:
a new site without a chaos case turns that gate red.
"""
from __future__ import annotations

import contextlib
import os
import random
import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Fault", "FaultPlan", "InjectedBackendCrash", "InjectedFault",
    "inject", "plan_from_env", "process_scope", "registry",
    "set_process_scope", "site",
]

KINDS = ("error", "crash", "corrupt")

# the only well-formed process scope: procK, K a decimal ordinal
# (proc0 = coordinator, proc1.. = dist workers)
_PROC_RE = re.compile(r"proc\d+")

# this process's identity within an active dist fabric (None outside
# one): the coordinator sets "proc0" while a fabric is alive, workers
# inherit theirs from CSTPU_DIST_PROC at spawn.  Scoped faults fire only
# in their addressed process WHEN a scope is set; with no fabric active
# the scope is ignored and scoped faults are armed everywhere.
_PROC_SCOPE: Optional[str] = None


class InjectedFault(RuntimeError):
    """A generic injected failure: the kind of mid-phase exception the
    engine's rollback contract must contain."""


class InjectedBackendCrash(OSError):
    """An injected native-backend crash (the ctypes layer dying under the
    caller): feeds the degradation ladder, not the generic error path."""


class Fault:
    """One armed rule: fire ``kind`` at ``site`` on the ``nth`` hit
    (1-based; ``sticky`` keeps firing from the nth hit on).  ``proc``
    scopes the rule to one process of the dist fabric (``"proc0"`` =
    coordinator, ``"proc1"``.. = workers); None fires in every
    process."""

    __slots__ = ("site", "nth", "kind", "sticky", "proc")

    def __init__(self, site: str, nth: int = 1, kind: str = "error",
                 sticky: bool = False, proc: Optional[str] = None):
        if nth < 1:
            raise ValueError(f"nth is 1-based, got {nth}")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        if proc is not None and not _PROC_RE.fullmatch(proc):
            raise ValueError(
                f"malformed process scope {proc!r} (expected procK, e.g. "
                "proc0 for the coordinator, proc1.. for workers)")
        self.site, self.nth, self.kind, self.sticky = site, int(nth), kind, sticky
        self.proc = proc

    def __repr__(self):  # deterministic, used in test ids
        tail = "+" if self.sticky else ""
        scope = f"@{self.proc}" if self.proc else ""
        return f"{self.site}@{self.nth}{tail}={self.kind}{scope}"


class FaultPlan:
    """A deterministic schedule of faults over named sites.

    Tracks per-site hit counts and records every firing in ``fired`` as
    ``(site, hit_number, kind)`` so a chaos case can assert its plan
    actually exercised the seam it claims to."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self._by_site: Dict[str, List[Fault]] = {}
        for f in faults:
            self._by_site.setdefault(f.site, []).append(f)
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str]] = []

    @classmethod
    def seeded(cls, seed: int, sites: Iterable[str], n_faults: int = 3,
               max_nth: int = 4, kinds: Iterable[str] = ("error",)) -> "FaultPlan":
        """Reproducible random schedule: ``n_faults`` draws of
        (site, nth ≤ max_nth, kind) over ``sites``."""
        rng = random.Random(seed)
        pool, kindpool = sorted(sites), list(kinds)
        return cls(Fault(rng.choice(pool), rng.randint(1, max_nth),
                         rng.choice(kindpool)) for _ in range(n_faults))

    def faults(self) -> List[Fault]:
        return [f for fs in self._by_site.values() for f in fs]

    def _hit(self, name: str, value):
        n = self.hits.get(name, 0) + 1
        self.hits[name] = n
        for f in self._by_site.get(name, ()):
            if (f.proc is not None and _PROC_SCOPE is not None
                    and f.proc != _PROC_SCOPE):
                continue  # addressed to another process of the fabric
            if n == f.nth or (f.sticky and n > f.nth):
                self.fired.append((name, n, f.kind))
                if f.kind == "error" or (f.kind == "corrupt" and value is None):
                    raise InjectedFault(f"injected fault at {name} (hit {n})")
                if f.kind == "crash":
                    raise InjectedBackendCrash(
                        f"injected backend crash at {name} (hit {n})")
                return _corrupt(value)
        return value


def _corrupt(value):
    """Deterministic type-directed corruption of a COPY (never mutates the
    probed object in place — in-place damage to a cached array would
    bypass the very undo logs the chaos suite exists to prove out)."""
    import numpy as np

    if isinstance(value, np.ndarray):
        out = value.copy()
        if out.size:
            if out.dtype == bool:
                out.flat[0] = not out.flat[0]
            else:
                out.flat[0] += 1
        return out
    if isinstance(value, (bytes, bytearray)):
        if not len(value):
            return value
        out = bytearray(value)
        out[0] ^= 0x01
        return bytes(out)
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    raise InjectedFault(f"no corruption rule for {type(value).__name__}")


# -- site registry -------------------------------------------------------------

_SITES: Dict[str, "Site"] = {}
_PLAN: Optional[FaultPlan] = None


class Site:
    """A registered probe point.  Calling it is the probe: near-zero-cost
    when no plan is active, else the plan decides (raise / corrupt /
    pass through)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, value=None):
        plan = _PLAN
        if plan is None:
            return value
        return plan._hit(self.name, value)

    def __repr__(self):
        return f"<fault site {self.name}>"


def site(name: str) -> Site:
    """Register (at import time) and return the named probe.  Names are
    dotted paths mirroring the instrumented module; duplicates raise —
    uniqueness is part of the registry-completeness gate."""
    if name in _SITES:
        raise ValueError(f"duplicate fault site {name!r}")
    s = Site(name)
    _SITES[name] = s
    return s


def registry() -> Dict[str, Site]:
    """Snapshot of every registered site (name -> Site)."""
    return dict(_SITES)


# -- activation ----------------------------------------------------------------

@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the dynamic extent of the block.  Nesting replaces
    the outer plan for the inner extent (the outer plan resumes after)."""
    global _PLAN
    outer = _PLAN
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = outer


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def set_process_scope(scope: Optional[str]) -> None:
    """Declare this process's identity within a dist fabric (``"proc0"``
    for the coordinator, ``"proc1"``.. for workers; None tears the scope
    back down when the fabric stops).  While a scope is set, faults
    carrying a different ``proc`` are skipped; unscoped faults fire as
    always."""
    global _PROC_SCOPE
    if scope is not None and not _PROC_RE.fullmatch(scope):
        raise ValueError(
            f"malformed process scope {scope!r} (expected procK)")
    _PROC_SCOPE = scope


def process_scope() -> Optional[str]:
    return _PROC_SCOPE


def assert_sites_registered(plan: Optional[FaultPlan] = None) -> None:
    """Fail fast on a schedule naming sites the registry doesn't know — a
    typo in ``CSTPU_FAULTS`` would otherwise silently disarm the whole
    chaos run and report a clean row that exercised nothing.  Call AFTER
    the instrumented modules are imported (bench does, before replaying);
    defaults to the active plan."""
    plan = plan if plan is not None else _PLAN
    if plan is None:
        return
    unknown = sorted({f.site for f in plan.faults()} - set(_SITES))
    if unknown:
        raise ValueError(
            f"fault schedule names unregistered sites: {unknown} "
            f"(registered: {sorted(_SITES)})")


def plan_from_env(value: str) -> FaultPlan:
    """Parse a ``CSTPU_FAULTS`` directive string (see module docstring).
    Grammar per directive: ``site[@nth][=kind][@procK]`` — the process
    scope, when present, is the LAST ``@`` segment and must match
    ``proc\\d+`` exactly; anything else starting with ``proc`` after an
    ``@`` is rejected loudly (a typo'd scope must never silently arm the
    fault everywhere)."""
    faults = []
    for raw in value.split(","):
        raw = raw.strip()
        if not raw:
            continue
        proc = None
        if "@" in raw:
            head, tail = raw.rsplit("@", 1)
            if _PROC_RE.fullmatch(tail):
                proc, raw = tail, head
            elif tail.startswith("proc"):
                raise ValueError(
                    f"malformed process scope in fault directive "
                    f"{raw!r}: {tail!r} (expected procK, K a decimal "
                    "ordinal — proc0 = coordinator, proc1.. = workers)")
        kind = "error"
        if "=" in raw:
            raw, kind = raw.rsplit("=", 1)
        nth, sticky = 1, False
        if "@" in raw:
            raw, nth_s = raw.rsplit("@", 1)
            if nth_s.endswith("+"):
                sticky, nth_s = True, nth_s[:-1]
            nth = int(nth_s)
        faults.append(Fault(raw, nth=nth, kind=kind, sticky=sticky,
                            proc=proc))
    return FaultPlan(faults)


def plan_to_env(plan: FaultPlan) -> str:
    """Serialize a plan back to the ``CSTPU_FAULTS`` grammar — the
    coordinator ships its ACTIVE plan to every worker this way, so a
    chaos schedule written for the fabric crosses the process boundary
    verbatim (each process re-parses and arms only the faults addressed
    to it)."""
    return ",".join(repr(f) for f in plan.faults())


_env = os.environ.get("CSTPU_FAULTS")
if _env:  # bench/CI chaos runs: arm the process-wide plan at import
    _PLAN = plan_from_env(_env)
del _env

_env = os.environ.get("CSTPU_DIST_PROC")
if _env:  # dist worker subprocess: scope set before any probe can fire
    set_process_scope(_env)
del _env
