"""Fixed-bucket (log2) latency histograms with p50/p90/p99 readouts
(layer 2 of the observability stack).

The engine's phase attribution (``sig_verify_s``, ``attestation_apply_s``,
...) is sum-only: a regression that doubles the p99 while leaving the
median alone moves the total by noise-level amounts and hides.  This
module keeps a per-phase DISTRIBUTION at constant memory: 28 log2
buckets from ~1 µs to >64 s, one counter each, observed once per block
per phase (32 observations per epoch — the hot loops never touch it).

* ``observe(name, seconds)`` — one lock-guarded bucket increment (the
  metrics-lock discipline: producers on the dispatch worker and the host
  observe concurrently);
* ``snapshot()`` — per-name count / total / mean / max plus p50/p90/p99
  estimated from the buckets (linear interpolation inside the winning
  bucket; exact max tracked separately so the tail never under-reports
  past the bucket boundary), and the non-zero buckets keyed by their
  upper bound — rides the telemetry bus as the ``"histograms"`` provider;
* ``reset()`` — drops every histogram (``stf.engine.reset_stats`` calls
  it, so a bench pass's distributions describe exactly that pass).

The registry (``_HISTOGRAMS``) is analyzer-registered (CC01
"latency-histogram registry"): inserts happen only through ``observe``
here.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

# bucket upper bounds: 2**e seconds for e in [_MIN_EXP, _MAX_EXP], plus
# one overflow bucket — ~1 µs resolution at the bottom, >64 s at the top
_MIN_EXP = -20
_MAX_EXP = 6
N_BUCKETS = _MAX_EXP - _MIN_EXP + 2

_LOCK = threading.Lock()
_HISTOGRAMS: Dict[str, "Histogram"] = {}


def _bucket_index(seconds: float) -> int:
    """Index of the half-open ``[2^(e-1), 2^e)`` bucket holding
    ``seconds`` (frexp yields the exponent directly, no float log)."""
    if seconds <= 0.0:
        return 0
    _, exp = math.frexp(seconds)  # seconds = m * 2**exp, 0.5 <= m < 1
    if exp < _MIN_EXP:
        return 0
    if exp > _MAX_EXP:
        return N_BUCKETS - 1
    return exp - _MIN_EXP


def _bucket_bounds(index: int):
    """(lower, upper) bound in seconds of bucket ``index`` (the overflow
    bucket's upper bound is reported as infinity)."""
    lo = 0.0 if index == 0 else 2.0 ** (index - 1 + _MIN_EXP)
    hi = math.inf if index == N_BUCKETS - 1 else 2.0 ** (index + _MIN_EXP)
    return lo, hi


class Histogram:
    """One phase's latency distribution at fixed memory."""

    __slots__ = ("name", "counts", "count", "total_s", "max_s")

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def observe(self, seconds: float) -> None:
        self.counts[_bucket_index(seconds)] += 1
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def quantile(self, q: float) -> float:
        """The q-quantile estimated from the buckets: linear
        interpolation between the winning bucket's bounds (the overflow
        bucket reports the tracked exact max — the tail never caps at a
        boundary the data already passed)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                lo, hi = _bucket_bounds(i)
                if not math.isfinite(hi):
                    return self.max_s
                frac = (rank - cum) / n
                return min(lo + (hi - lo) * frac, self.max_s or hi)
            cum += n
        return self.max_s

    def snapshot(self) -> dict:
        buckets = {}
        for i, n in enumerate(self.counts):
            if n:
                _, hi = _bucket_bounds(i)
                label = "inf" if not math.isfinite(hi) else f"{hi:.9g}"
                buckets[label] = n
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_s": round(self.total_s / self.count, 6) if self.count else 0.0,
            "max_s": round(self.max_s, 6),
            "p50_s": round(self.quantile(0.50), 6),
            "p90_s": round(self.quantile(0.90), 6),
            "p99_s": round(self.quantile(0.99), 6),
            "buckets": buckets,
        }


def observe(name: str, seconds: float) -> None:
    """Record one observation into the named histogram (created on first
    use); one lock-guarded increment — safe from any thread."""
    with _LOCK:
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(name)
        h.observe(seconds)


def names() -> tuple:
    with _LOCK:
        return tuple(sorted(_HISTOGRAMS))


def reset() -> None:
    """Drop every histogram (bench passes and tests want per-run
    distributions; the registry repopulates on first observe)."""
    with _LOCK:
        _HISTOGRAMS.clear()


def snapshot() -> dict:
    """{name: {count, total_s, mean_s, max_s, p50_s, p90_s, p99_s,
    buckets}} over every live histogram (the bus provider)."""
    with _LOCK:
        items = sorted(_HISTOGRAMS.items())
        return {name: h.snapshot() for name, h in items}
