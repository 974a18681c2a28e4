"""Concurrent query-load harness: readers against the live firehose.

``run_query_load`` is ``firehose.run_firehose`` plus N "query-reader"
threads hammering the node's ``QueryEngine`` while the apply loop
serves: each reader draws a seeded op mix (summary / balance / status /
proof+verify / vote / state-at-root), records per-op latency, and
tolerates the early window where no checkpoint artifact exists yet
(counted as unserved, not failed).  Readers stop when the firehose
drains; the returned row carries p50/p99 service latency beside the
firehose throughput numbers — the ``node_query_load`` bench row's
engine, and the concurrency story the TH01 registry declares: readers
touch the engine surface only, never the apply writer's store.
"""
from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

_OPS = ("summary", "balance", "status", "proof", "vote", "state")


def query_reader(engine, n_validators: int, stop: threading.Event,
                 out: list, seed: int, op_mix=_OPS) -> None:
    """One reader thread's loop (TH01 role: ``query-reader``): seeded
    op draws against ``engine`` until ``stop`` is set; appends its
    latency/outcome record to ``out`` on exit."""
    rng = random.Random(seed)
    latencies: List[float] = []
    served = unserved = errors = 0
    while not stop.is_set():
        op = rng.choice(op_mix)
        vi = rng.randrange(max(1, n_validators))
        t0 = time.perf_counter()
        try:
            if op == "summary":
                r = engine.summary()
            elif op == "balance":
                r = engine.balance_of(vi)
            elif op == "status":
                r = engine.validator_status(vi)
            elif op == "proof":
                r = engine.proof_of_validator(vi)
            elif op == "vote":
                r = engine.vote_of(vi)
            else:
                r = engine.state_at_root()
        except Exception:
            # a query may legitimately fail mid-run (an artifact pruned
            # under the reader, a chaos probe): count it, keep reading —
            # the harness asserts on the tallies, the apply loop never
            # sees any of this
            errors += 1
            continue
        dt = time.perf_counter() - t0
        if r is None and op != "vote":
            unserved += 1
        else:
            served += 1
            latencies.append(dt)
    out.append({"served": served, "unserved": unserved, "errors": errors,
                "latencies": latencies})


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    k = int(round(q * (len(sorted_vals) - 1)))
    return sorted_vals[k]


def run_query_load(spec, anchor_state, corpus, n_query_threads: int = 2,
                   query_seed: int = 1234, op_mix=_OPS,
                   **firehose_kwargs) -> dict:
    """The firehose under concurrent query load.  Forwards everything
    else to ``run_firehose`` (``checkpoint_store=...`` is effectively
    required — without one the engine never has an artifact and every
    op counts unserved).  Returns the firehose row plus a
    ``query_load`` sub-row."""
    from consensus_specs_tpu_torch.node import firehose

    n_validators = len(anchor_state.validators)
    stop = threading.Event()
    results: list = []
    readers: List[threading.Thread] = []

    def _on_node(node) -> None:
        engine = node.query_engine
        if engine is None:
            raise RuntimeError(
                "run_query_load needs a node with a checkpoint_store "
                "(the query engine serves off its artifacts)")
        for i in range(n_query_threads):
            t = threading.Thread(
                target=query_reader,
                args=(engine, n_validators, stop, results,
                      query_seed + i, op_mix),
                name=f"query-reader-{i}", daemon=True)
            t.start()
            readers.append(t)

    try:
        run = firehose.run_firehose(spec, anchor_state, corpus,
                                    on_node=_on_node, **firehose_kwargs)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30.0)

    latencies = sorted(x for r in results for x in r["latencies"])
    ops = sum(r["served"] + r["unserved"] + r["errors"] for r in results)
    p50 = _percentile(latencies, 0.50)
    p99 = _percentile(latencies, 0.99)
    run["query_load"] = {
        "threads": n_query_threads,
        "ops": ops,
        "served": sum(r["served"] for r in results),
        "unserved": sum(r["unserved"] for r in results),
        "errors": sum(r["errors"] for r in results),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
    }
    return run
