"""Dist worker subprocess body (``python -m consensus_specs_tpu_torch.dist.worker``).

Port of ``consensus_specs_tpu/dist/worker.py``.  One worker = one process
= one failure domain.  The coordinator spawns it with
``CSTPU_DIST_PROC=procK`` (which ``faults.py`` reads at import, so a
scoped chaos plan shipped via ``CSTPU_FAULTS`` arms ONLY the faults
addressed to this process) and ``CSTPU_DIST_DEVICE`` (the device of its
tensor work; absent means the CUDA card, and a host without one raises,
never carrying on on the CPU), and talks to it over stdin/stdout with the
``dist/codec.py`` digest-framed protocol:

* inbound  — ``task`` frames (execute, reply), ``shutdown`` (exit 0);
* outbound — one ``hello`` at startup, ``heartbeat`` frames from a side
  thread every ``CSTPU_DIST_HEARTBEAT_S`` seconds, and one ``reply`` per
  task.  All outbound frames serialize on ``_WRITE_LOCK`` so a beat can
  never tear a reply mid-frame.

Task handlers import their engines LAZILY per task kind: a worker that
only ever echoes (the chaos suites) never imports torch, and a verify
worker imports exactly the verification stack the in-process path uses —
which is what makes the results bit-identical.  Replies carry numpy
arrays and bytes, never device tensors.  A pairing reply's meta also
carries the kernel launches the task made (``launches``: K3, K4, K5), so
the coordinator can show that the kernels ran in the workers.

Failure semantics at the ``dist.worker.exec`` probe:

* ``error``  (``InjectedFault``) — the task failed but the process is
  healthy: an ``ok=False`` reply goes back and the coordinator
  re-dispatches the chunk elsewhere;
* ``crash`` (``InjectedBackendCrash``) — the PROCESS dies mid-chunk
  (``os._exit``): no reply, the channel EOFs, and the coordinator's
  loss path takes over.  This is the "kill a worker mid-chunk" model
  the chaos suite drives.

``print()`` output from task code is repointed at stderr before the
first frame: stdout belongs to the frame stream alone.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
import time

from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.dist import codec

# the worker-side execution seam: probed once per task, BEFORE the
# handler runs, so an injected death really is mid-chunk (the chunk is
# in flight, unreplied)
_SITE_EXEC = faults.site("dist.worker.exec")

PROC = os.environ.get("CSTPU_DIST_PROC", "proc?")

# the coordinator-facing frame stream (bound in serve()); every write —
# replies from the main loop, beats from the heartbeat thread — holds
# _WRITE_LOCK so frames never interleave
_OUT = None
_WRITE_LOCK = threading.Lock()


def _send(kind: str, meta: dict, body: bytes = b"") -> None:
    with _WRITE_LOCK:
        codec.write_frame(_OUT, kind, meta, body)


def _heartbeat_loop(interval: float, stop: threading.Event) -> None:
    """Liveness beacon: one ``heartbeat`` frame per interval until told to
    stop.  A write failure means the coordinator is gone — the main loop
    will see EOF on stdin and exit; the beacon just goes quiet."""
    seq = 0
    while not stop.wait(interval):
        seq += 1
        try:
            _send("heartbeat", {"proc": PROC, "seq": seq})
        except Exception:
            return


def run_task(kind: str, meta: dict, body: bytes):
    """Execute one task chunk; returns ``(meta, body)`` for the reply.
    Handlers are pure functions of the chunk body — any worker can run
    any chunk, which is what makes re-dispatch sound."""
    _SITE_EXEC()
    if kind == "echo":
        # cheap deterministic kind for fabric/chaos tests: digest + body
        return {"ok": True}, hashlib.sha256(body).digest() + body
    if kind == "sleep_echo":
        # straggler/kill-window model: hold the chunk in flight for a
        # while, then echo — gives heartbeat timeouts a surface
        time.sleep(float(meta.get("seconds", 0.5)))
        return {"ok": True}, hashlib.sha256(body).digest() + body
    if kind == "warm":
        return _run_warm()
    if kind == "verify_chunk":
        return _run_verify_chunk(body)
    if kind == "pairing_partial":
        return _run_pairing_partial(body)
    if kind == "epoch_slice":
        return _run_epoch_slice(body)
    if kind == "merkle_subtree":
        return _run_merkle_subtree(body)
    raise ValueError(f"unknown task kind {kind!r}")


def _device():
    """The device of this worker's tensor work: ``CSTPU_DIST_DEVICE``, or
    the CUDA card when it is absent (raising on a host without one)."""
    from consensus_specs_tpu_torch._device import resolve_device

    return resolve_device(os.environ.get("CSTPU_DIST_DEVICE") or None)


def _run_warm():
    """Pay the tensor handlers' start-up before the first timed task:
    torch's import and the device (on the card: its context, and the
    kernel libraries, loaded from the build directory and built only
    where absent)."""
    t0 = time.perf_counter()
    import torch

    from consensus_specs_tpu_torch.ops import epoch  # noqa: F401
    from consensus_specs_tpu_torch.ops.bls import limbs, pairing

    dev = _device()
    torch.zeros(1, device=dev).sum().item()
    if dev.type == "cuda":
        limbs._library()
        pairing._library()
    return {"ok": True, "device": str(dev),
            "warm_s": time.perf_counter() - t0}, b""


def _run_verify_chunk(body: bytes):
    """Leftmost-failure verify of one entry chunk THROUGH the same
    ``stf/verify.py`` path the in-process run uses: the chunk-local
    ``first_invalid`` index composes with the coordinator's min-merge
    into the exact global index the unchunked bisection names."""
    import pickle

    from consensus_specs_tpu_torch.stf import verify as stf_verify

    payload = pickle.loads(body)
    first = stf_verify.first_invalid(payload["entries"],
                                     seed=payload["seed"])
    return {"ok": True}, pickle.dumps({"first": first})


def _run_pairing_partial(body: bytes):
    """One chunk's partial Miller product (conjugated), the unit the
    coordinator merges in fixed chunk-index order, on this worker's
    device (K4 for the doubling runs, K3 for the rest, on the card).
    Integer limb arithmetic: exact, so the partial equals the in-process
    chunk's as an Fq12 value no matter which worker computes it."""
    import pickle

    from consensus_specs_tpu_torch.dist.workloads import chunk_partial
    from consensus_specs_tpu_torch.ops.bls import launch_counts

    d = pickle.loads(body)
    before = launch_counts()
    f = chunk_partial(d["px"], d["py"], d["qx"], d["qy"], _device())
    after = launch_counts()
    return ({"ok": True,
             "launches": {k: after[k] - before[k] for k in after}},
            pickle.dumps(f))


def _run_epoch_slice(body: bytes):
    """One registry slice of the epoch balance update: the worker runs
    the SAME deltas function the in-process twin runs
    (``ops/epoch.attestation_deltas``) on its device and returns its
    [lo, hi) rows.  The global reductions (total balance, sqrt) arrive
    precomputed inside ``DeltaInputs``."""
    import pickle

    from consensus_specs_tpu_torch.dist.workloads import balance_update
    from consensus_specs_tpu_torch.ops.epoch import DeltaInputs

    d = pickle.loads(body)
    new = balance_update(DeltaInputs(**d["inp"]), d["balances"], _device())
    return {"ok": True}, pickle.dumps(new[d["lo"]:d["hi"]])


def _run_merkle_subtree(body: bytes):
    """Subtree root of one packed-uint64 chunk, computed with the plain
    bottom-up sha256 reduction on the host, as the reference's worker
    does."""
    import pickle

    d = pickle.loads(body)
    lanes = d["lanes"]
    data = b"".join(int(v).to_bytes(8, "little") for v in lanes)
    nodes = [data[i:i + 32] for i in range(0, len(data), 32)]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return {"ok": True}, nodes[0]


def serve() -> None:
    """The worker main loop: hello, heartbeats, then task frames until
    shutdown/EOF.  A corrupt inbound frame is unrecoverable (the length
    framing has lost sync): exit nonzero, which the coordinator reads as
    a channel loss and re-dispatches around."""
    global _OUT
    stdin = sys.stdin.buffer
    _OUT = sys.stdout.buffer
    sys.stdout = sys.stderr  # task-code print() must not tear the frames

    interval = float(os.environ.get("CSTPU_DIST_HEARTBEAT_S", "0.25"))
    stop = threading.Event()
    _send("hello", {"proc": PROC, "pid": os.getpid()})
    beacon = threading.Thread(target=_heartbeat_loop, args=(interval, stop),
                              name=f"dist-heartbeat-{PROC}", daemon=True)
    beacon.start()
    try:
        while True:
            try:
                frame = codec.read_frame(stdin)
            except Exception:
                sys.exit(4)  # lost frame sync: die loudly, not garbled
            if frame is None:
                break  # coordinator closed the channel: end of stream
            kind, meta, body = frame
            if kind == "shutdown":
                break
            if kind != "task":
                continue  # unknown control frames: forward-compatible skip
            try:
                out_meta, out_body = run_task(meta["kind"], meta, body)
            except faults.InjectedBackendCrash:
                os._exit(13)  # injected process death: mid-chunk, no reply
            except BaseException as exc:
                out_meta, out_body = (
                    {"ok": False, "error": repr(exc)[:300]}, b"")
            out_meta = dict(out_meta, id=meta["id"], proc=PROC,
                            kind=meta["kind"])
            try:
                _send("reply", out_meta, out_body)
            except Exception:
                break  # coordinator gone mid-reply
    finally:
        stop.set()


if __name__ == "__main__":
    serve()
    # no interpreter teardown: every frame is flushed, and unloading torch
    # (and a CUDA context) would hold the coordinator's close() for a while
    sys.stderr.flush()
    os._exit(0)
