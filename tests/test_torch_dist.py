"""The port's process fabric (``consensus_specs_tpu_torch/dist/``) against
the JAX package's: the fault-free half of the contract, on the CPU.

* the codec: round trip, torn frame, flipped bit, foreign tag, insane
  length prefix, and the port's frames equal to the reference's
  ``encode_frame`` bytes, byte for byte;
* the 2-worker echo path: batches, task order, each worker's process
  scope (read by the port's ``faults.py`` from ``CSTPU_DIST_PROC``), the
  coordinator's ``proc0`` scope, hedging and duplicate replies, a clean
  shutdown, chunk bounds and the telemetry snapshot; an echo-only worker
  never imports torch;
* the four workloads over one 2-worker fabric on ``device="cpu"`` at a
  small size, equal to the JAX package's: the epoch balances at 256
  validators against ``ops/epoch_jax.attestation_deltas``, a list root at
  1,024 values (and the "too small" branch) against the reference's SSZ
  root, ``first_invalid``'s index, the lane-chunk limbs at 4, 5 and 7
  lanes (the pad rule), and a valid and a tampered pairing check of two
  signatures' lanes against the JAX package's BLS verdicts.

Every comparison is exact: the outputs are integers, bytes and verdicts.
``slow``: the workers' partials against the reference's jitted
``_miller_product``, ``lane_product``'s split above 4 lanes against the
one-item product, and the two-worker capability run of the reference's
dryrun.  ``cuda``: the fabric on the card at C > 4 lanes a chunk (K4's
pair limit split), against the coordinator's partials and verdicts.
"""
import hashlib
import io
import os
import pickle
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from consensus_specs_tpu.dist import codec as ref_codec
from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.dist import codec, dispatch, fabric as fabmod
from consensus_specs_tpu_torch.dist import workloads
from consensus_specs_tpu_torch.dist.dispatch import FabricExecutor, TaskSpec
from consensus_specs_tpu_torch.dist.fabric import Fabric
from consensus_specs_tpu_torch.dist.workloads import _chunk_bounds
from consensus_specs_tpu_torch.persist import atomic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_stats():
    dispatch.reset_stats()
    fabmod.reset_stats()
    yield


@pytest.fixture(scope="module")
def cpu_fabric():
    """One 2-worker fabric on the CPU for the workload tests: the workers
    import torch once."""
    with Fabric(n_workers=2, heartbeat_interval=0.1, device="cpu") as fab:
        yield fab


# -- codec ---------------------------------------------------------------------


def test_codec_roundtrip():
    buf = io.BytesIO()
    codec.write_frame(buf, "task", {"id": "t0", "kind": "echo"}, b"payload")
    codec.write_frame(buf, "reply", {"ok": True}, b"")
    buf.seek(0)
    assert codec.read_frame(buf) == ("task", {"id": "t0", "kind": "echo"},
                                     b"payload")
    assert codec.read_frame(buf) == ("reply", {"ok": True}, b"")
    assert codec.read_frame(buf) is None  # clean EOF at a frame boundary


def test_codec_torn_frame_is_detected():
    raw = codec.encode_frame("task", {"id": "t0"}, b"x" * 100)
    for cut in (2, 5, len(raw) - 1):  # mid-prefix, mid-header, mid-digest
        with pytest.raises(atomic.ArtifactCorrupt):
            codec.read_frame(io.BytesIO(raw[:cut]))


def test_codec_flipped_bit_is_detected():
    raw = bytearray(codec.encode_frame("task", {"id": "t0"}, b"x" * 64))
    raw[len(raw) // 2] ^= 0x01
    with pytest.raises(atomic.ArtifactCorrupt):
        codec.read_frame(io.BytesIO(bytes(raw)))


def test_codec_foreign_protocol_tag_is_stale():
    env = atomic.envelope(b'{"a":1}\x00body', "task", "dist-v0")
    raw = struct.pack("<I", len(env)) + env
    with pytest.raises(atomic.ArtifactStaleTag):
        codec.read_frame(io.BytesIO(raw))


def test_codec_insane_length_prefix_is_corrupt():
    raw = struct.pack("<I", codec.MAX_FRAME + 1) + b"zzzz"
    with pytest.raises(atomic.ArtifactCorrupt):
        codec.read_frame(io.BytesIO(raw))


@pytest.mark.parametrize("kind,meta,body", [
    ("task", {"id": "r1.t0", "kind": "echo"}, b"payload"),
    ("reply", {"ok": True, "proc": "proc2", "launches": {"K4": 6}}, b""),
    ("heartbeat", {"proc": "proc1", "seq": 7}, b""),
    ("task", {"id": "r9.t3", "kind": "merkle_subtree"},
     pickle.dumps({"lanes": np.arange(16, dtype=np.int64)}, protocol=4)),
])
def test_frames_equal_the_references_byte_for_byte(kind, meta, body):
    """Both packages speak one wire protocol: the same message is the
    same frame, and each side parses the other's."""
    ours = codec.encode_frame(kind, meta, body)
    assert ours == ref_codec.encode_frame(kind, meta, body)
    assert codec.PROTOCOL_TAG == ref_codec.PROTOCOL_TAG
    assert ref_codec.read_frame(io.BytesIO(ours)) == (kind, meta, body)


# -- the 2-worker echo path ----------------------------------------------------


def _echo_expect(i):
    body = f"chunk-{i}".encode()
    return hashlib.sha256(body).digest() + body


def test_two_worker_echo_batch():
    with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
        tasks = [TaskSpec("echo", {}, f"chunk-{i}".encode())
                 for i in range(6)]
        out = dispatch.run_tasks(fab, tasks, deadline_s=60.0)
        hellos = [w.hello_s for w in fab.alive_workers()]
    assert [body for _, body in out] == [_echo_expect(i) for i in range(6)]
    assert all(meta["ok"] for meta, _ in out)
    snap = dispatch.snapshot()
    # fault-free: nothing re-dispatched, nothing hedged, nothing lost
    assert snap["redispatched_chunks"] == 0
    assert snap["hedged_tasks"] == 0
    assert snap["worker_losses"] == 0
    assert snap["replies"] == 6
    fsnap = fabmod.snapshot()
    assert fsnap["spawned"] == 2
    assert fsnap["corrupt_replies"] == 0
    assert fsnap["bytes_sent"] == sum(len(f"chunk-{i}") for i in range(6))
    # each worker's hello landed and was timed from its spawn
    assert len(hellos) == 2 and all(h is not None and h > 0 for h in hellos)


def test_results_come_back_in_task_order():
    """Replies arrive out of order (task 0 is the slowest) but the merge
    surface is task-ordered — the fixed-merge-order contract every
    workload builds on."""
    with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
        tasks = [TaskSpec("sleep_echo", {"seconds": 0.4}, b"slow"),
                 TaskSpec("echo", {}, b"fast-1"),
                 TaskSpec("echo", {}, b"fast-2")]
        out = dispatch.run_tasks(fab, tasks, deadline_s=60.0)
    bodies = [body[32:] for _, body in out]
    assert bodies == [b"slow", b"fast-1", b"fast-2"]


def test_worker_scope_reaches_the_worker_process():
    """Each worker reports its CSTPU_DIST_PROC scope back in replies, and
    the port's faults.py takes that variable as its process scope at
    import — the addressing a scoped chaos plan relies on."""
    with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
        tasks = [TaskSpec("echo", {}, bytes([i])) for i in range(4)]
        out = dispatch.run_tasks(fab, tasks, deadline_s=60.0)
    procs = {meta["proc"] for meta, _ in out}
    assert procs == {"proc1", "proc2"}  # round-robin touched both
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; import consensus_specs_tpu_torch."
         "faults as f; print(f.process_scope(), 'torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CSTPU_DIST_PROC": "proc3"})
    assert probe.stdout.split() == ["proc3", "False"], probe.stderr


def test_echo_worker_never_imports_torch():
    """The worker module and what an echo task runs stay free of torch:
    the chaos suites' workers start in a fraction of a second."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys; import consensus_specs_tpu_torch.dist.worker as w; "
         "w.run_task('echo', {}, b'x'); print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert probe.stdout.split() == ["False"], probe.stderr


def test_coordinator_wears_proc0_scope_inside_fabric_extent():
    assert faults.process_scope() is None
    with Fabric(n_workers=1, heartbeat_interval=0.1):
        assert faults.process_scope() == "proc0"
    assert faults.process_scope() is None


def test_hedge_duplicates_a_straggler():
    """A chunk in flight past hedge_s gets one duplicate on the second
    worker; the hedge is NOT a re-dispatched chunk (the fault-free gate
    keys on that distinction)."""
    with Fabric(n_workers=2, heartbeat_interval=0.1) as fab:
        tasks = [TaskSpec("sleep_echo", {"seconds": 0.6}, b"straggler")]
        out = dispatch.run_tasks(fab, tasks, deadline_s=60.0, hedge_s=0.15)
    assert out[0][1][32:] == b"straggler"
    snap = dispatch.snapshot()
    assert snap["hedged_tasks"] == 1
    assert snap["redispatched_chunks"] == 0


def test_duplicate_replies_are_discarded_by_task_id():
    """Unit-level dedup: a second reply for a settled task id is counted
    and dropped, never merged."""
    run = dispatch._DispatchRun.__new__(dispatch._DispatchRun)
    pending = dispatch._Pending("r0.t0", 0, TaskSpec("echo", {}, b""))
    pending.workers = {"proc1"}
    run._inflight = {"r0.t0": pending}
    run._results = {}
    run._done = set()
    run._n = 1

    class _NoFabric:
        def worker(self, proc):
            return None

    run.fabric = _NoFabric()
    first = fabmod.Event("reply", "proc1", {"id": "r0.t0", "ok": True}, b"a")
    dupe = fabmod.Event("reply", "proc2", {"id": "r0.t0", "ok": True}, b"b")
    run._on_reply(first)
    run._on_reply(dupe)
    assert run._results[0][1] == b"a"  # first valid reply won
    assert dispatch.snapshot()["duplicate_replies"] == 1


def test_shutdown_is_clean():
    fab = Fabric(n_workers=2, heartbeat_interval=0.1).start()
    procs = [w.popen for w in fab.alive_workers()]
    fab.close()
    assert all(p.poll() is not None for p in procs)
    fab.close()  # idempotent
    snap = fabmod.snapshot()
    assert snap["workers_lost"] == 0 and snap["channel_losses"] == 0


# -- deterministic chunk math --------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 16, 100])
def test_chunk_bounds_cover_and_equal_the_references(n):
    from consensus_specs_tpu.dist.workloads import _chunk_bounds as ref_bounds

    for k in (1, 2, 3, 8):
        bounds = _chunk_bounds(n, k)
        assert bounds == ref_bounds(n, k)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (a, b), (c, d) in zip(bounds, bounds[1:]):
            assert b == c and b > a
        sizes = [hi - lo for lo, hi in bounds]
        assert max(sizes) - min(sizes) <= 1


def test_chunk_bounds_degenerate():
    assert _chunk_bounds(3, 10) == [(0, 1), (1, 2), (2, 3)]
    assert _chunk_bounds(5, 1) == [(0, 5)]


# -- telemetry surface ---------------------------------------------------------


def test_snapshots_ride_the_ports_telemetry_bus():
    from consensus_specs_tpu_torch import telemetry

    tree = telemetry.snapshot()["providers"]
    assert "redispatched_chunks" in tree["dist.dispatch"]
    assert "corrupt_replies" in tree["dist.fabric"]
    assert "bytes_sent" in tree["dist.fabric"]


def test_stats_are_lock_guarded():
    """Counter bumps from many threads never lose increments (the reader
    threads and the dispatch loop all write these)."""
    def spin():
        for _ in range(1000):
            dispatch._bump("replies")

    threads = [threading.Thread(target=spin) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert dispatch.snapshot()["replies"] == 4000


# -- the workloads on the CPU, against the JAX package -------------------------


def test_epoch_balances_equal_the_references(cpu_fabric):
    from consensus_specs_tpu.ops.epoch_jax import (
        DeltaInputs as RefDeltaInputs,
        attestation_deltas as ref_deltas,
    )
    from consensus_specs_tpu_torch import scenario

    inp, balances = scenario.example_delta_inputs(256)
    rewards, penalties = ref_deltas(RefDeltaInputs(*inp))
    new = balances + np.asarray(rewards)
    pen = np.asarray(penalties)
    want = np.where(pen > new, 0, new - pen)
    got, mode = workloads.epoch_balances(
        FabricExecutor(cpu_fabric), inp, balances, n_slices=2, device="cpu")
    assert mode == "fabric"
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(
        workloads.balance_update(inp, balances, "cpu"), want)
    snap = dispatch.snapshot()
    assert snap["error_replies"] == 0 and snap["redispatched_chunks"] == 0


def test_list_roots_equal_the_references(cpu_fabric):
    from consensus_specs_tpu.ssz.types import List as RefList, uint64

    rng = np.random.default_rng(20)
    arr = rng.integers(0, 2**63 - 1, size=1024, dtype=np.int64)
    ex = FabricExecutor(cpu_fabric)
    root, mode = workloads.uint64_list_root(ex, arr, 4096, n_chunks=2)
    assert mode == "fabric"
    assert root == bytes(RefList[uint64, 4096](
        [int(x) for x in arr]).hash_tree_root())
    # too small to fill the padded shards: the SSZ host path, in-process
    small = arr[:40]
    root, mode = workloads.uint64_list_root(ex, small, 40, n_chunks=4)
    assert mode == "inprocess"
    assert root == bytes(RefList[uint64, 40](
        [int(x) for x in small]).hash_tree_root())


def _sig_entry(sks, msg, valid=True):
    from consensus_specs_tpu_torch.crypto.bls import native

    signed = msg if valid else hashlib.sha256(msg).digest()
    sig = native.Aggregate([native.Sign(sk, signed) for sk in sks])
    flat = b"".join(native.pubkey_affine(native.SkToPk(sk)) for sk in sks)
    return (len(sks), flat, bytes(msg), sig)


def test_first_invalid_equals_the_references(cpu_fabric):
    from consensus_specs_tpu.stf import verify as ref_verify

    entries = [_sig_entry([3 * i + 1, 3 * i + 2], bytes([i]) * 32,
                          valid=(i != 9)) for i in range(12)]
    want = ref_verify.first_invalid(entries)
    assert want == 9
    got, mode = workloads.batch_first_invalid(
        FabricExecutor(cpu_fabric), entries, n_chunks=2)
    assert (got, mode) == (want, "fabric")


def _pairs(curve, n, tamper=False):
    """n lanes whose pairing product is 1 (a tampered first lane makes it
    not), from either package's curve module."""
    G, H = curve.g1_generator(), curve.g2_generator()
    pairs = []
    for i in range(n // 2):
        a, b = 3 + i, 5 + 2 * i
        pairs += [(G.mul(a), H.mul(b)), (-G.mul(a * b), H)]
    if tamper:
        pairs[0] = (G.mul(4), pairs[0][1])
    return pairs


@pytest.mark.parametrize("n_lanes", [4, 5, 7])
def test_lane_chunk_limbs_equal_the_references(n_lanes):
    """The chunk layout and the pad rule (a lone pad lane widens the
    chunks), limb for limb."""
    from consensus_specs_tpu.crypto.bls import curve as ref_curve
    from consensus_specs_tpu.dist.workloads import (
        _pairing_lane_chunks as ref_chunks,
    )
    from consensus_specs_tpu_torch.crypto.bls import curve

    G, H = curve.g1_generator(), curve.g2_generator()
    rG, rH = ref_curve.g1_generator(), ref_curve.g2_generator()
    ours = workloads._pairing_lane_chunks(
        [(G.mul(i + 2), H.mul(3 * i + 1)) for i in range(n_lanes)], 2)
    theirs = ref_chunks(
        [(rG.mul(i + 2), rH.mul(3 * i + 1)) for i in range(n_lanes)], 2)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.shape == y.shape and np.array_equal(x, y)


def test_verify_verdict_parity_all_valid(cpu_fabric):
    from consensus_specs_tpu.stf import verify as ref_verify

    entries = [_sig_entry([5 * i + 1], bytes([40 + i]) * 32)
               for i in range(6)]
    assert ref_verify.first_invalid(entries) is None
    got, mode = workloads.batch_first_invalid(
        FabricExecutor(cpu_fabric), entries, n_chunks=2)
    assert (got, mode) == (None, "fabric")
    assert dispatch.snapshot()["redispatched_chunks"] == 0  # fault-free


def _signature_lanes(tamper=False):
    """4 lanes, two signatures' ``(pk, H(m))`` and ``(-G1, sig)``; with
    ``tamper`` the first signature is over another message."""
    from consensus_specs_tpu_torch.crypto.bls import native
    from consensus_specs_tpu_torch.ops import bls as dbls

    msgs = [b"\x11" * 32, b"\x22" * 32]
    sigs = [native.Sign(7 + i, m) for i, m in enumerate(msgs)]
    if tamper:
        sigs[0] = native.Sign(7, b"\x33" * 32)
    pks = [[native.SkToPk(7 + i)] for i in range(2)]
    _, todo = dbls.marshal_fast_aggregate_items(pks, msgs, sigs)
    return [pair for _, item in todo for pair in item], (pks, msgs, sigs)


def test_pairing_verdicts_equal_the_references(cpu_fabric):
    """A valid and a tampered check of two signatures' 4 lanes: each
    verdict equals the JAX package's BLS verdict on those signatures."""
    from consensus_specs_tpu.crypto.bls import native as ref_native

    ex = FabricExecutor(cpu_fabric)
    for tamper in (False, True):
        lanes, (pks, msgs, sigs) = _signature_lanes(tamper)
        assert len(lanes) == 4
        replies = []
        got, mode = workloads.pairing_lanes_check(
            ex, lanes, n_chunks=2, device="cpu", replies_out=replies)
        assert mode == "fabric"
        assert got == ref_native.BatchFastAggregateVerify(
            list(zip(pks, msgs, sigs)))
        assert got is (not tamper)
        assert [m["proc"] for m, _ in replies] == ["proc1", "proc2"]
        # the plain versions count no launch
        assert all(m["launches"] == {"K3": 0, "K4": 0, "K5": 0}
                   for m, _ in replies)
    assert dispatch.snapshot()["error_replies"] == 0


# -- slow: the partials against the reference's jitted Miller product ----------


def _fq12_values(partial):
    from consensus_specs_tpu_torch.ops.bls import tower

    return tower.fq12_canonical(torch.as_tensor(np.asarray(partial)))


@pytest.mark.slow
def test_worker_partials_equal_the_references_jitted_miller_product(
        cpu_fabric):
    import jax

    from consensus_specs_tpu.ops.bls_jax import pairing as ref_pairing
    from consensus_specs_tpu_torch.crypto.bls import curve

    fn = jax.jit(ref_pairing._miller_product)
    chunks = workloads._pairing_lane_chunks(_pairs(curve, 4), 2)
    replies = dispatch.run_tasks(cpu_fabric, workloads.pairing_tasks(chunks))
    for chunk, (_, body) in zip(chunks, replies):
        want = np.asarray(fn(*chunk))
        assert torch.equal(_fq12_values(pickle.loads(body)),
                           _fq12_values(want))


@pytest.mark.slow
@pytest.mark.parametrize("n_lanes", [5, 9])
def test_lane_product_split_equals_the_one_item_product(n_lanes):
    """Above ``MAX_PAIRS`` lanes a chunk, ``lane_product`` splits the
    chunk into items of 4 pairs and a remainder; its value equals the
    Miller product of all the lanes as one item (which the CPU's plain
    version computes with no pair limit)."""
    from consensus_specs_tpu_torch.crypto.bls import curve
    from consensus_specs_tpu_torch.ops.bls import pairing

    (chunk,) = workloads._pairing_lane_chunks(_pairs(curve, n_lanes + 1)[
        :n_lanes], 1)
    lanes = [torch.as_tensor(a) for a in chunk]
    with torch.inference_mode():
        split = pairing.lane_product(*lanes)
        whole = pairing._miller_product(*lanes)
    assert torch.equal(_fq12_values(split), _fq12_values(whole))


@pytest.mark.slow
def test_two_process_capability_run_writes_no_file(tmp_path):
    """The port's twin of the reference's 2-process dryrun: epoch, merkle
    and pairing over a 2-worker fabric on the CPU, each equal to its
    in-process twin with no chunk re-dispatched, then a worker killed
    mid-run and the root recovered on the fabric; nothing is written."""
    from consensus_specs_tpu_torch import scenario
    from consensus_specs_tpu_torch.crypto.bls import curve
    from consensus_specs_tpu_torch.ssz.types import List as SSZList, uint64

    before = sorted(os.listdir(ROOT))
    inp, balances = scenario.example_delta_inputs(4096)
    with Fabric(n_workers=2, heartbeat_interval=0.1, device="cpu") as fab:
        ex = FabricExecutor(fab)
        got, mode = workloads.epoch_balances(ex, inp, balances, device="cpu")
        assert mode == "fabric" and np.array_equal(
            got, workloads.balance_update(inp, balances, "cpu"))
        root, mode = workloads.uint64_list_root(ex, got, 2**40)
        assert mode == "fabric" and root == bytes(SSZList[uint64, 2**40](
            [int(x) for x in got]).hash_tree_root())
        for tamper in (False, True):
            verdict, mode = workloads.pairing_lanes_check(
                ex, _pairs(curve, 8, tamper), device="cpu")
            assert (verdict, mode) == (not tamper, "fabric")
    assert dispatch.snapshot()["redispatched_chunks"] == 0
    plan = faults.FaultPlan([faults.Fault("dist.worker.exec", nth=1,
                                          kind="crash", proc="proc1")])
    with faults.inject(plan):
        with Fabric(n_workers=2, heartbeat_interval=0.1, device="cpu") as fab:
            killed, mode = workloads.uint64_list_root(
                FabricExecutor(fab), got, 2**40)
    assert (killed, mode) == (root, "fabric")
    assert dispatch.snapshot()["redispatched_chunks"] >= 1
    assert fabmod.snapshot()["workers_lost"] >= 1
    assert sorted(os.listdir(ROOT)) == before


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return "cuda"


@pytest.mark.cuda
def test_pairing_on_the_card_splits_wide_chunks(cuda_device):
    """Chunks of 10 lanes (K4 takes at most 4 pairs an item, so each
    worker splits its chunk into 4 + 4 + 2): the workers' partials equal
    the coordinator's as Fq12 values, the verdicts are right, and the
    workers launched K3 and K4."""
    from consensus_specs_tpu_torch.crypto.bls import curve

    with Fabric(n_workers=2, heartbeat_interval=0.1,
                device=cuda_device) as fab:
        ex = FabricExecutor(fab)
        for tamper in (False, True):
            pairs = _pairs(curve, 20, tamper)
            replies = []
            verdict, mode = workloads.pairing_lanes_check(
                ex, pairs, device=cuda_device, replies_out=replies)
            assert (verdict, mode) == (not tamper, "fabric")
            chunks = workloads._pairing_lane_chunks(pairs, 2)
            assert chunks[0][0].shape[0] == 10
            for chunk, (meta, partial) in zip(chunks, replies):
                mine = workloads.chunk_partial(*chunk, cuda_device)
                assert torch.equal(_fq12_values(partial),
                                   _fq12_values(mine))
                assert meta["launches"]["K4"] > 0
                assert meta["launches"]["K3"] > 0
    snap = dispatch.snapshot()
    assert snap["error_replies"] == 0 and snap["fallback_runs"] == 0
