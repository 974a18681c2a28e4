"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``consensus_specs_tpu_torch``) only; it imports nothing
of JAX and nothing of the reference package.  Phases, each printing its
seconds:

1. device: the card's name and power limit; builds the CUDA kernels, one
   nvcc call for sm_90a a library, all at once and beside the native BLS
   library's g++ build: K1 and K2 (``csrc/sha256.cu``,
   ``csrc/sha256_tree.cu``), K3 (``csrc/bls_fq.cu``), K4 and K5
   (``csrc/bls_miller.cu``, with their step tables
   ``csrc/bls_miller_schedule.cuh``); prints each kernel's ptxas report.
2. K1 against its plain torch version on the card, bit for bit, at
   N in {1, 129, 2^20} and at every level of the main path's balances
   reduction, and against hashlib on a sample; times both.
2b. K2 against its plain torch version and the per-level route (torch
   packing plus one K1 launch a level) at every power of two from 1 to 2^19
   chunks (one and two passes) and on the main path's balances; prints
   K2's ptxas report and the SASS opcode counts of K1 and K2 by pipe
   (``cuobjdump -sass``), with K1's ALU-pipe issue floor at 2^20 messages
   (a model, not a bound); times K2 and the per-level route in turns at the
   main path's shape, with kernel-only times from ``torch.profiler`` where
   it sees the card, one tree level in one warp, the bound, and two models
   (not bounds) of the tree's dependency chain.
3. the main path: one mainnet-preset phase0 epoch at 400,000 validators
   with BLS on — 32 signed blocks (3,904 aggregate attestations) through
   ``spec.state_transition`` on a CUDA-built spec, the last of which
   crosses the epoch boundary.  The fused epoch update must run once and
   launch K2 (one or two passes) and K1 not at all; the last block,
   replayed from its pre-state on a ``device="cpu"`` spec, must give the
   same post-state root.
3b. the engine at 400,000 validators: the same 32 blocks through the
   batched block engine, ``stf.apply_signed_blocks``, on a copy of phase
   3's pre-state whose balances were bulk-written again (unhashed, as a
   state loader leaves them), from cold engine caches.  Every block must
   take the fast path (none replayed, breaker closed, native BLS not
   degraded), the root must equal phase 3's, the fused epoch update must
   run once, K1 must not launch, and K2 must launch for the epoch and for
   the resident per-slot root of the bulk-written balances.
4. K1 as the SSZ layer hasher, on a freshly decoded copy of the
   post-state (each route hashes its own unhashed copy of that tree).  The
   ``"torch"`` backend's wave route (K1's path since it came: the whole
   wave schedule as one upload, K1's grid launches and one-block tails,
   one download) and its per-level route (the wave hasher unregistered:
   one dense K1 launch a wave of at least 256 messages, hashlib below)
   must both give hashlib's root and the main path's.  Prints the wave
   schedule's waves and K1 launches (grid waves, tails and their waves);
   holds every wave's digests against the plain version run on the card
   over the same pool and indices; times the schedule on the card (CUDA
   events over the whole schedule, ``torch.profiler``'s span from its
   first kernel's start to its last one's end, and the schedule with no
   tail, every wave a grid launch) beside its bound and the per-level
   route's K1 launches summed (each launch's input timed again, as
   before); and the wall time of each route's ``hash_tree_root``, in turns.
5. the altair main path: one mainnet-preset altair epoch at 400,000
   validators with BLS on — real pubkeys and sync committees, 32 signed
   blocks, each with the two preceding slots' aggregates and a sync
   aggregate of the whole 512-member committee — through
   ``spec.state_transition`` on a CUDA-built altair spec.  The literal
   altair path launches neither kernel; the boundary block, replayed on a
   ``device="cpu"`` spec, must give the same root.
5b. the altair engine: the same blocks through ``stf.apply_signed_blocks``
   from cold engine caches.  Every block fast, the root phase 5's, K1 not
   launched, K2 launched for every resident per-slot root (each block's
   sync rewards leave the balances subtree unhashed at its state-root
   check).  Prints the engine's phases, one resident root split into the
   balance walk, the upload and K2 beside the host's incremental root of
   the same list, and the epoch's flag deltas with
   ``epoch_altair.DEVICE_COLUMNS`` on (torch on the card) and off (the
   host loop), which must give equal balances.
6. the bellatrix main path: phase 5's epoch on a bellatrix spec, past the
   merge, each block also carrying an execution payload of 150 random
   transactions (~90 KB) that extends the one before; literally on a
   CUDA-built spec, no kernel launched, the boundary block on a
   ``device="cpu"`` spec with the same root.  Phases 3 and 5's states are
   freed before it.
6b. the bellatrix engine on the same blocks from cold caches: every block
   fast, the root phase 6's, K1 not launched, K2 launched for every
   resident per-slot root, one sync aggregate a block; prints the engine's
   phases, the payload step's seconds (inside ``other_s``) and GC pauses.
6c. capella on the card: a minimal-preset capella epoch with one full
   withdrawal and one BLS-to-execution change on a CUDA-built spec, equal
   to a CPU-built spec's root after every block; the engine replays every
   capella block literally, with the same root.
7a. the reference's spec cases on the card: the tier-1 subset of the JAX
   package's ``tests/spec/`` cases (``testing/reference_cases.TIER1``:
   epoch sub-steps, exits, proposer slashings, slots with a config
   override, rewards, sync aggregates, the execution payload, capella's
   withdrawals), loaded by the port's ``testing/`` and run on specs built
   for the card.  Every case must pass, and no CPU-built spec may appear;
   prints the passed and skipped counts per case directory and the K1 and
   K2 launches.
7b. the config-override epoch at 400,000 validators, mainnet preset, for
   phase0, altair and bellatrix: a spec built with ``CHURN_LIMIT_QUOTIENT``
   overridden to 4,096 (``build_spec(..., config=)``) on the card and on
   the CPU, the main path's pre-state with a seeded queue of 1,024
   validators eligible for activation appended, and ``process_slots``
   across the epoch boundary.  The card's root must equal the CPU's and
   differ from the default config's on the card (more of the queue is
   let in); on phase0 the fused epoch update runs once and launches K2.
8a. the device BLS kernels against their plain versions on the card: K3
   (the Fq Montgomery product) at 2^20 operand pairs at the edge of its
   envelope, which must also keep its output contract (digits in
   [0, 2^26), values below 3p); K4 (a run of Miller doublings) and K5 (a
   run of Fq12 squarings), one block an item, at B in {2, 32, 64} items
   (8c's padded check, configs 2 and 3), K in {1, 2} pairs and n in
   {1, 32} steps, and at B = 64 also against the plain versions on the
   host.  Canonical values and limbs equal.  Times (CUDA events,
   ``torch.profiler`` kernel only) at each B at K = 2, n = 32, with the
   share of the SMs the launch holds, the plain versions' times at B = 64,
   K3's SASS multiplies a product beside the 512 a product needs, and the
   bounds (from the 512).
8b. the device BLS backend, ``ops.bls.batch_fast_aggregate_verify`` on the
   card, at the reference bench's BASELINE configs 2 (32 items of one
   512-pubkey aggregate) and 3 (64 items of one 128-pubkey aggregate),
   keys ``SkToPk(1..512)`` signed natively: every verdict True; verifies/s
   split into host marshalling and device pairing, beside native
   ``BatchFastAggregateVerify``, with K3/K4/K5 launches a batch (each
   above 0) and K3's launch shapes, K3's first launch at each of them
   held against its plain version.  Then a mixed batch of 64 from the
   seed (valid items, wrong messages, other keys' signatures, malformed
   pubkeys, empty pubkey lists, infinity signatures) whose every verdict
   must equal native ``FastAggregateVerify``'s.
8c. the reference's always-BLS cases of ``phase0/test_batch_verification.py``,
   ``phase0/block_processing/test_process_attestation.py`` and
   ``altair/test_sync_aggregate.py`` on CUDA-built minimal specs, under
   the "native" backend and then the "torch" one: the same passed and
   skipped counts, and K3 launched under "torch".

The CPU legs take the boundary block's pre-state by its backing tree (no
serialize round trip) and hash on the host (a CPU spec keeps the host
hashing path), so they are independent of K2.  Every comparison is exact
(tolerance 0): digests, roots, field limbs and verdicts are integers,
bytes and booleans.  Then one JSON line of the kernels (launches on the path that
drives each, error against the plain version, times on that path's
shapes, the bound), the
``nvidia-smi`` line, and last the device line.  Any failed phase raises:
the exit code is non-zero and no result line is printed.  Without CUDA it
fails before any phase.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit ALU lane
# operations/s (132 SMs x 128 lanes x 1.98 GHz, the instruction rate
# behind the 67 TFLOP/s float32 figure, which counts an FMA as two)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
SM_CLOCK_HZ = 1.98e9

# the main path's registry size (the scale BASELINE.json states)
N_VALIDATORS = 400_000

# Two models, not bounds, of K2's dependency chain (csrc/sha256_tree.cu),
# printed beside its time and never in the kernels line.  The schedule
# model: a warp alone on its SM sub-partition issues as ptxas scheduled
# it, so each dependent tree level costs the scheduled cycles of one
# message hash (the stall counts in the SASS of K1's tail kernel, which is
# one hash through K2's AluPipe, its loads and stores, and its wave loop).
# The chain floor: each of the 128 rounds of a level waits for three
# dependent instructions (from e to the next e: a rotate, the xor, an add)
# of about four cycles each.
CHAIN_OPS_PER_ROUND = 3
DEPENDENT_LATENCY_CYCLES = 4
ROUNDS_PER_MESSAGE = 128

# Calls profiled one at a time are further apart than this on the card;
# the passes of one call overlap (a dependent launch) or follow within it
SPAN_GAP_US = 5.0

# SASS opcodes by the pipe that runs them (the rest: uniform datapath,
# control, conversions), for the opcode counts of K1 and K2
SASS_PIPES = {
    "alu": ("SHF", "LOP3", "IADD3", "LEA", "ISETP", "SEL", "PRMT", "MOV",
            "IABS", "FLO", "POPC", "PLOP3", "P2R", "R2P"),
    "fma": ("IMAD", "IMUL"),
    "memory": ("LDS", "STS", "LDG", "STG", "LDC", "SHFL", "LD", "ST"),
    "barrier": ("BAR",),
}


def _phase(name: str):
    class _Timer:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[phase] {name} ...", flush=True)
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                print(f"[phase] {name}: ok in {time.perf_counter() - self.t0:.3f} s",
                      flush=True)
            return False

    return _Timer()


class GcPauses:
    """Seconds the cyclic garbage collector held the process, its
    collections and how many of them were full (generation 2), while the
    context is open: a host pause of the engine's timed run that none of
    its own phase counters names."""

    def __enter__(self):
        self.seconds, self.collections, self.full = 0.0, 0, 0
        self._t0 = None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.collections += 1
            self.full += info["generation"] == 2
            self._t0 = None

    def __exit__(self, exc_type, exc, tb):
        gc.callbacks.remove(self._note)
        return False

    def __str__(self):
        return (f"gc pauses {self.seconds:.3f} s in {self.collections} "
                f"collections ({self.full} full)")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_messages: int, sha) -> tuple:
    ops_ms = n_messages * sha.OPS_PER_MESSAGE / PEAK_INT32_OPS_PER_S * 1e3
    bytes_ms = n_messages * sha.BYTES_PER_MESSAGE / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def profiled_kernel_ms(fn, calls: int = 10):
    """Device time per call of ``fn()`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls, each waited for, so that no
    launch overlaps the call before it: {name: (ms, launches)} and the sum
    over all kernels, or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[evt.key] = (evt.self_device_time_total / calls / 1e3,
                            evt.count / calls)
    total = sum(ms for ms, _ in kernels.values())
    return (kernels, total) if total > 0 else None


def profiler_sees_device() -> bool:
    """Whether ``torch.profiler`` records device time here (it may not in a
    sandbox); only the profiler's own failure is caught."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x.add_(1)
            torch.cuda.synchronize()
        seen = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    except RuntimeError as exc:
        print(f"torch.profiler failed: {exc}", flush=True)
        return False
    return seen > 0


def profiled_span_ms(fn, fragment: str, launches: int, calls: int = 10):
    """Device time a call of ``fn()`` spends in the kernels whose name holds
    ``fragment``, from the first one's start to the last one's end (so a
    launch that starts early and waits for the one before it counts once):
    the median over ``calls`` calls, each waited for, that each launch
    ``launches`` of them.  A call's kernels are those that overlap or follow
    each other within ``SPAN_GAP_US``; calls whose kernels the profiler did
    not all record, or recorded late, are left out.  None where fewer than
    half the calls were whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and fragment in e.name)
    groups = []  # [first start, last end, kernels]
    for start, end in kernels:
        if groups and start <= groups[-1][1] + SPAN_GAP_US:
            groups[-1][1] = max(groups[-1][1], end)
            groups[-1][2] += 1
        else:
            groups.append([start, end, 1])
    spans = sorted(end - start for start, end, n in groups if n == launches)
    if 2 * len(spans) < calls:
        print(f"  profiler: {len(kernels)} {fragment} events in {len(groups)} "
              f"groups, {len(spans)} of {calls} calls whole", flush=True)
        return None
    return spans[len(spans) // 2] / 1e3


def retried(measure, attempts: int = 3):
    """``measure()``, taken again while it returns None (the profiler now
    and then records a call's kernels late or not at all), at most
    ``attempts`` times; None if it never succeeded."""
    for _ in range(attempts):
        got = measure()
        if got is not None:
            return got
    return None


def kernel_ms_of(profiled, fragment: str):
    """(ms, launches) a call of the kernels whose name holds ``fragment``,
    or None when the profiler saw none of them."""
    if profiled is None:
        return None
    hits = [v for k, v in profiled[0].items() if fragment in k]
    if not hits:
        return None
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


# -- phase 1 ----------------------------------------------------------------


# the CUDA libraries phase 1 builds, one nvcc call each, all at once:
# (label, module of the port, kernel names for the ptxas report)
CUDA_LIBRARIES = (
    ("K1 + K2", "consensus_specs_tpu_torch.ops.sha256", ()),
    ("K3", "consensus_specs_tpu_torch.ops.bls.limbs", ("fq_mul_kernel",)),
    ("K4 + K5", "consensus_specs_tpu_torch.ops.bls.pairing",
     ("miller_dbl_run_kernel", "fq12_sq_run_kernel")),
)


def phase_device():
    import importlib

    smi = nvidia_smi_line()
    print(f"card: {smi} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible); python "
          f"{sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    built = {}

    def build(label, module):
        t0 = time.perf_counter()
        built[label] = (importlib.import_module(module).build_kernel(),
                        time.perf_counter() - t0)

    for _, module, _ in CUDA_LIBRARIES:  # imported here, not in the threads
        importlib.import_module(module)
    workers = [threading.Thread(target=build, args=(label, module))
               for label, module, _ in CUDA_LIBRARIES]
    for worker in workers:
        worker.start()
    t0 = time.perf_counter()
    from consensus_specs_tpu_torch.crypto import bls

    bls.use_native()  # builds the native BLS library with g++
    bls_s = time.perf_counter() - t0
    for worker in workers:
        worker.join()
    missing = [label for label, _, _ in CUDA_LIBRARIES if label not in built]
    if missing:
        raise RuntimeError(f"{missing} build failed (see the threads' "
                           "tracebacks above)")
    print("built in parallel: " + ", ".join(
        f"{label} {built[label][1]:.3f} s" for label, _, _ in CUDA_LIBRARIES)
        + f" (one nvcc call each, sm_90a), native BLS {bls_s:.3f} s", flush=True)
    for label, _, kernels in CUDA_LIBRARIES:
        log_path = built[label][0] + ".log"
        lines = ([line for k in kernels for line in ptxas_report(log_path, k)]
                 if kernels else
                 [line.strip() for line in open(log_path).read().splitlines()
                  if any(k in line for k in ("entry function", "registers",
                                             "spill"))])
        for line in lines:
            print(f"  ptxas {label}: {line}")
    return smi


# -- phase 2 ----------------------------------------------------------------


def _plain_on(words: torch.Tensor) -> torch.Tensor:
    from consensus_specs_tpu_torch.ops import sha256

    return sha256.to_int32_bits(
        sha256.sha256_block64_plain(sha256.from_int32_bits(words)))


def _reduce_levels(words: torch.Tensor, compress) -> torch.Tensor:
    """The main path's level loop (merkle_resident._reduce_to_root) with a
    chosen compression: [2^k, 8] chunk words -> [8] root."""
    level = words
    while level.shape[0] > 1:
        level = compress(level.reshape(level.shape[0] // 2, 16))
    return level[0]


def _balance_values(n_validators: int, seed: int) -> torch.Tensor:
    """A balances vector of the main path's length, zero-padded to its
    power of two as the fused update hands it to the reduction."""
    rng = np.random.default_rng(seed)
    n_pad = 1 << (n_validators - 1).bit_length()
    bal = np.zeros(n_pad, dtype=np.int64)
    bal[:n_validators] = rng.integers(31 * 10**9, 33 * 10**9, n_validators)
    return torch.as_tensor(bal, device="cuda")


def _leaf_words(values: torch.Tensor) -> torch.Tensor:
    """Chunk words of packed uint64 values, as the plain reduction packs
    them: [n_chunks, 8] int32."""
    from consensus_specs_tpu_torch.ops import merkle_resident

    return merkle_resident._chunk_words(*merkle_resident._u64_halves(values))


def _per_level_route(values: torch.Tensor) -> torch.Tensor:
    """The reduction as the main path ran it before K2: torch packing ops,
    then one K1 launch a level (plus a mask of the high halves, so that
    values with the top bit set are packed right)."""
    from consensus_specs_tpu_torch.ops import merkle_resident

    return merkle_resident._reduce_to_root(*merkle_resident._u64_halves(values))


def _k2_plain(values: torch.Tensor) -> torch.Tensor:
    """K2's plain version on the values' device."""
    return _reduce_levels(_leaf_words(values), _plain_on)


def phase_k1(n_validators: int, seed: int) -> dict:
    from consensus_specs_tpu_torch.ops import sha256

    rng = np.random.default_rng(seed)
    max_err = 0
    for n in (1, 129, 1 << 20):
        host = rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
        host[0, :8] = 0xFFFFFFFF  # words >= 2^31
        words = torch.from_numpy(host.view(np.int32)).cuda()
        got = sha256.sha256_block64(words)
        want = _plain_on(words)
        torch.cuda.synchronize()
        err = int((sha256.from_int32_bits(got) - sha256.from_int32_bits(want))
                  .abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"K1 != plain at N={n}: max |diff| {err}")
        sample = rng.choice(n, size=min(n, 1024), replace=False)
        got_host = got.cpu().numpy().view(np.uint32)
        for i in sample:
            want_digest = hashlib.sha256(host[i].astype(">u4").tobytes()).digest()
            if got_host[i].astype(">u4").tobytes() != want_digest:
                raise AssertionError(f"K1 != hashlib at N={n}, message {i}")
        print(f"K1 == plain == hashlib at N={n}", flush=True)

    big = torch.from_numpy(
        rng.integers(0, 2**32, (1 << 20, 16), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).cuda()
    k1_big = cuda_ms(lambda: sha256.sha256_block64(big), iters=50)
    plain_big = cuda_ms(lambda: _plain_on(big), iters=3, warmup=1)
    bound_big, by_big = bound_ms(1 << 20, sha256)
    print(f"N=2^20: K1 {k1_big:.5f} ms, plain {plain_big:.3f} ms, bound "
          f"{bound_big:.5f} ms ({by_big})", flush=True)

    # the main path's shapes: every level of the balances reduction
    leaves = _leaf_words(_balance_values(n_validators, seed))
    root_k1 = _reduce_levels(leaves, sha256.sha256_block64)
    root_plain = _reduce_levels(leaves, _plain_on)
    if not torch.equal(root_k1, root_plain):
        raise AssertionError("K1 != plain on the main path's reduction")
    n_messages = leaves.shape[0] - 1
    k1_path = cuda_ms(lambda: _reduce_levels(leaves, sha256.sha256_block64))
    plain_path = cuda_ms(lambda: _reduce_levels(leaves, _plain_on),
                         iters=3, warmup=1)
    bound_path, by_path = bound_ms(n_messages, sha256)
    print(f"main-path reduction ({leaves.shape[0]} chunks, {n_messages} "
          f"messages in {leaves.shape[0].bit_length() - 1} launches): K1 "
          f"{k1_path:.4f} ms, plain {plain_path:.3f} ms, bound "
          f"{bound_path:.5f} ms ({by_path})", flush=True)
    # these shapes are off K1's path since K2 took the reduction; its
    # kernels entry is timed on the SSZ hasher's wave route (phase 4)
    return {"max_abs_err": max_err, "dense_2e20_ms": k1_big}


# -- phase 2b ---------------------------------------------------------------


def ptxas_report(log_path: str, fragment: str) -> list:
    """The lines of ``nvcc -Xptxas -v``'s report on the kernel whose name
    holds ``fragment``: registers, spills, shared memory."""
    lines, inside = [], False
    with open(log_path) as log:
        for line in log.read().splitlines():
            if "Compiling entry function" in line:
                inside = fragment in line
            if inside:
                lines.append(line.strip())
    return lines


def sass_kernels(lib_path: str):
    """{kernel name: (Counter of SASS opcodes, scheduled cycles)} of the
    library, from ``cuobjdump -sass`` (static: each instruction of the code
    once), or None where cuobjdump is missing.  The scheduled cycles are
    the sum of the stall counts ptxas wrote into the instructions' control
    bits (bits 41..44 of the upper 64-bit word): the cycles a warp alone on
    its sub-partition waits after each instruction before it issues the
    next, for every wait of fixed length (memory waits on scoreboards are
    not in it)."""
    import collections
    import os
    import re
    import shutil

    local = "/usr/local/cuda/bin/cuobjdump"
    tool = shutil.which("cuobjdump") or (local if os.path.exists(local) else None)
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    kernels, name, pending = {}, None, False
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    upper = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/\s*$")
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            kernels[name] = [collections.Counter(), 0]
            continue
        if name is None:
            continue
        hit = instr.search(line)
        if hit:
            kernels[name][0][hit.group(1)] += 1
            pending = True
            continue
        word = upper.match(line)
        if word and pending:
            kernels[name][1] += (int(word.group(1), 16) >> 41) & 0xF
            pending = False
    return {k: (ops, cycles) for k, (ops, cycles) in kernels.items()}


def by_pipe(opcodes) -> dict:
    """Instruction counts by pipe (``SASS_PIPES``; the rest under "other")."""
    pipes = dict.fromkeys((*SASS_PIPES, "other"), 0)
    for op, n in opcodes.items():
        base = op.split(".")[0]
        pipe = next((k for k, v in SASS_PIPES.items() if base in v), "other")
        pipes[pipe] += n
    return pipes


# K1's kernels and K2's, by label and the fragments of their (mangled)
# names: K1's grid kernel instantiated for dense rows and for gathered
# pairs, its one-block tail, K2
SASS_KERNELS = (("K1 dense", ("sha256_block64_kernel", "DenseRows")),
                ("K1 wave", ("sha256_block64_kernel", "GatheredPairs")),
                ("K1 tail", ("sha256_waves_tail_kernel",)),
                ("K2", ("tree_reduce_kernel",)))


def print_sass(lib_path: str):
    """Print the SASS opcode counts of K1's kernels and K2 by pipe, per
    round of their one unrolled message hash, and their scheduled cycles;
    return the scheduled cycles of K1's tail kernel, one message hash
    through the core's AluPipe as K2 hashes (None where cuobjdump is
    missing)."""
    kernels = sass_kernels(lib_path)
    if kernels is None:
        print("SASS opcode counts: not measured (no cuobjdump)", flush=True)
        return None
    tail_cycles = None
    for label, fragments in SASS_KERNELS:
        names = [k for k in kernels if all(f in k for f in fragments)]
        if len(names) != 1:
            raise AssertionError(f"cuobjdump shows {len(names)} kernels for "
                                 f"{label} ({fragments})")
        ops, cycles = kernels[names[0]]
        pipes = by_pipe(ops)
        per_round = ", ".join(f"{k} {v / ROUNDS_PER_MESSAGE:.2f}"
                              for k, v in pipes.items())
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common())
        print(f"SASS {label} ({sum(ops.values())} instructions, {cycles} "
              f"scheduled cycles, static): by pipe {pipes}; a round of its "
              f"one message hash: {per_round}; opcodes: {top}", flush=True)
        if label == "K1 tail":
            tail_cycles = cycles
        if label == "K1 dense":
            # models, not bounds: each pipe issues 16 lanes a clock on each
            # of an SM's four sub-partitions, at the 1.98 GHz behind
            # PEAK_INT32_OPS_PER_S
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            lanes = 64 * sms * SM_CLOCK_HZ
            alu_ms = pipes["alu"] * (1 << 20) / lanes * 1e3
            fma_ms = pipes["fma"] * (1 << 20) / lanes * 1e3
            print(f"K1 issue floors at N=2^20 (models, not bounds: "
                  f"{pipes['alu']} ALU-pipe and {pipes['fma']} FMA-pipe "
                  f"instructions a message, 64 lanes a clock on each of {sms} "
                  f"SMs at {SM_CLOCK_HZ / 1e9} GHz): ALU pipe {alu_ms:.4f} ms, "
                  f"FMA pipe {fma_ms:.4f} ms", flush=True)
    return tail_cycles


def _word_err(got: torch.Tensor, want: torch.Tensor) -> int:
    from consensus_specs_tpu_torch.ops import sha256

    return int((sha256.from_int32_bits(got) - sha256.from_int32_bits(want))
               .abs().max())


def phase_k2(n_validators: int, seed: int) -> dict:
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256

    rng = np.random.default_rng(seed + 1)
    max_err, pass_counts = 0, set()
    for k in range(20):
        host = rng.integers(0, 2**64, 4 << k, dtype=np.uint64)
        host[0] = 2**64 - 1  # top bits set
        host[-1] = 2**63
        values = torch.from_numpy(host.view(np.int64)).cuda()
        before = sha256.counts["u64_list_root"]
        got = merkle_resident.packed_u64_root(values)
        passes = sha256.counts["u64_list_root"] - before
        plain = _k2_plain(values)
        route = _per_level_route(values)
        torch.cuda.synchronize()
        err = max(_word_err(got, plain), _word_err(got, route))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"K2 != plain / per-level route at 2^{k} "
                                 f"chunks: max |diff| {err}")
        if passes != sha256.k2_plan(1 << k)[0]:
            raise AssertionError(f"K2 ran {passes} passes at 2^{k} chunks")
        pass_counts.add(passes)
    print(f"K2 == plain == per-level route at 2^0 .. 2^19 chunks "
          f"({sorted(pass_counts)} passes, as the launcher reported them)",
          flush=True)

    values = _balance_values(n_validators, seed)
    n_chunks = values.shape[0] // 4
    got = merkle_resident.packed_u64_root(values)
    plain = _k2_plain(values)
    route = _per_level_route(values)
    torch.cuda.synchronize()
    err = max(_word_err(got, plain), _word_err(got, route))
    max_err = max(max_err, err)
    if err:
        raise AssertionError(f"K2 != plain on the main path's balances: {err}")
    print(f"K2 == plain == per-level route on the main path's balances "
          f"({n_chunks} chunks)", flush=True)

    # in turns: per-level route, K2, K2, per-level route
    k2 = lambda: merkle_resident.packed_u64_root(values)  # noqa: E731
    route_a = cuda_ms(lambda: _per_level_route(values))
    k2_a = cuda_ms(k2)
    k2_b = cuda_ms(k2)
    route_b = cuda_ms(lambda: _per_level_route(values))
    plain_ms = cuda_ms(lambda: _k2_plain(values), iters=3, warmup=1)
    k2_ms = (k2_a + k2_b) / 2
    route_ms = (route_a + route_b) / 2

    n_messages = n_chunks - 1
    levels = n_chunks.bit_length() - 1
    ops_ms = n_messages * sha256.OPS_PER_MESSAGE / PEAK_INT32_OPS_PER_S * 1e3
    bytes_ms = (values.numel() * 8 + 32) / PEAK_BYTES_PER_S * 1e3
    bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                       else (bytes_ms, "bytes"))
    print(f"main-path root ({n_chunks} chunks, {n_messages} messages, "
          f"{levels} levels): K2 {k2_a:.5f} / {k2_b:.5f} ms "
          f"({sha256.k2_plan(n_chunks)[0]} launches a call), per-level route "
          f"{route_a:.5f} / {route_b:.5f} ms (torch packing + {levels} K1 "
          f"launches), plain {plain_ms:.3f} ms; bound {bound:.5f} ms "
          f"({bound_by}; operations {ops_ms:.5f}, bytes {bytes_ms:.5f})",
          flush=True)

    # what the compiler made of K2, and two models of its chain
    lib = sha256.build_kernel()
    for line in ptxas_report(lib + ".log", "tree_reduce_kernel"):
        print(f"  K2 ptxas: {line}", flush=True)
    issue_cycles = print_sass(lib)
    clock_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    chain_cycles = ROUNDS_PER_MESSAGE * CHAIN_OPS_PER_ROUND * DEPENDENT_LATENCY_CYCLES
    chain_ms = levels * chain_cycles / (clock_mhz * 1e6) * 1e3
    issue_text = ("not measured (no SASS)" if issue_cycles is None else
                  f"{levels * issue_cycles / (clock_mhz * 1e6) * 1e3:.5f} ms "
                  f"({levels} levels x {issue_cycles} scheduled cycles of K1's "
                  f"tail, one hash through the same AluPipe)")
    print(f"chain floor (model, not a bound): {chain_ms:.5f} ms ({levels} levels "
          f"x {ROUNDS_PER_MESSAGE} rounds x {CHAIN_OPS_PER_ROUND} dependent "
          f"instructions x {DEPENDENT_LATENCY_CYCLES} cycles at {clock_mhz:.0f} "
          f"MHz); schedule model (not a bound): {issue_text}", flush=True)

    # kernel-only device times, where the profiler sees the card
    kernel_ms = None
    if not profiler_sees_device():
        print("kernel-only times: not measured (no device time in the "
              "profiler)", flush=True)
    else:
        passes = sha256.k2_plan(n_chunks)[0]
        def route_profile():
            prof = profiled_kernel_ms(lambda: _per_level_route(values))
            return prof if kernel_ms_of(prof, "sha256_block64_kernel") else None

        prof_route = retried(route_profile)
        k1_kernel = kernel_ms_of(prof_route, "sha256_block64_kernel")
        kernel_ms = retried(lambda: profiled_span_ms(k2, "tree_reduce_kernel",
                                                     passes))
        small = {}
        for k in (1, 5):
            v = torch.zeros(4 << k, dtype=torch.int64, device="cuda")
            small[k] = retried(lambda v=v: kernel_ms_of(profiled_kernel_ms(
                lambda: merkle_resident.packed_u64_root(v)),
                "tree_reduce_kernel"))
        if k1_kernel is None or kernel_ms is None or None in small.values():
            raise AssertionError("the profiler saw device time but not K2's "
                                 "or K1's kernels, three times over")
        print(f"kernel-only (torch.profiler): K2 {kernel_ms:.5f} ms from its "
              f"first pass's start to its last one's end ({passes} launches a "
              f"call); per-level route: K1 {k1_kernel[0]:.5f} ms in "
              f"{k1_kernel[1]:g} launches, all its kernels {prof_route[1]:.5f} "
              f"ms", flush=True)
        small = {k: ms for k, (ms, _) in small.items()}
        # 2 chunks: one message; 32 chunks: five levels in one warp
        level_us = (small[5] - small[1]) / 4 * 1e3
        model = ("" if issue_cycles is None
                 else f" against the schedule model's {issue_cycles}")
        print(f"one level in one warp (K2 at 32 chunks less K2 at 2, over "
              f"4 levels): {level_us:.3f} us, {level_us * clock_mhz:.0f} "
              f"cycles{model}", flush=True)
    return {"max_abs_err": max_err, "ms": k2_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "kernel_ms": kernel_ms,
            "per_level_route_ms": route_ms}


def cpu_leg_state(cpu_spec, pre_last):
    """The boundary block's pre-state as a state of the CPU-built spec,
    taken by its backing tree.  A serialize and decode round trip of a
    400k-validator state cost about a minute a phase on the card's host;
    the tree it shares holds no root from the card (the literal paths
    launch no kernel before the boundary block), so the CPU leg's
    transition and hashing of the boundary block stay the host's own."""
    return cpu_spec.BeaconState.view_from_backing(pre_last.get_backing())


# -- phase 3 ----------------------------------------------------------------


def phase_main_path(n_validators: int) -> dict:
    from consensus_specs_tpu_torch import scenario
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec("phase0", "mainnet", device="cuda")
    t0 = time.perf_counter()
    state = scenario.build_main_path_state(spec, n_validators)
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = scenario.build_epoch_blocks(spec, state)
    t_blocks = time.perf_counter() - t0
    n_atts = sum(len(b.message.body.attestations) for b in blocks)
    print(f"set-up: state {t_state:.3f} s, {len(blocks)} signed blocks with "
          f"{n_atts} aggregate attestations {t_blocks:.3f} s", flush=True)
    if len(blocks) != int(spec.SLOTS_PER_EPOCH):
        raise AssertionError("expected one epoch of blocks")

    bls.bls_active = True
    post = state.copy()
    pre_last = None
    merkle_resident.stats["fused_epoch_updates"] = 0
    sha256.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, signed in enumerate(blocks):
        if i == len(blocks) - 1:
            pre_last = post.copy()
            t_last = time.perf_counter()
        spec.state_transition(post, signed, True)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t_path = t_end - t0
    k2_launches = sha256.counts["u64_list_root"]
    k1_launches = sha256.counts["sha256_block64"]
    fused = merkle_resident.stats["fused_epoch_updates"]
    root = bytes(post.hash_tree_root())
    print(f"main path: {len(blocks)} blocks in {t_path:.3f} s (last block, "
          f"with the epoch transition: {t_end - t_last:.3f} s); fused epoch "
          f"updates {fused}, K2 launches {k2_launches}, K1 launches "
          f"{k1_launches}; root {root.hex()}", flush=True)
    if fused != 1:
        raise AssertionError(f"fused epoch update ran {fused} times, not once")
    if k2_launches not in (1, 2):
        raise AssertionError(f"the epoch transition launched K2 {k2_launches} "
                             "times, not once or twice")
    if k1_launches != 0:
        raise AssertionError(f"the epoch transition launched K1 {k1_launches} "
                             "times; its root goes through K2")

    # the CPU leg: the boundary block on a CPU-built spec
    cpu_spec = get_spec("phase0", "mainnet", device="cpu")
    cpu_state = cpu_leg_state(cpu_spec, pre_last)
    cpu_block = cpu_spec.SignedBeaconBlock.decode_bytes(
        bytes(blocks[-1].encode_bytes()))
    t0 = time.perf_counter()
    cpu_spec.state_transition(cpu_state, cpu_block, True)
    t_cpu = time.perf_counter() - t0
    cpu_root = bytes(cpu_state.hash_tree_root())
    print(f"cpu leg: boundary block in {t_cpu:.3f} s; root {cpu_root.hex()}",
          flush=True)
    if cpu_root != root:
        raise AssertionError("cuda and cpu post-state roots differ")
    return {"k2_launches": k2_launches, "k1_launches": k1_launches,
            "post": post, "spec": spec, "attestations": n_atts,
            "pre": state, "blocks": blocks, "root": root, "seconds": t_path}


# -- phase 3b ---------------------------------------------------------------

ENGINE_PHASES = ("slot_roots_s", "sig_verify_s", "attestation_apply_s",
                 "other_s")


def run_engine(label: str, spec, state, blocks, literal: dict,
               phase_keys: tuple) -> dict:
    """The engine on ``blocks`` from cold caches (it pays for its own
    committee geometry, device buffers and signature checks), with the
    tracing counters on and the kernels' counts zeroed just before it.
    Prints its phases and counts, raises unless every block took the fast
    path, K1 did not launch and the root is the literal path's, and
    returns the run's counts and seconds."""
    from consensus_specs_tpu_torch import stf, tracing
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256
    from consensus_specs_tpu_torch.stf import attestations, pipeline, verify

    stf.reset_stats()
    verify.reset_memo()
    attestations.reset_caches()
    bls.bls_active = True
    tracing.enable()
    tracing.reset()
    merkle_resident.stats["fused_epoch_updates"] = 0
    sha256.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with GcPauses() as pauses:
            stf.apply_signed_blocks(spec, state, blocks, True)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counters = tracing.report()["counters"]
    finally:
        tracing.disable()
    run = {"k2_launches": sha256.counts["u64_list_root"],
           "k1_launches": sha256.counts["sha256_block64"],
           "fused": merkle_resident.stats["fused_epoch_updates"],
           "resident": counters.get("stf.resident_slot_root", 0),
           "sync": counters.get("stf.sync_aggregate", 0),
           "seconds": seconds, "gc_s": pauses.seconds,
           **{k: stf.stats[k] for k in phase_keys}}
    root = bytes(state.hash_tree_root())
    print(f"{label}: {len(blocks)} blocks in {seconds:.3f} s (literal path: "
          f"{literal['seconds']:.3f} s); "
          + ", ".join(f"{k} {run[k]:.3f}" for k in phase_keys)
          + f"; fast blocks {stf.stats['fast_blocks']}, replayed "
          f"{stf.stats['replayed_blocks']} {stf.stats['replay_reasons']}, "
          f"breaker trips {stf.stats['breaker_trips']}, native degraded "
          f"{verify.stats['native_degraded']}; signature batches "
          f"{verify.stats['batches']} ({verify.stats['entries']} entries, "
          f"{verify.stats['memo_hits']} memo hits), sync aggregates "
          f"{run['sync']}, pipeline overlap "
          f"{pipeline.stats['overlap_s']:.3f} s, await "
          f"{pipeline.stats['await_s']:.3f} s; {pauses}", flush=True)
    print(f"{label}: fused epoch updates {run['fused']}, "
          f"stf.resident_slot_root {run['resident']}, K2 launches "
          f"{run['k2_launches']}, K1 launches {run['k1_launches']}; root "
          f"{root.hex()}", flush=True)
    if (stf.stats["fast_blocks"] != len(blocks)
            or stf.stats["replayed_blocks"] != 0
            or stf.stats["replay_reasons"] != {}
            or stf.stats["breaker_trips"] != 0
            or verify.stats["native_degraded"] != 0):
        raise AssertionError(f"{label} left its fast path: {stf.stats}")
    if root != literal["root"]:
        raise AssertionError(f"{label} root differs from the literal path's")
    if run["k1_launches"] != 0:
        raise AssertionError(f"{label} launched K1 {run['k1_launches']} times")
    n_chunks = 1 << ((len(state.balances) + 3) // 4 - 1).bit_length()
    if run["k2_launches"] != sha256.k2_plan(n_chunks)[0] * (
            run["fused"] + run["resident"]):
        raise AssertionError(f"K2 launched {run['k2_launches']} times for "
                             f"{run['fused']} epoch and {run['resident']} "
                             "slot roots")
    return run


def phase_engine(main_path: dict) -> dict:
    from consensus_specs_tpu_torch.ssz import bulk

    state = main_path["pre"].copy()
    # a state as a loader hands it over: the balances bulk-written, their
    # subtree unhashed, so the first slot root takes the resident route
    bulk.set_packed_uint64_from_numpy(
        state.balances, bulk.packed_uint64_to_numpy(state.balances))
    run = run_engine("engine", main_path["spec"], state, main_path["blocks"],
                     main_path, ENGINE_PHASES)
    if run["fused"] != 1:
        raise AssertionError(f"fused epoch update ran {run['fused']} times, "
                             "not once")
    if run["resident"] != 1:
        raise AssertionError(f"the resident slot root fired {run['resident']} "
                             "times on bulk-written balances, not once")
    return run


# -- phase 4 ----------------------------------------------------------------


def unhashed_copy(root):
    """The tree under ``root`` with every branch node that has no root yet
    rebuilt as a new one, the tree's sharing kept: the same hashing work
    as ``root`` itself, without another decode.  Leaves and nodes with a
    root (the shared zero subtrees) stay as they are."""
    from consensus_specs_tpu_torch.ssz.node import BranchNode

    memo = {}

    def copy(n):
        if n._root is not None or not isinstance(n, BranchNode):
            return n
        got = memo.get(id(n))
        if got is None:
            got = memo[id(n)] = BranchNode(copy(n.left), copy(n.right))
        return got

    enabled = gc.isenabled()
    gc.disable()  # millions of new nodes: set-up, not the measured root
    try:
        return copy(root)
    finally:
        if enabled:
            gc.enable()


def profiled_schedule_ms(fn, fragment: str, launches: int, calls: int = 10):
    """Device time of a call of ``fn()`` from the start of the first of its
    ``launches`` kernels whose name holds ``fragment`` to the end of the
    last, by ``torch.profiler``: the median over ``calls`` calls, each
    waited for, so that a call's kernels are the next ``launches`` in start
    order.  None unless the profiler recorded every one of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and fragment in e.name)
    if len(kernels) != calls * launches:
        print(f"  profiler: {len(kernels)} {fragment} events for {calls} calls "
              f"of {launches}", flush=True)
        return None
    spans = sorted(max(end for _, end in kernels[i:i + launches])
                   - kernels[i][0] for i in range(0, len(kernels), launches))
    return spans[len(spans) // 2] / 1e3


def wave_schedule_on_card(known: np.ndarray, waves, device: str = "cuda") -> dict:
    """One recorded wave schedule on the card again: its pool and index
    uploaded once, the outputs of K1 (``launch_waves``) against the plain
    version's over the same pool and indices, and its times."""
    from consensus_specs_tpu_torch.ops import sha256

    k = known.shape[0]
    lefts, rights, starts = sha256.wave_indices(k, waves)
    total = int(starts[-1])
    sizes = np.diff(starts).tolist()
    known_dev = torch.from_numpy(np.ascontiguousarray(known).view(np.int32)).to(device)
    pool = torch.empty((k + total, 8), dtype=torch.int32, device=device)
    pool[:k] = known_dev
    index = torch.from_numpy(
        np.concatenate([lefts, rights, starts]).astype(np.int32)).to(device)
    starts = starts.tolist()
    run = lambda: sha256.launch_waves(pool, index, starts)  # noqa: E731
    run()
    plain_fn = lambda: sha256.hash_waves_plain(  # noqa: E731
        known_dev, torch.from_numpy(lefts).to(device),
        torch.from_numpy(rights).to(device), starts)
    plain = plain_fn()
    torch.cuda.synchronize()
    for w, (b, e) in enumerate(zip(starts[:-1], starts[1:])):
        err = _word_err(pool[k + b:k + e], plain[b:e]) if e > b else 0
        if err:
            raise AssertionError(f"K1 != plain at wave {w} ({e - b} messages): "
                                 f"max |diff| {err}")
    launches = sha256.wave_launches(sizes)
    ms = cuda_ms(run)
    tail_max = sha256.TAIL_MAX_MESSAGES
    sha256.TAIL_MAX_MESSAGES = 0  # every wave a grid launch
    try:
        untailed_ms = cuda_ms(run)
    finally:
        sha256.TAIL_MAX_MESSAGES = tail_max
    return {"known": k, "messages": total, "waves": len(sizes), "sizes": sizes,
            "launches": launches, "ms": ms, "untailed_ms": untailed_ms,
            "plain_ms": cuda_ms(plain_fn, iters=3, warmup=1), "run": run}


def phase_ssz_hasher(spec, post, device: str = "cuda") -> dict:
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.ssz import hashing

    main_root = bytes(post.hash_tree_root())
    t0 = time.perf_counter()
    fresh = spec.BeaconState.decode_bytes(bytes(post.encode_bytes())).get_backing()
    print(f"fresh decode of the post-state: {time.perf_counter() - t0:.3f} s",
          flush=True)

    recorded_words, recorded_waves = [], []
    launch_k1, hash_waves_u32 = sha256._launch_k1, sha256.hash_waves_u32

    def recording_launch(words):
        recorded_words.append(words)
        return launch_k1(words)

    def recording_waves(known, waves, device):
        t0 = time.perf_counter()
        out = hash_waves_u32(known, waves, device)
        recorded_waves.append((known, waves, time.perf_counter() - t0))
        return out

    def timed_root(route: str, record: bool) -> dict:
        """``hash_tree_root`` of an unhashed copy of the fresh tree: under
        hashlib, or the ``"torch"`` backend's per-level or wave route, the
        kernels' counts zeroed just before it."""
        state = spec.BeaconState.view_from_backing(unhashed_copy(fresh))
        if route != "hashlib":
            hashing.set_backend("torch", device=device)
        if route == "per-level":
            hashing.register_wave_backend("torch", None)  # per level only
        if record:
            sha256._launch_k1 = recording_launch
            sha256.hash_waves_u32 = recording_waves
        sha256.reset_counts()
        try:
            with GcPauses() as pauses:
                t0 = time.perf_counter()
                root = bytes(state.hash_tree_root())
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            hashing.set_backend("hashlib")
            sha256._launch_k1, sha256.hash_waves_u32 = launch_k1, hash_waves_u32
        if root != main_root:
            raise AssertionError(f"the {route} root differs from the main path's")
        return {"seconds": seconds, "launches": sha256.counts["sha256_block64"],
                "gc": pauses}

    # in turns: per-level, wave, wave, per-level; the first of each recorded
    runs = [("hashlib", timed_root("hashlib", False)),
            ("per-level", timed_root("per-level", True)),
            ("wave", timed_root("wave", True)),
            ("wave", timed_root("wave", False)),
            ("per-level", timed_root("per-level", False))]
    print("hash_tree_root of the fresh post-state, wall, in turns: " + "; ".join(
        f"{route} {run['seconds']:.3f} s ({run['launches']} K1 launches, "
        f"{run['gc']})" for route, run in runs)
        + f"; root {main_root.hex()} for every route", flush=True)
    per_level, wave = runs[1][1], runs[2][1]
    if len(recorded_words) != per_level["launches"] or not recorded_words:
        raise AssertionError(f"the per-level route launched K1 "
                             f"{per_level['launches']} times, "
                             f"{len(recorded_words)} recorded")
    if not recorded_waves:
        raise AssertionError("the wave route never called the wave hasher")

    # the wave route, K1's path: each recorded schedule on the card again
    schedules = [wave_schedule_on_card(known, waves, device)
                 for known, waves, _ in recorded_waves]
    planned = sum(len(sc["launches"]) for sc in schedules)
    if wave["launches"] != planned:
        raise AssertionError(f"the wave route launched K1 {wave['launches']} "
                             f"times; its plan has {planned}")
    messages = sum(sc["messages"] for sc in schedules)
    known_rows = sum(sc["known"] for sc in schedules)
    for i, sc in enumerate(schedules):
        grid = [sc["sizes"][f] for f, e in sc["launches"]
                if sc["sizes"][f] > sha256.TAIL_MAX_MESSAGES]
        tails = [(e - f, sum(sc["sizes"][f:e])) for f, e in sc["launches"]
                 if sc["sizes"][f] <= sha256.TAIL_MAX_MESSAGES]
        print(f"wave schedule {i}: {sc['waves']} waves, {sc['messages']} "
              f"messages over {sc['known']} known digests; K1 launches "
              f"{len(sc['launches'])}: {len(grid)} grid waves (N = "
              f"{', '.join(map(str, grid))}) and {len(tails)} one-block tail(s) "
              f"({', '.join(f'{w} waves, {m} messages' for w, m in tails)}); "
              f"every wave == plain on the card; the wave hasher's call "
              f"(upload, launches, download) {recorded_waves[i][2]:.3f} s",
              flush=True)
    ms = sum(sc["ms"] for sc in schedules)
    untailed_ms = sum(sc["untailed_ms"] for sc in schedules)
    plain_ms = sum(sc["plain_ms"] for sc in schedules)
    ops_ms = messages * sha256.OPS_PER_MESSAGE / PEAK_INT32_OPS_PER_S * 1e3
    # each input read once (the known digests, two indices a message), each
    # output written once (a digest a message)
    bytes_ms = (32 * known_rows + 40 * messages) / PEAK_BYTES_PER_S * 1e3
    bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                       else (bytes_ms, "bytes"))
    kernel_ms = None
    if profiler_sees_device():
        spans = [retried(lambda sc=sc: profiled_schedule_ms(
            sc["run"], "sha256_", len(sc["launches"]))) for sc in schedules]
        if None not in spans:
            kernel_ms = sum(spans)

    # the per-level route's K1 launches, each input against the plain
    # version, and the sum of the times of one call at each shape
    max_err, route_ms, route_plain_ms = 0, 0.0, 0.0
    for words in recorded_words:
        err = _word_err(sha256.sha256_block64(words), _plain_on(words))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"K1 != plain at the per-level route's N="
                                 f"{words.shape[0]}: max |diff| {err}")
        route_ms += cuda_ms(lambda w=words: sha256.sha256_block64(w))
        route_plain_ms += cuda_ms(lambda w=words: _plain_on(w), iters=3, warmup=1)
    route_messages = sum(w.shape[0] for w in recorded_words)
    kernel_text = ("not measured (no device time in the profiler, or a "
                   "kernel missing)" if kernel_ms is None else f"{kernel_ms:.5f} ms")
    print(f"K1 on the wave route ({messages} messages, {wave['launches']} "
          f"launches): events {ms:.5f} ms over the whole schedule, kernel only "
          f"(torch.profiler, first kernel's start to last one's end) "
          f"{kernel_text}; with no tail (every wave a grid launch) "
          f"{untailed_ms:.5f} ms; plain {plain_ms:.3f} ms; bound {bound:.5f} ms "
          f"({bound_by}; operations {ops_ms:.5f}, bytes {bytes_ms:.5f}). "
          f"Per-level route: K1 == plain at its {len(recorded_words)} launch "
          f"shapes (N = {', '.join(str(w.shape[0]) for w in recorded_words)}; "
          f"{route_messages} messages), K1 {route_ms:.5f} ms summed over the "
          f"launches, plain {route_plain_ms:.3f} ms", flush=True)
    print(f"wave schedule against the per-level route's K1 launches: "
          f"{ms:.5f} / {route_ms:.5f} ms = {ms / route_ms:.3f}", flush=True)
    return {"launches": wave["launches"], "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "kernel_ms": kernel_ms, "untailed_ms": untailed_ms,
            "per_level_route_ms": route_ms,
            "per_level_route_launches": per_level["launches"],
            "wall_s": {route: [r["seconds"] for n, r in runs if n == route]
                       for route in ("hashlib", "per-level", "wave")}}


# -- phase 5 ----------------------------------------------------------------


def phase_lineage(fork: str, n_validators: int) -> dict:
    """The main path of an altair-lineage fork, literally: the epoch on a
    CUDA-built spec (it launches neither kernel), the boundary block
    replayed on a ``device="cpu"`` spec with the same root."""
    from consensus_specs_tpu_torch import scenario
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec(fork, "mainnet", device="cuda")
    t0 = time.perf_counter()
    state = scenario.build_main_path_state(spec, n_validators)
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = scenario.build_epoch_blocks(spec, state, with_sync=True)
    t_blocks = time.perf_counter() - t0
    n_atts = sum(len(b.message.body.attestations) for b in blocks)
    seats = [sum(b.message.body.sync_aggregate.sync_committee_bits) for b in blocks]
    print(f"set-up: {fork} state with sync committees {t_state:.3f} s, "
          f"{len(blocks)} signed blocks with {n_atts} aggregate attestations "
          f"and {len(blocks)} sync aggregates {t_blocks:.3f} s", flush=True)
    if len(blocks) != int(spec.SLOTS_PER_EPOCH):
        raise AssertionError("expected one epoch of blocks")
    if set(seats) != {int(spec.SYNC_COMMITTEE_SIZE)}:
        raise AssertionError(f"sync aggregates not fully set: {sorted(set(seats))}")
    if hasattr(state, "latest_execution_payload_header"):
        payload_numbers(spec, state, blocks)

    bls.bls_active = True
    post = state.copy()
    pre_last = None
    sha256.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, signed in enumerate(blocks):
        if i == len(blocks) - 1:
            pre_last = post.copy()
            t_last = time.perf_counter()
        spec.state_transition(post, signed, True)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t_path = t_end - t0
    k2_launches = sha256.counts["u64_list_root"]
    k1_launches = sha256.counts["sha256_block64"]
    root = bytes(post.hash_tree_root())
    print(f"{fork} literal path: {len(blocks)} blocks in {t_path:.3f} s (last "
          f"block, with the epoch transition: {t_end - t_last:.3f} s); K2 "
          f"launches {k2_launches}, K1 launches {k1_launches}; root "
          f"{root.hex()}", flush=True)
    if k2_launches or k1_launches:
        raise AssertionError(f"the literal {fork} path launched K2 {k2_launches} "
                             f"and K1 {k1_launches} times, not 0")

    cpu_spec = get_spec(fork, "mainnet", device="cpu")
    cpu_state = cpu_leg_state(cpu_spec, pre_last)
    cpu_block = cpu_spec.SignedBeaconBlock.decode_bytes(
        bytes(blocks[-1].encode_bytes()))
    t0 = time.perf_counter()
    cpu_spec.state_transition(cpu_state, cpu_block, True)
    t_cpu = time.perf_counter() - t0
    cpu_root = bytes(cpu_state.hash_tree_root())
    print(f"{fork} cpu leg: boundary block in {t_cpu:.3f} s; root "
          f"{cpu_root.hex()}", flush=True)
    if cpu_root != root:
        raise AssertionError(f"{fork} cuda and cpu post-state roots differ")
    return {"spec": spec, "pre": state, "blocks": blocks, "post": post,
            "root": root, "seconds": t_path, "k2_launches": k2_launches}


def payload_numbers(spec, state, blocks) -> None:
    """Print the execution payloads' sizes and check that they chain: a
    state past the merge, each payload's parent the one before it."""
    if not spec.is_merge_transition_complete(state):
        raise AssertionError("the main path's state is not past the merge")
    parent = state.latest_execution_payload_header.block_hash
    txs, sizes = [], []
    for signed in blocks:
        payload = signed.message.body.execution_payload
        if payload.parent_hash != parent:
            raise AssertionError("the execution payloads do not chain")
        parent = payload.block_hash
        txs.append(len(payload.transactions))
        sizes.append(sum(len(tx) for tx in payload.transactions))
    print(f"execution payloads: {len(blocks)}, {min(txs)}-{max(txs)} "
          f"transactions each, {min(sizes)}-{max(sizes)} transaction bytes "
          f"(mean {np.mean(sizes):.0f}); block numbers "
          f"{int(blocks[0].message.body.execution_payload.block_number)}-"
          f"{int(blocks[-1].message.body.execution_payload.block_number)}",
          flush=True)


# -- phase 5b ---------------------------------------------------------------

ALTAIR_ENGINE_PHASES = ENGINE_PHASES + ("sync_apply_s", "mirror_flush_s")


def resident_root_split(spec, state) -> dict:
    """One resident root of a balances list that a block's sync rewards
    left partly dirty (one write to each committee member's balance and
    the proposer's, as a block makes them), split into the balance walk,
    the upload and K2, beside the host's incremental root of the same
    list and its full root from a fresh bulk write."""
    from consensus_specs_tpu_torch.ops import merkle_resident
    from consensus_specs_tpu_torch.ssz import bulk
    from consensus_specs_tpu_torch.stf import attestations, sync

    state.balances.hash_tree_root()
    touched = sorted({int(r) for r in sync.sync_committee_rows(spec, state)}
                     | {int(attestations.beacon_proposer_index(spec, state))})
    # the same writes on two copies: each gets its own dirty path nodes
    st, host = state.copy(), state.copy()
    for view in (st.balances, host.balances):
        for i in touched:
            view[i] = spec.Gwei(int(view[i]) + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = bulk.packed_uint64_to_numpy(st.balances)
    t1 = time.perf_counter()
    resident = merkle_resident.ResidentPackedU64List(
        type(st.balances).LENGTH, device="cuda")
    resident.upload(col)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    contents_root = resident.contents_subtree_root()
    t3 = time.perf_counter()
    merkle_resident.memoize_packed_u64_contents_root(st.balances, contents_root)
    t4 = time.perf_counter()
    host_root = bytes(host.balances.hash_tree_root())
    t5 = time.perf_counter()
    if bytes(st.balances.hash_tree_root()) != host_root:
        raise AssertionError("the resident balances root differs from the host's")
    full = st.copy()
    bulk.set_packed_uint64_from_numpy(full.balances, col)
    t6 = time.perf_counter()
    full_root = bytes(full.balances.hash_tree_root())
    t7 = time.perf_counter()
    if full_root != host_root:
        raise AssertionError("the full host balances root differs")
    split = {"walk_s": t1 - t0, "upload_s": t2 - t1, "k2_s": t3 - t2,
             "host_incremental_s": t5 - t4, "host_full_s": t7 - t6,
             "writes": len(touched)}
    print(f"one resident root after {len(touched)} balance writes: walk "
          f"{split['walk_s']:.4f} s, upload {split['upload_s']:.4f} s, K2 "
          f"(with its readback) {split['k2_s']:.4f} s; the host's incremental "
          f"root of the same list {split['host_incremental_s']:.4f} s, its full "
          f"root after a bulk write {split['host_full_s']:.4f} s", flush=True)
    return split


def flag_deltas_on_off(spec, post) -> dict:
    """The epoch's flag rewards and penalties (``rewards_and_penalties`` on
    the epoch's post-state, whose previous epoch holds the blocks'
    participation) with ``DEVICE_COLUMNS`` off (the host loop) and on
    (torch on the card): equal balances."""
    from consensus_specs_tpu_torch.ops import epoch_altair
    from consensus_specs_tpu_torch.ssz import bulk

    times = {}
    balances = {}
    for on in (False, True, True, False, False, True):
        st = post.copy()
        epoch_altair.DEVICE_COLUMNS = on
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch_altair.rewards_and_penalties(spec, st)
            torch.cuda.synchronize()
            times.setdefault(on, []).append(time.perf_counter() - t0)
        finally:
            epoch_altair.DEVICE_COLUMNS = False
        balances[on] = bulk.packed_uint64_to_numpy(st.balances)
    if not np.array_equal(balances[False], balances[True]):
        raise AssertionError("flag deltas on the card and on the host differ")
    if np.array_equal(balances[False], bulk.packed_uint64_to_numpy(post.balances)):
        raise AssertionError("the flag deltas changed no balance")
    print(f"epoch flag deltas (rewards_and_penalties, in turns): "
          f"DEVICE_COLUMNS off "
          + " / ".join(f"{t:.4f}" for t in times[False]) + " s, on "
          + " / ".join(f"{t:.4f}" for t in times[True])
          + " s (its first call uploads the columns); equal balances",
          flush=True)
    return {"host_s": times[False], "device_s": times[True]}


def phase_altair_engine(altair: dict) -> dict:
    run = run_engine("altair engine", altair["spec"], altair["pre"].copy(),
                     altair["blocks"], altair, ALTAIR_ENGINE_PHASES)
    # each block's sync rewards leave the balances subtree unhashed at its
    # state-root check; altair has no fused epoch update
    if run["resident"] < 1 or run["fused"] != 0:
        raise AssertionError(f"the altair engine took {run['resident']} "
                             f"resident slot roots and {run['fused']} fused "
                             "epoch updates")
    run["split"] = resident_root_split(altair["spec"], altair["pre"])
    run["flags"] = flag_deltas_on_off(altair["spec"], altair["post"])
    return run


# -- phase 6b ---------------------------------------------------------------

# of other_s: the payload step, bellatrix's literal process_execution_payload
BELLATRIX_ENGINE_PHASES = ALTAIR_ENGINE_PHASES + ("execution_payload_s",)


def phase_bellatrix_engine(bellatrix: dict) -> dict:
    run = run_engine("bellatrix engine", bellatrix["spec"],
                     bellatrix["pre"].copy(), bellatrix["blocks"], bellatrix,
                     BELLATRIX_ENGINE_PHASES)
    n_blocks = len(bellatrix["blocks"])
    print(f"bellatrix engine: the payload step (execution_payload_s, inside "
          f"other_s) {run['execution_payload_s']:.3f} s for {n_blocks} "
          f"payloads", flush=True)
    # as on altair: each block's sync rewards leave the balances subtree
    # unhashed at its state-root check, so each check takes a resident root
    if (run["resident"] != n_blocks or run["fused"] != 0
            or run["sync"] != n_blocks or run["execution_payload_s"] <= 0):
        raise AssertionError(
            f"the bellatrix engine took {run['resident']} resident slot roots, "
            f"{run['fused']} fused epoch updates and {run['sync']} sync "
            f"aggregates for {n_blocks} blocks")
    return run


# -- phase 6c ---------------------------------------------------------------


def phase_capella() -> dict:
    """A minimal-preset capella epoch (``scenario.capella_withdrawal_epoch``:
    one full withdrawal, one BLS-to-execution change) on a CUDA-built spec,
    held against a CPU-built spec's root after every block; then through
    the engine on the card, which replays every capella block literally."""
    from consensus_specs_tpu_torch import scenario, stf
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec("capella", "minimal", device="cuda")
    cpu_spec = get_spec("capella", "minimal", device="cpu")
    pre, blocks = scenario.capella_withdrawal_epoch(spec, 64)
    bls.bls_active = True
    state = pre.copy()
    cpu_state = cpu_spec.BeaconState.decode_bytes(bytes(pre.encode_bytes()))
    t0 = time.perf_counter()
    for i, signed in enumerate(blocks):
        spec.state_transition(state, signed, True)
        cpu_spec.state_transition(cpu_state, cpu_spec.SignedBeaconBlock.decode_bytes(
            bytes(signed.encode_bytes())), True)
        if bytes(state.hash_tree_root()) != bytes(cpu_state.hash_tree_root()):
            raise AssertionError(f"capella cuda and cpu roots differ at block {i}")
    seconds = time.perf_counter() - t0
    withdrawals = sum(len(b.message.body.execution_payload.withdrawals)
                      for b in blocks)
    changes = sum(len(b.message.body.bls_to_execution_changes) for b in blocks)
    if (withdrawals, changes, int(state.withdrawal_index)) != (1, 1, 1):
        raise AssertionError(f"capella walk: {withdrawals} withdrawals, "
                             f"{changes} changes")
    stf.reset_stats()
    engine_state = pre.copy()
    stf.apply_signed_blocks(spec, engine_state, blocks, True)
    root = bytes(state.hash_tree_root())
    print(f"capella (minimal, {len(blocks)} blocks, {withdrawals} full "
          f"withdrawal, {changes} BLS-to-execution change): cuda and cpu "
          f"specs equal after every block ({seconds:.3f} s for both); engine "
          f"replayed {stf.stats['replayed_blocks']} "
          f"{stf.stats['replay_reasons']}; root {root.hex()}", flush=True)
    if (bytes(engine_state.hash_tree_root()) != root
            or stf.stats["fast_blocks"] != 0
            or stf.stats["replay_reasons"] != {"FastPathViolation": len(blocks)}):
        raise AssertionError(f"the capella engine run: {stf.stats}")
    return {"root": root}


# -- phase 7a ---------------------------------------------------------------


def _spec_modules(device_tag: str) -> set:
    """Names of the built spec modules of one device."""
    prefix = "consensus_specs_tpu_torch.specs."
    return {m for m in sys.modules
            if m.startswith(prefix) and f"_{device_tag}" in m[len(prefix):]}


def phase_spec_cases(device: str = "cuda") -> dict:
    """The tier-1 subset of the reference's spec cases on specs built for
    ``device``, through the port's loader.  A case that fails raises with
    its name; one that skips fails the phase too."""
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.testing import context, reference_cases
    from consensus_specs_tpu_torch.testing.exceptions import SkippedTest

    selected = reference_cases.tier1_cases()
    cpu_specs = _spec_modules("cpu")
    tallies = {}
    # outside pytest a case's skip raises SkippedTest
    is_pytest, context.is_pytest = context.is_pytest, False
    sha256.reset_counts()
    t0 = time.perf_counter()
    try:
        with reference_cases.configured(device):
            for relpath, name in selected:
                tally = tallies.setdefault(relpath.split("/")[0],
                                           {"passed": 0, "skipped": 0})
                try:
                    reference_cases.cases(relpath)[name]()
                except SkippedTest:
                    tally["skipped"] += 1
                    continue
                except BaseException:
                    print(f"spec case failed: {relpath}::{name}", flush=True)
                    raise
                tally["passed"] += 1
            if device != "cpu":
                torch.cuda.synchronize()
    finally:
        context.is_pytest = is_pytest
    seconds = time.perf_counter() - t0
    launches = dict(sha256.counts)
    passed = sum(t["passed"] for t in tallies.values())
    print(f"spec cases on {device}-built specs: {len(selected)} cases in "
          f"{seconds:.3f} s; "
          + ", ".join(f"{fork} {t['passed']} passed, {t['skipped']} skipped"
                      for fork, t in tallies.items())
          + f"; K2 launches {launches['u64_list_root']}, K1 launches "
          f"{launches['sha256_block64']}", flush=True)
    if passed != len(selected):
        raise AssertionError(f"{len(selected) - passed} of {len(selected)} "
                             "spec cases did not run")
    new_cpu = _spec_modules("cpu") - cpu_specs
    if device != "cpu" and new_cpu:
        raise AssertionError(f"the cases built CPU specs: {sorted(new_cpu)}")
    return {"cases": len(selected), "passed": passed, "seconds": seconds,
            "k2_launches": launches["u64_list_root"],
            "k1_launches": launches["sha256_block64"]}


# -- phase 7b ---------------------------------------------------------------

OVERRIDE_FORKS = ("phase0", "altair", "bellatrix")
# the churn quotient lets 400,000 // 4,096 = 97 validators in an epoch,
# where the default's 65,536 lets in max(4, 6) = 6
CONFIG_OVERRIDE = {"CHURN_LIMIT_QUOTIENT": 4096}
ACTIVATION_QUEUE = 1024
FAR_FUTURE = 2**64 - 1


def override_pre_state(spec, n_validators: int, queue: int, seed: int):
    """The main path's pre-state with ``queue`` validators appended, with
    pubkeys drawn from ``seed``, each eligible for activation since epoch
    0, which the state has finalized."""
    from consensus_specs_tpu_torch import scenario

    state = scenario.build_main_path_state(spec, n_validators)
    keys = np.random.default_rng(seed).integers(0, 256, (queue, 48), dtype=np.uint8)
    lineage = hasattr(state, "inactivity_scores")
    for key in keys:
        state.validators.append(spec.Validator(
            pubkey=key.tobytes(),
            effective_balance=spec.MAX_EFFECTIVE_BALANCE,
            activation_eligibility_epoch=0,
            activation_epoch=FAR_FUTURE,
            exit_epoch=FAR_FUTURE,
            withdrawable_epoch=FAR_FUTURE))
        state.balances.append(spec.MAX_EFFECTIVE_BALANCE)
        if lineage:
            state.previous_epoch_participation.append(0)
            state.current_epoch_participation.append(0)
            state.inactivity_scores.append(0)
    return state


def phase_config_override(fork: str, n_validators: int, seed: int,
                          device: str = "cuda") -> dict:
    """``process_slots`` across an epoch boundary on a spec built with
    ``CONFIG_OVERRIDE`` for ``device`` and for the CPU, and on the default
    spec for ``device``, from one pre-state taken by its backing tree.
    The device's override root must equal the CPU's and differ from the
    default's; on phase0 at 16,384 validators and up the card's fused
    epoch update runs once and launches K2 a root's passes."""
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.specs.builder import build_spec

    default = get_spec(fork, "mainnet", device=device)
    config = default.config.replace(**{
        k: type(getattr(default.config, k))(v) for k, v in CONFIG_OVERRIDE.items()})
    t0 = time.perf_counter()
    spec = build_spec(fork, "mainnet", device, config=config)
    cpu_spec = build_spec(fork, "mainnet", "cpu", config=config)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = override_pre_state(spec, n_validators, ACTIVATION_QUEUE, seed)
    pre.hash_tree_root()  # once, on the host; the three runs share it
    t_state = time.perf_counter() - t0
    target = (int(pre.slot) // int(spec.SLOTS_PER_EPOCH) + 1) * int(spec.SLOTS_PER_EPOCH)

    def run(s, label):
        state = s.BeaconState.view_from_backing(pre.get_backing())
        merkle_resident.stats["fused_epoch_updates"] = 0
        sha256.reset_counts()
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.process_slots(state, target)
        if device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        root = bytes(state.hash_tree_root())
        activated = sum(int(state.validators[i].activation_epoch) != FAR_FUTURE
                        for i in range(n_validators, len(state.validators)))
        out = {"root": root, "seconds": seconds, "activated": activated,
               "fused": merkle_resident.stats["fused_epoch_updates"],
               "k2": sha256.counts["u64_list_root"],
               "k1": sha256.counts["sha256_block64"]}
        print(f"{fork} {label}: {target - int(pre.slot)} slots across the "
              f"epoch boundary in {seconds:.3f} s; {activated} of "
              f"{ACTIVATION_QUEUE} queued validators activated; fused epoch "
              f"updates {out['fused']}, K2 launches {out['k2']}, K1 launches "
              f"{out['k1']}; root {root.hex()}", flush=True)
        return out

    print(f"{fork} config override {CONFIG_OVERRIDE}: specs built in "
          f"{t_build:.3f} s, pre-state of {len(pre.validators)} validators "
          f"in {t_state:.3f} s", flush=True)
    override = run(spec, f"override on {device}")
    on_cpu = run(cpu_spec, "override on cpu")
    plain = run(default, f"default config on {device}")
    if override["root"] != on_cpu["root"]:
        raise AssertionError(f"{fork}: the override's {device} and cpu roots differ")
    if override["root"] == plain["root"] or override["activated"] <= plain["activated"]:
        raise AssertionError(f"{fork}: the override changed nothing")
    if override["k1"]:
        raise AssertionError(f"{fork}: the override epoch launched K1")
    if device != "cpu":
        n_chunks = 1 << ((len(pre.balances) + 3) // 4 - 1).bit_length()
        want = (1, sha256.k2_plan(n_chunks)[0]) if fork == "phase0" else (0, 0)
        if (override["fused"], override["k2"]) != want:
            raise AssertionError(
                f"{fork}: {override['fused']} fused epoch updates and "
                f"{override['k2']} K2 launches, not {want}")
    return {"k2_launches": override["k2"], "seconds": override["seconds"],
            "cpu_seconds": on_cpu["seconds"], "activated": override["activated"]}


# -- phase 8a ---------------------------------------------------------------

# Hopper's integer multiply-add rate: 64 lanes a clock on each SM, half
# the float32 FMA rate (CUDA C programming guide, compute capability 9.0)
IMAD_LANES_PER_SM_CLOCK = 64
H100_SMS = 132
PEAK_IMAD_PER_S = IMAD_LANES_PER_SM_CLOCK * H100_SMS * SM_CLOCK_HZ
# K3 at this many products; K4 and K5 held against their plain versions
# at the batches of 8c's padded check (2), config 2 (32) and config 3 (64),
# each pair count and run length, and timed at each batch at config 3's K
# and n (the kernels line takes config 3's batch)
K3_PRODUCTS = 1 << 20
MILLER_BATCHES = (2, 32, 64)
MILLER_PAIRS = (1, 2)
MILLER_STEPS = (1, 32)
MILLER_B, MILLER_K, MILLER_N = 64, 2, 32
MILLER_N_HOST = 2


def multiplies(opcodes) -> int:
    """The integer multiplies among SASS opcodes: IMAD and IMUL in all
    their forms but those the compiler uses as a move, a shift or an add
    (``IMAD.MOV``, ``IMAD.SHL``, ``IMAD.IADD``) or as an add's carry
    (``IMAD.X``)."""
    n = 0
    for op, count in opcodes.items():
        parts = op.split(".")
        if parts[0] in ("IMAD", "IMUL") and not set(parts[1:]) & {
                "MOV", "SHL", "IADD", "X"}:
            n += count
    return n


def _residues(rng, shape) -> np.ndarray:
    """Random Fq residues below p as canonical limbs (limb 14 below p's,
    limb 15 zero), [*shape, 16] int64."""
    from consensus_specs_tpu_torch.ops.bls import limbs

    out = rng.integers(0, 1 << limbs.LIMB_BITS, tuple(shape) + (limbs.N_LIMBS,))
    out[..., 14] = rng.integers(0, int(limbs.P_LIMBS[14]), tuple(shape))
    out[..., 15] = 0
    return out


def lazy_operands(n: int, seed: int) -> torch.Tensor:
    """n Fq operands at the edge of K3's envelope, made on the card from
    ``seed``: signed sums of up to 8 reduced residues (limbs |a_i| < 2^29,
    values |a| < 8p), with 0, p, 36p and -36p in the first rows."""
    from consensus_specs_tpu_torch.ops.bls import limbs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    acc = torch.zeros((n, limbs.N_LIMBS), dtype=torch.int64, device="cuda")
    top = int(limbs.P_LIMBS[14])
    for _ in range(8):
        # residues below p: limb 14 below p's, limb 15 zero
        r = torch.randint(0, 1 << limbs.LIMB_BITS, (n, limbs.N_LIMBS),
                          generator=gen, device="cuda")
        r[:, 14] = torch.randint(0, top, (n,), generator=gen, device="cuda")
        r[:, 15] = 0
        acc += torch.randint(-1, 2, (n, 1), generator=gen, device="cuda") * r
    edges = np.stack([limbs.int_to_limbs(x) for x in
                      (0, limbs.P_INT, 36 * limbs.P_INT)])
    acc[:3] = torch.from_numpy(edges)
    acc[3] = -torch.from_numpy(edges[2])
    return acc


def below(a: torch.Tensor, bound_limbs: np.ndarray) -> torch.Tensor:
    """Canonical digits a < the canonical digits of a bound, per row."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        lt |= eq & (a[..., i] < int(bound_limbs[i]))
        eq &= a[..., i] == int(bound_limbs[i])
    return lt


def _canonical_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """max |canonical(got) - canonical(want)| over every limb; also
    raises unless the limbs are equal bit for bit (the kernels compute the
    plain versions' values)."""
    from consensus_specs_tpu_torch.ops.bls import limbs

    err = int((limbs.canonical(got) - limbs.canonical(want)).abs().max())
    if err == 0 and not torch.equal(got, want):
        raise AssertionError("canonically equal but not the same limbs")
    return err


def kernel_only_ms(fn, fragment: str, calls: int, sees_device: bool):
    """``torch.profiler`` device ms a call of the kernels named by
    ``fragment``, or None where the profiler sees no device time or, three
    times over, not these kernels (late in a long run it has missed a
    kernel it records in a short one; the CUDA-event time stands)."""
    if not sees_device:
        return None
    got = retried(lambda: kernel_ms_of(profiled_kernel_ms(fn, calls), fragment))
    if got is None:
        print(f"  profiler: {fragment} not recorded in three tries", flush=True)
        return None
    return got[0]


def phase_bls_kernels(seed: int) -> dict:
    """8a: K3 at 2^20 operand pairs at the edge of its envelope, K4 and K5
    from random residues at ``MILLER_BATCHES`` x ``MILLER_PAIRS`` x
    ``MILLER_STEPS``, each against its plain version on the same inputs:
    canonical values equal (and the limbs, bit for bit), K3's output
    contract held, times and bounds (K4 and K5's at each batch, the
    kernels line's at config 3's)."""
    from consensus_specs_tpu_torch.ops.bls import limbs, pairing

    out = {}
    # -- K3
    a = lazy_operands(K3_PRODUCTS, seed)
    b = lazy_operands(K3_PRODUCTS, seed + 1)
    got = limbs.mul(a, b)
    want = limbs.mul_plain(a, b)
    torch.cuda.synchronize()
    err = _canonical_err(got, want)
    if err:
        raise AssertionError(f"K3 != plain: max canonical |diff| {err}")
    digits_ok = bool(((got >= 0) & (got <= limbs.MASK)).all())
    below_3p = bool(below(got, limbs.int_to_limbs(3 * limbs.P_INT)).all())
    if not (digits_ok and below_3p):
        raise AssertionError(f"K3's output contract: digits in range "
                             f"{digits_ok}, values below 3p {below_3p}")
    # asked up to three times: late in a long run the profiler has missed
    # the probe's kernel once where it saw K2's earlier in the same process
    sees_device = any(profiler_sees_device() for _ in range(3))
    k3_ms = cuda_ms(lambda: limbs.mul(a, b), iters=20)
    k3_kernel = kernel_only_ms(lambda: limbs.mul(a, b), "fq_mul_kernel", 10,
                               sees_device)
    plain_ms = cuda_ms(lambda: limbs.mul_plain(a, b), iters=3, warmup=1)
    kernels = sass_kernels(limbs.build_kernel())
    names = [k for k in (kernels or {}) if "fq_mul_kernel" in k]
    if kernels is not None and not names:
        raise AssertionError("cuobjdump shows no fq_mul_kernel (K3)")
    per_product = product_multiplies()
    if names:
        ops = kernels[names[0]][0]
        print(f"SASS K3 ({sum(ops.values())} instructions, static; the "
              f"kernel is straight-line): {multiplies(ops)} multiplies a "
              f"product, where the product needs {per_product} (the bounds "
              f"count these); by pipe {by_pipe(ops)}; opcodes: "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)),
              flush=True)
    out["k3"] = _kernel_numbers(
        "K3", K3_PRODUCTS * limbs.BYTES_PER_PRODUCT, K3_PRODUCTS, per_product,
        err, k3_ms, k3_kernel, plain_ms)
    print(f"K3 == plain at N=2^20 (canonical and limb for limb; digits in "
          f"[0, 2^26), values below 3p): {out['k3']['line']}", flush=True)

    # -- K4 and K5, one block an item: limb for limb against the plain
    # versions on the card at each batch, pair count and run length, timed
    # at each batch at config 3's K and n
    rng = np.random.default_rng(seed + 2)
    n = MILLER_N

    def res(*shape):
        return torch.from_numpy(_residues(rng, shape))

    runs, err4, err5, checked = {}, 0, 0, 0
    for B in MILLER_BATCHES:
        for K in MILLER_PAIRS:
            dev = [t.cuda() for t in (res(B, 6, 2), res(K, B, 2), res(K, B, 2),
                                      res(K, B, 2), res(K, B), res(K, B))]
            for steps in MILLER_STEPS:
                got = pairing._dbl_run(*dev, steps)
                want = pairing._dbl_run_plain(*dev, steps)
                err4 = max(err4, max(_canonical_err(g, w)
                                     for g, w in zip(got, want)))
                checked += 1
            if K == MILLER_K:
                runs[B] = dev
        for steps in MILLER_STEPS:
            err5 = max(err5, _canonical_err(
                pairing._sq_run(runs[B][0], steps),
                pairing._sq_run_plain(runs[B][0], steps)))
    # all-torch anchors on the host (K4's at MILLER_N_HOST steps: its plain
    # version costs seconds a step there)
    B = MILLER_B
    dev = runs[B]
    host = [t.cpu() for t in dev]
    short4 = pairing._dbl_run(*dev, MILLER_N_HOST)
    on_host4 = pairing._dbl_run_plain(*host, MILLER_N_HOST)
    on_host5 = pairing._sq_run_plain(host[0], n)
    err4 = max(err4, max(_canonical_err(g, w.cuda())
                         for g, w in zip(short4, on_host4)))
    err5 = max(err5, _canonical_err(pairing._sq_run(dev[0], n), on_host5.cuda()))
    torch.cuda.synchronize()
    if err4 or err5:
        raise AssertionError(f"K4 / K5 != plain: max canonical |diff| "
                             f"{err4} / {err5}")
    print(f"K4 == plain at B in {MILLER_BATCHES}, K in {MILLER_PAIRS}, n in "
          f"{MILLER_STEPS} ({checked} runs), K5 == plain at each B and n "
          f"(canonical and limb for limb; the plain versions on the card, "
          f"whose products are K3 launches, and on the host, all torch, at "
          f"B={B}, K4's there at n={MILLER_N_HOST})", flush=True)
    for B in MILLER_BATCHES:
        dev = runs[B]
        k4 = lambda: pairing._dbl_run(*dev, n)  # noqa: E731
        k5 = lambda: pairing._sq_run(dev[0], n)  # noqa: E731
        k4_ms, k5_ms = cuda_ms(k4), cuda_ms(k5)
        k4_kernel = kernel_only_ms(k4, "miller_dbl_run_kernel", 10, sees_device)
        k5_kernel = kernel_only_ms(k5, "fq12_sq_run_kernel", 10, sees_device)
        if B == MILLER_B:
            plain4_ms = cuda_ms(lambda: pairing._dbl_run_plain(*dev, n),
                                iters=1, warmup=1)
            plain5_ms = cuda_ms(lambda: pairing._sq_run_plain(dev[0], n),
                                iters=1, warmup=1)
        else:
            plain4_ms = plain5_ms = None
        products4 = B * n * (pairing.PRODUCTS_FQ12_SQUARE
                             + MILLER_K * pairing.PRODUCTS_DBL_STEP_PER_PAIR)
        products5 = B * n * pairing.PRODUCTS_FQ12_SQUARE
        bytes4 = 8 * (2 * sum(t.numel() for t in dev[:4]) + dev[4].numel()
                      + dev[5].numel())
        bytes5 = 8 * 2 * dev[0].numel()
        k4_numbers = _kernel_numbers("K4", bytes4, products4, per_product, err4,
                                     k4_ms, k4_kernel, plain4_ms)
        k5_numbers = _kernel_numbers("K5", bytes5, products5, per_product, err5,
                                     k5_ms, k5_kernel, plain5_ms)
        sms = f"{min(B, H100_SMS)} of {H100_SMS} SMs hold a block"
        print(f"K4 at B={B}, K={MILLER_K}, n={n} ({products4} products; "
              f"{sms}): {k4_numbers['line']}", flush=True)
        print(f"K5 at B={B}, n={n} ({products5} products; {sms}): "
              f"{k5_numbers['line']}", flush=True)
        if B == MILLER_B:
            out["k4"], out["k5"] = k4_numbers, k5_numbers
    return out


def product_multiplies() -> int:
    """The integer multiplies one Montgomery product of 16-limb operands
    needs: the schoolbook a*b (16 x 16), the 16 REDC quotients, and each
    quotient times p's nonzero limbs (16 x 15).  Each is one 26 x 26-bit
    multiply into a 64-bit sum; K3's signed-word body issues about twice
    as many (its SASS, printed in 8a), most of them sign corrections."""
    from consensus_specs_tpu_torch.ops.bls import limbs

    n = limbs.N_LIMBS
    return n * n + n + n * int(np.count_nonzero(limbs.P_LIMBS))


def _kernel_numbers(label, n_bytes, products, per_product, err, ms,
                    kernel_ms, plain_ms) -> dict:
    """A kernel's numbers for the kernels line, and their printed form:
    the bound is the larger of its bytes at the HBM rate and its
    multiplies (products x the multiplies a product needs, each one issue)
    at the integer multiply-add rate."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = products * per_product / PEAK_IMAD_PER_S * 1e3
    if ops_ms >= bytes_ms:
        bound, by = ops_ms, "operations"
    else:
        bound, by = bytes_ms, "bytes"
    kernel_text = ("not measured (the profiler recorded no time for it)"
                   if kernel_ms is None else f"{kernel_ms:.5f} ms")
    plain_text = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    line = (f"{label} {ms:.5f} ms (CUDA events), kernel only {kernel_text}; "
            f"plain {plain_text}; bound {bound:.5f} ms ({by}; bytes "
            f"{bytes_ms:.5f}, multiplies {ops_ms:.5f})")
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "line": line}


# -- phase 8b ---------------------------------------------------------------

# the reference bench's BASELINE configs 2 and 3 (bench.py, bench_bls_batches)
BLS_MESSAGE = b"\x42" * 32
BLS_CONFIGS = (("config 2: sync aggregate", 512, 32),
               ("config 3: attestations", 128, 64))
MIXED_BATCH = 64


def _bls_counts() -> dict:
    from consensus_specs_tpu_torch.ops.bls import limbs, pairing

    return {"K3": limbs.counts["fq_mul"],
            "K4": pairing.counts["miller_dbl_run"],
            "K5": pairing.counts["fq12_sq_run"]}


def _reset_bls_counts() -> None:
    from consensus_specs_tpu_torch.ops.bls import limbs, pairing

    limbs.reset_counts()
    pairing.reset_counts()


def device_batch(pubkeys_lists, messages, signatures) -> dict:
    """One ``batch_fast_aggregate_verify`` pass on the card, with the
    launches it made (counts zeroed just before it) and K3's launch shapes,
    beside its host marshalling timed alone and, where the call's items
    make a power-of-two batch (so that the call padded none), its device
    pairing check timed alone on them."""
    from consensus_specs_tpu_torch.ops import bls as device_bls
    from consensus_specs_tpu_torch.ops.bls import limbs

    _reset_bls_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, todo = device_bls.marshal_fast_aggregate_items(
        pubkeys_lists, messages, signatures)
    t1 = time.perf_counter()
    verdicts = device_bls.batch_fast_aggregate_verify(
        pubkeys_lists, messages, signatures)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run = {"verdicts": verdicts, "marshal_s": t1 - t0, "call_s": t2 - t1,
           "launches": _bls_counts(),
           "shapes": dict(sorted(limbs.launch_shapes.items())),
           "todo": len(todo), "pairing_s": None}
    pairs = [item for _, item in todo]
    if len(pairs) >= 2 and len(pairs) & (len(pairs) - 1) == 0:
        t0 = time.perf_counter()
        device_bls._check_pairs_batch(pairs, device_bls.pairing_device())
        torch.cuda.synchronize()
        run["pairing_s"] = time.perf_counter() - t0
    return run


# the kernel-name fragments of the device BLS kernels, for a call's device
# time by kernel (the rest are torch's own kernels)
BLS_KERNEL_NAMES = (("K3", "fq_mul_kernel"), ("K4", "miller_dbl_run_kernel"),
                    ("K5", "fq12_sq_run_kernel"))


def device_breakdown(args):
    """The device time of one ``batch_fast_aggregate_verify`` call by
    ``torch.profiler``: ms in K3, K4, K5 and torch's own kernels, and their
    sum's share of that same call's host-clock seconds, the profiler on
    (the device's busy share); None where the profiler sees no device
    time."""
    from consensus_specs_tpu_torch.ops import bls as device_bls

    walls = []

    def call():
        t0 = time.perf_counter()
        device_bls.batch_fast_aggregate_verify(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    prof = profiled_kernel_ms(call, calls=1)
    if prof is None:
        print("  device breakdown: not measured (the profiler recorded no "
              "device time)", flush=True)
        return None
    kernels, total = prof
    split = {label: sum(ms for name, (ms, _) in kernels.items()
                        if fragment in name)
             for label, fragment in BLS_KERNEL_NAMES}
    split["torch"] = total - sum(split.values())
    print(f"  device time of one call (torch.profiler): {total:.3f} ms, "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; busy {total / 1e3 / walls[-1]:.1%} of this call's "
          f"{walls[-1]:.3f} s (profiler on)", flush=True)
    return {"total_ms": total, "call_s": walls[-1], **split}


def phase_bls_batches(seed: int) -> dict:
    """8b: BASELINE configs 2 and 3 at full size through
    ``ops.bls.batch_fast_aggregate_verify`` on the card (every verdict
    True), beside native ``BatchFastAggregateVerify``; then a mixed batch
    whose every verdict must equal native ``FastAggregateVerify``'s."""
    from consensus_specs_tpu_torch.crypto.bls import native

    from consensus_specs_tpu_torch.ops.bls import limbs

    sks = list(range(1, 513))
    pks = [native.SkToPk(sk) for sk in sks]
    out = {}
    for label, n_keys, batch in BLS_CONFIGS:
        agg = native.Aggregate([native.Sign(sk, BLS_MESSAGE)
                                for sk in sks[:n_keys]])
        args = ([pks[:n_keys]] * batch, [BLS_MESSAGE] * batch, [agg] * batch)
        # the first, untimed call (decompressions and subgroup checks)
        # keeps K3's first launch at each shape, to hold it against the
        # plain version at the path's own shapes
        seen, launch_k3 = {}, limbs._launch_k3

        def recording_k3(a, b):
            got = launch_k3(a, b)
            key = got.numel() // limbs.N_LIMBS
            if key not in seen:
                seen[key] = (a.clone(), b.clone(), got.clone())
            return got

        limbs._launch_k3 = recording_k3
        try:
            first = device_batch(*args)
        finally:
            limbs._launch_k3 = launch_k3
        run = device_batch(*args)  # timed, with the wrapper as shipped
        for a, b, got in seen.values():
            if not torch.equal(got, limbs.mul_plain(a, b)):
                raise AssertionError(f"{label}: K3 != plain at "
                                     f"{got.numel() // limbs.N_LIMBS} products")
        shapes = run["shapes"]
        if not (all(first["verdicts"]) and all(run["verdicts"])):
            raise AssertionError(f"{label}: a valid item failed on the card")
        if min(run["launches"].values()) <= 0:
            raise AssertionError(f"{label}: launches {run['launches']}")
        items = [(pks[:n_keys], BLS_MESSAGE, agg)] * batch
        t0 = time.perf_counter()
        if not native.BatchFastAggregateVerify(items):
            raise AssertionError(f"{label}: native batch verify failed")
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for pk_set, msg, sig in items:
            native.FastAggregateVerify(pk_set, msg, sig)  # noqa: ST01 sequential baseline
        native_seq_s = time.perf_counter() - t0
        run.update(batch=batch, keys=n_keys, native_s=native_s,
                   native_seq_s=native_seq_s, first_s=first["call_s"])
        out[label] = run
        pairing_text = ("not timed (padded batch)" if run["pairing_s"] is None
                        else f"{run['pairing_s']:.3f} s")
        print(f"{label} ({batch} items of {n_keys} pubkeys, every verdict "
              f"True): device {batch / run['call_s']:.1f} verifies/s "
              f"({run['call_s']:.3f} s; timed alone: marshalling "
              f"{run['marshal_s']:.3f} s host, pairing check "
              f"{pairing_text} device; first call "
              f"{first['call_s']:.3f} s with the decompressions); native "
              f"BatchFastAggregateVerify {batch / native_s:.1f} verifies/s "
              f"({native_s:.3f} s), native sequential "
              f"{batch / native_seq_s:.1f}; launches a batch {run['launches']}; "
              f"K3's launch shapes (products: launches) {shapes}, K3 == plain "
              f"limb for limb at each", flush=True)
        run["device"] = device_breakdown(args)

    # the mixed batch: each kind of item the verifier must tell apart
    rng = np.random.default_rng(seed)
    kinds = ("valid", "wrong message", "other key", "malformed pubkey",
             "empty pubkeys", "infinity signature")
    pubkeys_lists, messages, signatures, labels = [], [], [], []
    for i in range(MIXED_BATCH):
        # two of each kind, then valid items and the kinds the device
        # decides (an infinity signature goes to the host oracle, about
        # half a second each)
        kind = kinds[i % len(kinds)] if i < 2 * len(kinds) else (
            "valid" if rng.random() < 0.5 else kinds[rng.integers(1, len(kinds) - 1)])
        chosen = sorted(rng.choice(512, size=int(rng.integers(1, 129)),
                                   replace=False).tolist())
        keys = [pks[j] for j in chosen]
        message = rng.bytes(32)
        secret = sum(sks[j] for j in chosen)
        signature = native.Sign(secret, message)
        if kind == "wrong message":
            signature = native.Sign(secret, rng.bytes(32))
        elif kind == "other key":
            signature = native.Sign(secret + 1, message)
        elif kind == "malformed pubkey":
            keys[int(rng.integers(0, len(keys)))] = b"\xff" * 48
        elif kind == "empty pubkeys":
            keys = []
        elif kind == "infinity signature":
            from consensus_specs_tpu_torch.ops import bls as device_bls

            signature = device_bls.G2_POINT_AT_INFINITY
        pubkeys_lists.append(keys)
        messages.append(message)
        signatures.append(signature)
        labels.append(kind)
    run = device_batch(pubkeys_lists, messages, signatures)
    want = [bool(native.FastAggregateVerify(k, m, s))  # noqa: ST01 per-item reference verdicts
            for k, m, s in zip(pubkeys_lists, messages, signatures)]
    if run["verdicts"] != want:
        bad = [(i, labels[i]) for i in range(MIXED_BATCH)
               if run["verdicts"][i] != want[i]]
        raise AssertionError(f"mixed batch differs from native at {bad}")
    tally = {k: labels.count(k) for k in kinds}
    print(f"mixed batch of {MIXED_BATCH} from seed {seed} ({tally}): every "
          f"verdict equals native FastAggregateVerify's ({sum(want)} True); "
          f"{run['call_s']:.3f} s, launches {run['launches']}", flush=True)
    out["mixed"] = run
    return out


# -- phase 8c ---------------------------------------------------------------

BLS_CASE_FILES = ("phase0/test_batch_verification.py",
                  "phase0/block_processing/test_process_attestation.py",
                  "altair/test_sync_aggregate.py")


def phase_bls_spec_cases(device: str = "cuda") -> dict:
    """8c: the always-BLS cases of ``BLS_CASE_FILES`` on specs built for
    ``device``, under the "native" backend and then the "torch" one: the
    same passed and skipped counts, and K3 launched under "torch"."""
    from consensus_specs_tpu_torch.testing import context, reference_cases
    from consensus_specs_tpu_torch.testing.exceptions import SkippedTest

    selected = [(f, n) for f in BLS_CASE_FILES
                for n in reference_cases.always_bls_case_names(f)]
    is_pytest, context.is_pytest = context.is_pytest, False
    tallies = {}
    try:
        for backend in ("native", "torch"):
            tally = {"passed": 0, "skipped": 0}
            _reset_bls_counts()
            t0 = time.perf_counter()
            with reference_cases.configured(device, bls_backend=backend):
                for relpath, name in selected:
                    try:
                        reference_cases.cases(relpath)[name]()
                    except SkippedTest:
                        tally["skipped"] += 1
                        continue
                    except BaseException:
                        print(f"spec case failed under {backend}: "
                              f"{relpath}::{name}", flush=True)
                        raise
                    tally["passed"] += 1
            if device != "cpu":
                torch.cuda.synchronize()
            tally.update(seconds=time.perf_counter() - t0,
                         launches=_bls_counts())
            tallies[backend] = tally
    finally:
        context.is_pytest = is_pytest
    print(f"always-BLS spec cases ({len(selected)} in {len(BLS_CASE_FILES)} "
          "files) on " + device + "-built specs: " + "; ".join(
              f"{b} {t['passed']} passed, {t['skipped']} skipped in "
              f"{t['seconds']:.3f} s, launches {t['launches']}"
              for b, t in tallies.items()), flush=True)
    native_t, torch_t = tallies["native"], tallies["torch"]
    if (native_t["passed"], native_t["skipped"]) != (torch_t["passed"],
                                                      torch_t["skipped"]):
        raise AssertionError("the torch backend's case counts differ from "
                             "native's")
    if device != "cpu" and torch_t["launches"]["K3"] <= 0:
        raise AssertionError("the spec cases launched K3 no time")
    return tallies


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random kernel inputs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    with _phase("1 device + builds"):
        smi = phase_device()
    with _phase("2 K1 vs plain"):
        k1 = phase_k1(N_VALIDATORS, args.seed)
    with _phase("2b K2 vs plain"):
        k2 = phase_k2(N_VALIDATORS, args.seed)
    with _phase(f"3 main path at {N_VALIDATORS} validators"):
        main_path = phase_main_path(N_VALIDATORS)
    with _phase(f"3b engine at {N_VALIDATORS} validators"):
        engine = phase_engine(main_path)
    with _phase("4 K1 as SSZ hasher"):
        ssz = phase_ssz_hasher(main_path["spec"], main_path["post"])
    with _phase(f"5 altair main path at {N_VALIDATORS} validators"):
        altair = phase_lineage("altair", N_VALIDATORS)
    with _phase(f"5b altair engine at {N_VALIDATORS} validators"):
        altair_engine = phase_altair_engine(altair)
    # the earlier phases' states and blocks go before phase 6, so that a
    # full collection in its engine run does not walk them
    k2_literal = main_path["k2_launches"]
    del main_path, altair
    gc.collect()
    with _phase(f"6 bellatrix main path at {N_VALIDATORS} validators"):
        bellatrix = phase_lineage("bellatrix", N_VALIDATORS)
    with _phase(f"6b bellatrix engine at {N_VALIDATORS} validators"):
        bellatrix_engine = phase_bellatrix_engine(bellatrix)
    del bellatrix
    with _phase("6c capella on the card (minimal preset)"):
        phase_capella()
    with _phase("7a the reference's spec cases on CUDA-built specs"):
        phase_spec_cases()
    override = {}
    for fork in OVERRIDE_FORKS:
        with _phase(f"7b {fork} config-override epoch at {N_VALIDATORS} validators"):
            override[fork] = phase_config_override(fork, N_VALIDATORS, args.seed)
    with _phase("8a K3, K4, K5 vs plain"):
        bls_kernels = phase_bls_kernels(args.seed)
    with _phase("8b device BLS: BASELINE configs 2 and 3, a mixed batch"):
        bls_batches = phase_bls_batches(args.seed)
    with _phase("8c always-BLS spec cases under the torch backend"):
        bls_cases = phase_bls_spec_cases()

    k1_entry = {
        "name": "sha256_block64",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:87",
        # K1 left the main path (its root is K2's, and phase 3 checks that
        # it launched K1 no time); it serves the SSZ hasher, so its
        # launches, times and bound are those of that path's wave route, the
        # whole schedule of a fresh post-state (phase 4)
        "launches": ssz["launches"],
        "max_abs_err": max(k1["max_abs_err"], ssz["max_abs_err"]),
        "ms": ssz["ms"],
        "plain_ms": ssz["plain_ms"],
        "bound_ms": ssz["bound_ms"],
        "bound_by": ssz["bound_by"],
        "library_ms": None,
        "kernel_ms": ssz["kernel_ms"],
        # the same tree through the per-level route: its K1 launches summed
        "per_level_route_ms": ssz["per_level_route_ms"],
        "per_level_route_launches": ssz["per_level_route_launches"],
        "dense_2e20_ms": k1["dense_2e20_ms"],
    }
    k2_entry = {
        "name": "u64_list_root",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256_tree.cu",
        "replaces": "consensus_specs_tpu/ops/merkle_resident.py:44",
        # the engine's run (phase 3b): the fused epoch update and the
        # resident per-slot root; the literal path's own count beside it
        "launches": engine["k2_launches"],
        "launches_literal_path": k2_literal,
        # the altair and bellatrix engines' runs (phases 5b, 6b): one
        # resident root a block
        "launches_altair_engine": altair_engine["k2_launches"],
        "launches_bellatrix_engine": bellatrix_engine["k2_launches"],
        # the phase0 config-override epoch (phase 7b): its fused update
        "launches_config_override": override["phase0"]["k2_launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "kernel_ms": k2["kernel_ms"],
        "per_level_route_ms": k2["per_level_route_ms"],
    }
    bls_entries = []
    for label, key, name, source, replaces in (
            ("K3", "k3", "fq_mul", "consensus_specs_tpu_torch/csrc/bls_fq.cu",
             "consensus_specs_tpu/ops/bls_jax/limbs.py:145"),
            ("K4", "k4", "miller_dbl_run",
             "consensus_specs_tpu_torch/csrc/bls_miller.cu",
             "consensus_specs_tpu/ops/bls_jax/pairing.py:119"),
            ("K5", "k5", "fq12_sq_run",
             "consensus_specs_tpu_torch/csrc/bls_miller.cu",
             "consensus_specs_tpu/ops/bls_jax/pairing.py:146")):
        numbers = bls_kernels[key]
        bls_entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # BASELINE config 3's batch (phase 8b): 64 items of 128 pubkeys
            # through ops.bls.batch_fast_aggregate_verify on the card
            "launches": bls_batches[BLS_CONFIGS[1][0]]["launches"][label],
            "launches_config2": bls_batches[BLS_CONFIGS[0][0]]["launches"][label],
            "launches_mixed_batch": bls_batches["mixed"]["launches"][label],
            "launches_spec_cases": bls_cases["torch"]["launches"][label],
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            # PyTorch has no field multiply, Miller loop or Fq12 power
            "library_ms": None,
            "kernel_ms": numbers["kernel_ms"],
        })
    print(json.dumps({"kernels": [k1_entry, k2_entry, *bls_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
