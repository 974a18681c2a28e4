"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``consensus_specs_tpu_torch``) only; it imports nothing
of JAX and nothing of the reference package.  Phases, each printing its
seconds:

1. device: the card's name and power limit; builds the CUDA kernels K1
   and K2 (``csrc/sha256.cu`` and ``csrc/sha256_tree.cu``, one nvcc call
   for sm_90a) and the native BLS library in parallel.
2. K1 against its plain torch version on the card, bit for bit, at
   N in {1, 129, 2^20} and at every level of the main path's balances
   reduction, and against hashlib on a sample; times both.
2b. K2 against its plain torch version and the per-level route (torch
   packing plus one K1 launch a level) at every power of two from 1 to 2^19
   chunks (one and two passes) and on the main path's balances; prints
   K2's ptxas report and the SASS opcode counts of K1 and K2 by pipe
   (``cuobjdump -sass``); times K2 and the per-level route in turns at the
   main path's shape, with kernel-only times from ``torch.profiler`` where
   it sees the card, one tree level in one warp, the bound, and two models
   (not bounds) of the tree's dependency chain.
3. the main path: one mainnet-preset phase0 epoch at 400,000 validators
   with BLS on — 32 signed blocks (3,904 aggregate attestations) through
   ``spec.state_transition`` on a CUDA-built spec, the last of which
   crosses the epoch boundary.  The fused epoch update must run once and
   launch K2 (one or two passes) and K1 not at all; the last block,
   replayed from its serialized pre-state on a ``device="cpu"`` spec,
   must give the same post-state root.
3b. the engine at 400,000 validators: the same 32 blocks through the
   batched block engine, ``stf.apply_signed_blocks``, on a copy of phase
   3's pre-state whose balances were bulk-written again (unhashed, as a
   state loader leaves them), from cold engine caches.  Every block must
   take the fast path (none replayed, breaker closed, native BLS not
   degraded), the root must equal phase 3's, the fused epoch update must
   run once, K1 must not launch, and K2 must launch for the epoch and for
   the resident per-slot root of the bulk-written balances.
4. K1 as the SSZ layer hasher: a freshly decoded copy of the post-state
   hashed under the ``"torch"`` backend equals its hashlib root; then the
   inputs of those K1 launches are held against the plain version and
   timed, K1's path shapes for its kernels entry.

Every comparison is exact (tolerance 0): digests and roots are integers
and bytes.  Then one JSON line of the kernels (launches on the path that
drives each, error against the plain version, times on that path's
shapes, the bound), the
``nvidia-smi`` line, and last the device line.  Any failed phase raises:
the exit code is non-zero and no result line is printed.  Without CUDA it
fails before any phase.
"""
from __future__ import annotations

import argparse
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

# the main path's registry size (the scale BASELINE.json states)
N_VALIDATORS = 400_000

# Two models, not bounds, of K2's dependency chain (csrc/sha256_tree.cu),
# printed beside its time and never in the kernels line.  The schedule
# model: a warp alone on its SM sub-partition issues as ptxas scheduled
# it, so each dependent tree level costs the scheduled cycles of one
# message hash (the stall counts in the SASS of K1's kernel, which is one
# hash and its loads and stores).  The chain floor: each of the 128 rounds
# of a level waits for three dependent instructions (from e to the next e:
# a rotate, the xor, an add) of about four cycles each.
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


def phase_device():
    from consensus_specs_tpu_torch.ops import sha256

    smi = nvidia_smi_line()
    print(f"card: {smi} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible); python "
          f"{sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    built = {}

    def build_kernels():
        t0 = time.perf_counter()
        built["path"] = sha256.build_kernel()
        built["s"] = time.perf_counter() - t0

    worker = threading.Thread(target=build_kernels)
    worker.start()
    t0 = time.perf_counter()
    from consensus_specs_tpu_torch.crypto import bls

    bls.use_native()  # builds the native BLS library with g++
    bls_s = time.perf_counter() - t0
    worker.join()
    if "path" not in built:
        raise RuntimeError("K1/K2 build failed (see the thread's traceback above)")
    print(f"K1 + K2 built in {built['s']:.3f} s (one nvcc call, sm_90a), "
          f"native BLS in {bls_s:.3f} s, in parallel", flush=True)
    with open(built["path"] + ".log") as log:
        for line in log.read().splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                print(f"  ptxas: {line.strip()}")
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
    print(f"N=2^20: K1 {k1_big:.4f} ms, plain {plain_big:.3f} ms, bound "
          f"{bound_big:.4f} ms ({by_big})", flush=True)

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
    # kernels entry is timed on the SSZ hasher's launches (phase 4)
    return {"max_abs_err": max_err}


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


def print_sass(lib_path: str):
    """Print the SASS opcode counts of K1 and K2 by pipe, per round of
    their one unrolled message hash, and their scheduled cycles; return
    K1's scheduled cycles, one message hash's (None where cuobjdump is
    missing)."""
    kernels = sass_kernels(lib_path)
    if kernels is None:
        print("SASS opcode counts: not measured (no cuobjdump)", flush=True)
        return None
    k1_cycles = None
    for label, fragment in (("K1", "sha256_block64_kernel"),
                            ("K2", "tree_reduce_kernel")):
        names = [k for k in kernels if fragment in k]
        if not names:
            raise AssertionError(f"cuobjdump shows no {fragment} ({label})")
        ops, cycles = kernels[names[0]]
        pipes = by_pipe(ops)
        per_round = ", ".join(f"{k} {v / ROUNDS_PER_MESSAGE:.2f}"
                              for k, v in pipes.items())
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common())
        print(f"SASS {label} ({sum(ops.values())} instructions, {cycles} "
              f"scheduled cycles, static): by pipe {pipes}; a round of its "
              f"one message hash: {per_round}; opcodes: {top}", flush=True)
        if label == "K1":
            k1_cycles = cycles
    return k1_cycles


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
                  f"one hash)")
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

    # the CPU leg: the boundary block from its serialized pre-state
    cpu_spec = get_spec("phase0", "mainnet", device="cpu")
    cpu_state = cpu_spec.BeaconState.decode_bytes(bytes(pre_last.encode_bytes()))
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


def phase_engine(main_path: dict) -> dict:
    from consensus_specs_tpu_torch import stf, tracing
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256
    from consensus_specs_tpu_torch.ssz import bulk
    from consensus_specs_tpu_torch.stf import attestations, pipeline, verify

    spec, blocks = main_path["spec"], main_path["blocks"]
    state = main_path["pre"].copy()
    # a state as a loader hands it over: the balances bulk-written, their
    # subtree unhashed, so the first slot root takes the resident route
    bulk.set_packed_uint64_from_numpy(
        state.balances, bulk.packed_uint64_to_numpy(state.balances))
    # cold engine caches: the engine pays for its own committee geometry,
    # device buffers and signature checks
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
        stf.apply_signed_blocks(spec, state, blocks, True)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counters = tracing.report()["counters"]
    finally:
        tracing.disable()
    k2_launches = sha256.counts["u64_list_root"]
    k1_launches = sha256.counts["sha256_block64"]
    fused = merkle_resident.stats["fused_epoch_updates"]
    resident = counters.get("stf.resident_slot_root", 0)
    root = bytes(state.hash_tree_root())
    phases = {k: stf.stats[k] for k in ENGINE_PHASES}
    print(f"engine: {len(blocks)} blocks in {t_end - t0:.3f} s (literal path "
          f"in phase 3: {main_path['seconds']:.3f} s); "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; fast blocks {stf.stats['fast_blocks']}, replayed "
          f"{stf.stats['replayed_blocks']} {stf.stats['replay_reasons']}, "
          f"breaker trips {stf.stats['breaker_trips']}, native degraded "
          f"{verify.stats['native_degraded']}; signature batches "
          f"{verify.stats['batches']} ({verify.stats['entries']} entries, "
          f"{verify.stats['memo_hits']} memo hits), pipeline overlap "
          f"{pipeline.stats['overlap_s']:.3f} s, await "
          f"{pipeline.stats['await_s']:.3f} s", flush=True)
    print(f"engine: fused epoch updates {fused}, stf.resident_slot_root "
          f"{resident}, K2 launches {k2_launches}, K1 launches {k1_launches}; "
          f"root {root.hex()}", flush=True)
    if (stf.stats["fast_blocks"] != len(blocks)
            or stf.stats["replayed_blocks"] != 0
            or stf.stats["replay_reasons"] != {}
            or stf.stats["breaker_trips"] != 0
            or verify.stats["native_degraded"] != 0):
        raise AssertionError(f"the engine left its fast path: {stf.stats}")
    if root != main_path["root"]:
        raise AssertionError("engine root differs from the literal path's")
    if fused != 1:
        raise AssertionError(f"fused epoch update ran {fused} times, not once")
    if k1_launches != 0:
        raise AssertionError(f"the engine launched K1 {k1_launches} times")
    if resident != 1:
        raise AssertionError(f"the resident slot root fired {resident} times "
                             "on bulk-written balances, not once")
    n_chunks = 1 << ((len(state.balances) + 3) // 4 - 1).bit_length()
    if k2_launches != sha256.k2_plan(n_chunks)[0] * (fused + resident):
        raise AssertionError(f"K2 launched {k2_launches} times for {fused} "
                             f"epoch and {resident} slot roots")
    return {"k2_launches": k2_launches, "k1_launches": k1_launches,
            "seconds": t_end - t0, **phases}


# -- phase 4 ----------------------------------------------------------------


def phase_ssz_hasher(spec, post) -> dict:
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.ssz import hashing

    encoded = bytes(post.encode_bytes())
    fresh_torch = spec.BeaconState.decode_bytes(encoded)
    fresh_host = spec.BeaconState.decode_bytes(encoded)
    # keep each K1 input of this path, to check and time K1 at its shapes
    recorded = []
    launch_k1 = sha256._launch_k1

    def recording_launch(words):
        recorded.append(words)
        return launch_k1(words)

    sha256.reset_counts()
    sha256._launch_k1 = recording_launch
    hashing.set_backend("torch", device="cuda")
    try:
        t0 = time.perf_counter()
        root_torch = bytes(fresh_torch.hash_tree_root())
        torch.cuda.synchronize()
        t_torch = time.perf_counter() - t0
    finally:
        hashing.set_backend("hashlib")
        sha256._launch_k1 = launch_k1
    launches = sha256.counts["sha256_block64"]
    t0 = time.perf_counter()
    root_host = bytes(fresh_host.hash_tree_root())
    t_host = time.perf_counter() - t0
    print(f"ssz hasher: torch backend {t_torch:.3f} s ({launches} K1 "
          f"launches), hashlib {t_host:.3f} s; root {root_torch.hex()}",
          flush=True)
    if root_torch != root_host:
        raise AssertionError("K1-backed SSZ root differs from hashlib's")
    if root_torch != bytes(post.hash_tree_root()):
        raise AssertionError("fresh decode root differs from the main path's")
    if launches == 0 or len(recorded) != launches:
        raise AssertionError(f"the torch hashing backend launched K1 "
                             f"{launches} times, {len(recorded)} recorded")

    # K1 at this path's shapes: each launch's input against the plain
    # version, and the sums of the times of one call at each shape
    max_err, k1_ms, plain_ms, messages = 0, 0.0, 0.0, 0
    for words in recorded:
        err = _word_err(sha256.sha256_block64(words), _plain_on(words))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"K1 != plain at the SSZ hasher's N="
                                 f"{words.shape[0]}: max |diff| {err}")
        k1_ms += cuda_ms(lambda w=words: sha256.sha256_block64(w))
        plain_ms += cuda_ms(lambda w=words: _plain_on(w), iters=3, warmup=1)
        messages += words.shape[0]
    bound, bound_by = bound_ms(messages, sha256)
    print(f"K1 == plain at the SSZ hasher's {launches} launch shapes (N = "
          f"{', '.join(str(w.shape[0]) for w in recorded)}; {messages} "
          f"messages): K1 {k1_ms:.5f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound:.5f} ms ({bound_by}), summed over the launches", flush=True)
    return {"launches": launches, "max_abs_err": max_err, "ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


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

    k1_entry = {
        "name": "sha256_block64",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:87",
        # K1 left the main path (its root is K2's, and phase 3 checks that
        # it launched K1 no time); it serves the SSZ hasher, so its
        # launches, times and bound are those of that path (phase 4)
        "launches": ssz["launches"],
        "max_abs_err": max(k1["max_abs_err"], ssz["max_abs_err"]),
        "ms": ssz["ms"],
        "plain_ms": ssz["plain_ms"],
        "bound_ms": ssz["bound_ms"],
        "bound_by": ssz["bound_by"],
        "library_ms": None,
    }
    k2_entry = {
        "name": "u64_list_root",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256_tree.cu",
        "replaces": "consensus_specs_tpu/ops/merkle_resident.py:44",
        # the engine's run (phase 3b): the fused epoch update and the
        # resident per-slot root; the literal path's own count beside it
        "launches": engine["k2_launches"],
        "launches_literal_path": main_path["k2_launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "kernel_ms": k2["kernel_ms"],
        "per_level_route_ms": k2["per_level_route_ms"],
    }
    print(json.dumps({"kernels": [k1_entry, k2_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
