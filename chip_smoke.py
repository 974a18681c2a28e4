"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``consensus_specs_tpu_torch``) only; it imports nothing
of JAX and nothing of the reference package.  Phases, each printing its
seconds:

1. device: the card's name and power limit; builds the CUDA kernel K1
   (``csrc/sha256.cu``, nvcc for sm_90a) and the native BLS library in
   parallel.
2. K1 against its plain torch version on the card, bit for bit, at
   N in {1, 129, 2^20} and at every level of the main path's balances
   reduction, and against hashlib on a sample; times both.
3. the main path: one mainnet-preset phase0 epoch at 400,000 validators
   with BLS on — 32 signed blocks (3,904 aggregate attestations) through
   ``spec.state_transition`` on a CUDA-built spec, the last of which
   crosses the epoch boundary.  The fused epoch update must run once and
   launch K1; the last block, replayed from its serialized pre-state on a
   ``device="cpu"`` spec, must give the same post-state root.
4. K1 as the SSZ layer hasher: a freshly decoded copy of the post-state
   hashed under the ``"torch"`` backend equals its hashlib root.

Every comparison is exact (tolerance 0): digests and roots are integers
and bytes.  Then one JSON line per kernel (launches on the main path,
error against the plain version, times, the bound), the ``nvidia-smi``
line, and last the device line.  Any failed phase raises: the exit code is non-zero and
no result line is printed.  Without CUDA it fails before any phase.
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 1 ----------------------------------------------------------------


def phase_device():
    from consensus_specs_tpu_torch.ops import sha256

    smi = nvidia_smi_line()
    print(f"card: {smi} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible); python "
          f"{sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    built = {}

    def build_k1():
        t0 = time.perf_counter()
        built["k1_path"] = sha256.build_kernel()
        built["k1_s"] = time.perf_counter() - t0

    worker = threading.Thread(target=build_k1)
    worker.start()
    t0 = time.perf_counter()
    from consensus_specs_tpu_torch.crypto import bls

    bls.use_native()  # builds the native BLS library with g++
    bls_s = time.perf_counter() - t0
    worker.join()
    if "k1_path" not in built:
        raise RuntimeError("K1 build failed (see the thread's traceback above)")
    print(f"K1 built in {built['k1_s']:.3f} s (nvcc sm_90a), native BLS in "
          f"{bls_s:.3f} s, in parallel", flush=True)
    with open(built["k1_path"] + ".log") as log:
        for line in log.read().splitlines():
            if "registers" in line or "spill" in line:
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


def _balance_leaf_words(n_validators: int, seed: int) -> torch.Tensor:
    """Chunk words of a balances vector of the main path's length, padded
    to its power of two, exactly as the fused update lays them out."""
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256

    rng = np.random.default_rng(seed)
    n_pad = 1 << (n_validators - 1).bit_length()
    bal = np.zeros(n_pad, dtype=np.int64)
    bal[:n_validators] = rng.integers(31 * 10**9, 33 * 10**9, n_validators)
    t = torch.as_tensor(bal, device="cuda")
    lo, hi = t & 0xFFFFFFFF, t >> 32
    words = torch.stack([merkle_resident._byteswap32(lo),
                         merkle_resident._byteswap32(hi)], dim=1).reshape(-1, 8)
    return sha256.to_int32_bits(words)


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
    leaves = _balance_leaf_words(n_validators, seed)
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
    return {"max_abs_err": max_err, "ms": k1_path, "plain_ms": plain_path,
            "bound_ms": bound_path, "bound_by": by_path,
            "messages": n_messages,
            "ms_2p20": k1_big, "plain_ms_2p20": plain_big,
            "bound_ms_2p20": bound_big}


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
    launches = sha256.counts["sha256_block64"]
    fused = merkle_resident.stats["fused_epoch_updates"]
    root = bytes(post.hash_tree_root())
    print(f"main path: {len(blocks)} blocks in {t_end - t0:.3f} s (last block, "
          f"with the epoch transition: {t_end - t_last:.3f} s); fused epoch "
          f"updates {fused}, K1 launches {launches}; root {root.hex()}",
          flush=True)
    if fused != 1:
        raise AssertionError(f"fused epoch update ran {fused} times, not once")
    if launches == 0:
        raise AssertionError("the epoch transition did not launch K1")

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
    return {"launches": launches, "post": post, "spec": spec,
            "attestations": n_atts}


# -- phase 4 ----------------------------------------------------------------


def phase_ssz_hasher(spec, post) -> dict:
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.ssz import hashing

    encoded = bytes(post.encode_bytes())
    fresh_torch = spec.BeaconState.decode_bytes(encoded)
    fresh_host = spec.BeaconState.decode_bytes(encoded)
    before = sha256.counts["sha256_block64"]
    hashing.set_backend("torch", device="cuda")
    try:
        t0 = time.perf_counter()
        root_torch = bytes(fresh_torch.hash_tree_root())
        torch.cuda.synchronize()
        t_torch = time.perf_counter() - t0
    finally:
        hashing.set_backend("hashlib")
    launches = sha256.counts["sha256_block64"] - before
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
    if launches == 0:
        raise AssertionError("the torch hashing backend did not launch K1")
    return {"ssz_launches": launches, "ssz_torch_s": t_torch,
            "ssz_hashlib_s": t_host}


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
    with _phase(f"3 main path at {N_VALIDATORS} validators"):
        main_path = phase_main_path(N_VALIDATORS)
    with _phase("4 K1 as SSZ hasher"):
        ssz = phase_ssz_hasher(main_path["spec"], main_path["post"])

    kernel = {
        "name": "sha256_block64",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:87",
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "kernel_ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "messages": k1["messages"],
        "ms_2p20": k1["ms_2p20"],
        "plain_ms_2p20": k1["plain_ms_2p20"],
        "bound_ms_2p20": k1["bound_ms_2p20"],
        "ssz_launches": ssz["ssz_launches"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
