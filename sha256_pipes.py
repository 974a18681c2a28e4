"""K1's integer pipe policies, timed against each other on one NVIDIA GPU.

    python3 sha256_pipes.py [--messages 1048576] [--rounds 2] [--seed 0]
                            [--parent DIR]

Builds copies of ``consensus_specs_tpu_torch/csrc/sha256.cu`` in which K1's
grid launches hash the message block and the padding block through other
policies of the shared core's round (``csrc/sha256_core.cuh``; the lines
``using K1MessagePipe = ...;`` and ``using K1PaddingPipe = ...;``): the
core's ``AluPipe`` (every add an IADD3 on the ALU pipe) and ``FmaPipe``
(every add an IMAD by a run-time 1, the schedule's shifts IMAD.HI, on the
FMA pipe) in each combination, and two candidates defined here that also
move two of the three rotates of Sigma1, or of both Sigmas, to the FMA
pipe, as the two halves of an IMAD.WIDE.U32 by 2^(32 - n) xored into the
Sigma's LOP3s.  Every copy's dense entry hashes the same ``--messages``
random messages and must equal the plain version.  Prints each copy's SASS
instruction counts by pipe (``cuobjdump -sass``) and its issue floors, a
model and not a bound (the instructions of either pipe at 16 lanes a clock
on each of the card's sub-partitions, or all of them at one a clock), then
every copy's time by CUDA events in turns (A B C D D C B A, ``--rounds``
times) and the SM clock ``nvidia-smi`` reads while it runs, and the card.  With
``--parent DIR`` (a checkout of another commit, or of its
``consensus_specs_tpu_torch/csrc`` alone) it also builds that commit's
K1 and K2 from their sources and times, in turns with this tree's (parent,
this, this, parent, ``--rounds`` times), K1's dense entry on the same
messages and K2 on a packed uint64 list of ``--chunks`` chunks, both
checked against this tree's outputs.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys
import threading
import time

import numpy as np
import torch

K1_PIPES = re.compile(r"using K1MessagePipe = \w+;\nusing K1PaddingPipe = \w+;")

# Policies beyond the core's two.  rotr(x, n) is the high word of
# x * 2^(32 - n) or'ed with its low word; the two halves have no bit in
# common, so they xor into the Sigma instead of a funnel shift.
EXTRA_PIPES = {
    "FmaAdds": r"""
struct FmaAdds : FmaPipe {  // FmaPipe's adds, AluPipe's shifts
  __device__ explicit FmaAdds(uint32_t one_) : FmaPipe(one_) {}
  __device__ __forceinline__ uint32_t small_sigma0(uint32_t x) const {
    return AluPipe::small_sigma0(x);
  }
  __device__ __forceinline__ uint32_t small_sigma1(uint32_t x) const {
    return AluPipe::small_sigma1(x);
  }
};
""",
    "FmaWideSigma1": r"""
struct FmaWideSigma1 : FmaPipe {
  uint32_t m26, m21;  // 2^26, 2^21
  __device__ explicit FmaWideSigma1(uint32_t one_)
      : FmaPipe(one_), m26(one_ << 26), m21(one_ << 21) {}
  __device__ __forceinline__ uint32_t big_sigma1(uint32_t e) const {
    unsigned long long r6, r11;
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(r6) : "r"(e), "r"(m26));
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(r11) : "r"(e), "r"(m21));
    return (uint32_t)r6 ^ (uint32_t)(r6 >> 32) ^ (uint32_t)r11 ^
           (uint32_t)(r11 >> 32) ^ rotr(e, 25);
  }
};
""",
    "FmaWideSigmas": r"""
struct FmaWideSigmas : FmaPipe {
  uint32_t m26, m21, m30, m19;  // 2^26, 2^21, 2^30, 2^19
  __device__ explicit FmaWideSigmas(uint32_t one_)
      : FmaPipe(one_), m26(one_ << 26), m21(one_ << 21), m30(one_ << 30),
        m19(one_ << 19) {}
  __device__ __forceinline__ uint32_t wide_xor(uint32_t x, uint32_t m1,
                                               uint32_t m2) const {
    unsigned long long r1, r2;
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(r1) : "r"(x), "r"(m1));
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(r2) : "r"(x), "r"(m2));
    return (uint32_t)r1 ^ (uint32_t)(r1 >> 32) ^ (uint32_t)r2 ^
           (uint32_t)(r2 >> 32);
  }
  __device__ __forceinline__ uint32_t big_sigma0(uint32_t a) const {
    return wide_xor(a, m30, m19) ^ rotr(a, 22);  // rotr 2, 13, 22
  }
  __device__ __forceinline__ uint32_t big_sigma1(uint32_t e) const {
    return wide_xor(e, m26, m21) ^ rotr(e, 25);  // rotr 6, 11, 25
  }
};
""",
}

# name: (the message block's pipe, the padding block's)
CANDIDATES = {
    "AluPipe": ("AluPipe", "AluPipe"),
    "FmaPipe": ("FmaPipe", "FmaPipe"),
    "FmaMessage": ("FmaPipe", "AluPipe"),
    "FmaPadding": ("AluPipe", "FmaPipe"),
    "FmaAddsMessage": ("FmaAdds", "AluPipe"),
    "FmaAdds": ("FmaAdds", "FmaPipe"),
    "FmaWideSigma1": ("FmaWideSigma1", "FmaWideSigma1"),
    "FmaWideSigmas": ("FmaWideSigmas", "FmaWideSigmas"),
}


def variant_source(src: str, name: str) -> str:
    """sha256.cu with K1's grid launches on candidate ``name``'s pipes, the
    definitions of those the core lacks placed just before."""
    if len(K1_PIPES.findall(src)) != 1:
        raise RuntimeError("sha256.cu no longer names K1's pipes in the two "
                           "`using K1MessagePipe / K1PaddingPipe = ...;` lines")
    message, padding = CANDIDATES[name]
    extra = "".join(EXTRA_PIPES[p] for p in dict.fromkeys((message, padding))
                    if p in EXTRA_PIPES)
    return K1_PIPES.sub(lambda _: extra + f"using K1MessagePipe = {message};\n"
                        f"using K1PaddingPipe = {padding};", src)


def build(name: str) -> str:
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import sha256

    cu = os.path.join(sha256._CSRC_DIR, "sha256.cu")
    with open(cu) as f:
        src = variant_source(f.read(), name)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"sha256_pipe_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    compiler = _build.nvcc()
    return _build.build_shared(
        f"sha256_pipe_{name}", (path, sha256.SOURCES[-1]),
        lambda out: [compiler, *_build.NVCC_FLAGS, "-I", sha256._CSRC_DIR,
                     path, "-o", out],
        flags=_build.NVCC_FLAGS)


def dense_launcher(so_path: str):
    lib = ctypes.CDLL(so_path)
    lib.sha256_block64_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_void_p]
    lib.sha256_block64_launch.restype = ctypes.c_int

    def launch(words: torch.Tensor, out: torch.Tensor) -> None:
        rc = lib.sha256_block64_launch(
            words.data_ptr(), out.data_ptr(), words.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    return launch


def parent_library(parent: str) -> ctypes.CDLL:
    """K1 and K2 of another checkout, built from its sources with this
    tree's nvcc flags (the launchers' C signatures are unchanged since K2
    came)."""
    from consensus_specs_tpu_torch import _build

    csrc = os.path.join(parent, "consensus_specs_tpu_torch", "csrc")
    cu = [os.path.join(csrc, n) for n in ("sha256.cu", "sha256_tree.cu")]
    so = _build.build_shared(
        "sha256_parent", cu + [os.path.join(csrc, "sha256_core.cuh")],
        lambda out: [_build.nvcc(), *_build.NVCC_FLAGS, *cu, "-o", out],
        flags=_build.NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.sha256_block64_launch.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    lib.u64_list_root_launch.argtypes = [
        ptr, ptr, ctypes.c_longlong, ptr, ctypes.c_longlong, ptr,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def k2_launcher(lib):
    """K2 through ``lib``'s launcher, as ``ops.sha256.launch_u64_list_root``
    calls it: [8] int32 root words of a packed uint64 list."""
    from consensus_specs_tpu_torch.ops import sha256

    def root(values: torch.Tensor) -> torch.Tensor:
        n_chunks = values.shape[0] // 4
        planned, scratch = sha256.k2_plan(n_chunks)
        buf = torch.empty(8 * (1 + scratch), dtype=torch.int32, device="cuda")
        passes = ctypes.c_int(0)
        rc = lib.u64_list_root_launch(
            values.data_ptr(), buf.data_ptr() + 32, scratch, buf.data_ptr(),
            n_chunks, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(passes))
        if rc != 0 or passes.value != planned:
            raise RuntimeError(f"K2 failed: error {rc}, {passes.value} passes")
        return buf[:8]

    return root


def compare_with_parent(parent: str, words: torch.Tensor, chunks: int,
                        rounds: int, seed: int) -> None:
    import chip_smoke
    from consensus_specs_tpu_torch.ops import merkle_resident, sha256

    lib = parent_library(parent)
    out_parent = torch.empty((words.shape[0], 8), dtype=torch.int32, device="cuda")

    def k1_parent():
        rc = lib.sha256_block64_launch(words.data_ptr(), out_parent.data_ptr(),
                                       words.shape[0],
                                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's K1 failed with CUDA error {rc}")

    rng = np.random.default_rng(seed + 1)
    values = torch.from_numpy(rng.integers(0, 2**63, 4 * chunks, dtype=np.int64)).cuda()
    k2_parent = k2_launcher(lib)
    k1_parent()
    if not torch.equal(out_parent, sha256.sha256_block64(words)):
        raise AssertionError("the parent's K1 differs from this tree's")
    if not torch.equal(k2_parent(values), merkle_resident.packed_u64_root(values)):
        raise AssertionError("the parent's K2 differs from this tree's")
    pairs = (("K1 dense", words.shape[0], "messages", k1_parent,
              lambda: sha256.sha256_block64(words), 50),
             ("K2", chunks, "chunks", lambda: k2_parent(values),
              lambda: merkle_resident.packed_u64_root(values), 20))
    for label, n, unit, parent_fn, this_fn, iters in pairs:
        seen = {"parent": [], "this tree": []}
        for _ in range(rounds):
            for who, fn in (("parent", parent_fn), ("this tree", this_fn),
                            ("this tree", this_fn), ("parent", parent_fn)):
                seen[who].append(chip_smoke.cuda_ms(fn, iters=iters))
        print(f"{label} at {n} {unit}, in turns: " + "; ".join(
            f"{who} {' / '.join(f'{t:.5f}' for t in ts)} ms (mean "
            f"{np.mean(ts):.5f})" for who, ts in seen.items()), flush=True)


def clock_under_load(fn, seconds: float = 1.5) -> float:
    """Median SM clock in MHz that ``nvidia-smi`` reads while ``fn()`` runs
    back to back for about ``seconds``."""
    import chip_smoke

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(float(chip_smoke.nvidia_smi(
                "clocks.sm", "csv,noheader,nounits")))

    reader = threading.Thread(target=sample)
    reader.start()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        reader.join()
    return float(np.median(samples))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--messages", type=int, default=1 << 20)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", default=None,
                        help="a checkout whose K1 and K2 to time in turns")
    parser.add_argument("--chunks", type=int, default=1 << 17,
                        help="K2's list size in chunks, a power of two")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sha256_pipes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from consensus_specs_tpu_torch.ops import sha256

    names = list(CANDIDATES)
    built, failed = {}, []

    def build_one(name):
        try:
            built[name] = build(name)
        except OSError as exc:
            failed.append(f"{name}: {exc}")

    threads = [threading.Thread(target=build_one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise RuntimeError("builds failed:\n" + "\n".join(failed))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in names:
        kernels = chip_smoke.sass_kernels(built[name])
        if kernels is None:
            print(f"{name}: SASS not measured (no cuobjdump)")
            continue
        [dense] = [k for k in kernels
                   if "sha256_block64_kernel" in k and "DenseRows" in k]
        ops, cycles = kernels[dense]
        pipes = chip_smoke.by_pipe(ops)
        lanes = 64 * sms * chip_smoke.SM_CLOCK_HZ  # one pipe, all SMs
        alu_ms = pipes["alu"] * args.messages / lanes * 1e3
        fma_ms = pipes["fma"] * args.messages / lanes * 1e3
        issue_ms = (pipes["alu"] + pipes["fma"]) * args.messages / (2 * lanes) * 1e3
        print(f"{name}: SASS by pipe {pipes} ({sum(ops.values())} "
              f"instructions, {cycles} scheduled cycles); issue floors at "
              f"{args.messages} messages (models, not bounds): ALU pipe "
              f"{alu_ms:.4f} ms, FMA pipe {fma_ms:.4f} ms, both at one a "
              f"clock {issue_ms:.4f} ms", flush=True)

    rng = np.random.default_rng(args.seed)
    host = rng.integers(0, 2**32, (args.messages, 16), dtype=np.uint64).astype(np.uint32)
    words = torch.from_numpy(host.view(np.int32)).cuda()
    plain = sha256.to_int32_bits(
        sha256.sha256_block64_plain(sha256.from_int32_bits(words)))
    launchers = {name: dense_launcher(built[name]) for name in names}
    outs = {name: torch.empty((args.messages, 8), dtype=torch.int32,
                              device="cuda") for name in names}
    for name in names:
        launchers[name](words, outs[name])
        torch.cuda.synchronize()
        if not torch.equal(outs[name], plain):
            raise AssertionError(f"{name} != plain at {args.messages} messages")
    print(f"every copy == plain at {args.messages} messages", flush=True)

    times = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            times[name].append(chip_smoke.cuda_ms(
                lambda n=name: launchers[n](words, outs[n]), iters=50))
    bound, bound_by = chip_smoke.bound_ms(args.messages, sha256)
    for name in names:
        clock = clock_under_load(lambda n=name: launchers[n](words, outs[n]))
        print(f"{name}: {' / '.join(f'{t:.5f}' for t in times[name])} ms "
              f"(mean {np.mean(times[name]):.5f}; SM clock under load "
              f"{clock:.0f} MHz; bound {bound:.5f} ms, {bound_by})", flush=True)
    if args.parent is not None:
        compare_with_parent(args.parent, words, args.chunks, args.rounds,
                            args.seed)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
