"""Cycles each phase of K4's and K5's step takes on one NVIDIA GPU.

    python3 bls_phase_clock.py [--batch 64] [--pairs 2] [--steps 32]

Builds a copy of ``consensus_specs_tpu_torch/csrc/bls_miller.cu`` in which
thread 0 of block 0 reads ``clock64()`` after each phase's
``__syncthreads()``, runs K4 (a doubling run of ``--steps`` steps at
``--pairs`` pairs) and K5 (a squaring run) through the port's wrappers on
``--batch`` random items from ``--seed``, and prints for each phase of the
step its products, its renorms, the most terms an operand of it sums, and
its mean cycles over the steps after the first; then each kernel's time by
CUDA events with the clock reads in, and the card.  The outputs must equal
the plain versions' limb for limb.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import numpy as np
import torch

CLOCK_WORDS = 4096
RUN_STEPS = ("__device__ __forceinline__ void run_steps("
             "long long* S, const Table t, int n) {")
PHASE_END = """      __syncthreads();
    }
  }
}"""


def instrumented_source(src: str) -> str:
    """bls_miller.cu with the phase clock and a reader of it."""
    if RUN_STEPS not in src or src.count(PHASE_END) != 1:
        raise RuntimeError("bls_miller.cu no longer has the run_steps loop "
                           "this script instruments")
    src = src.replace(RUN_STEPS, f"__device__ long long g_clock[{CLOCK_WORDS}];\n"
                      + RUN_STEPS + "\n  long long t_prev = clock64();")
    src = src.replace(PHASE_END, f"""      __syncthreads();
      if (blockIdx.x == 0 && threadIdx.x == 0 &&
          step * t.n_phases + p < {CLOCK_WORDS}) {{
        const long long now = clock64();
        g_clock[step * t.n_phases + p] = now - t_prev;
        t_prev = now;
      }}
    }}
  }}
}}""")
    return src + f"""
extern "C" int phase_clock_read(long long* host) {{
  cudaMemcpyFromSymbol(host, g_clock, sizeof(long long) * {CLOCK_WORDS});
  return (int)cudaGetLastError();
}}
"""


def build() -> ctypes.CDLL:
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops.bls import pairing

    with open(pairing.CU_SOURCES[0]) as f:
        src = instrumented_source(f.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "bls_miller_clock.cu")
    with open(path, "w") as f:
        f.write(src)
    csrc = os.path.dirname(pairing.CU_SOURCES[0])
    compiler = _build.nvcc()
    so = _build.build_shared(
        "bls_miller_clock", (path,) + pairing.HEADERS,
        lambda out: [compiler, *_build.NVCC_FLAGS, "-I", csrc, path, "-o", out],
        flags=_build.NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.miller_dbl_run_launch.argtypes = [ptr] * 10 + [ctypes.c_int] * 3 + [ptr]
    lib.fq12_sq_run_launch.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
    lib.phase_clock_read.argtypes = [ptr]
    return lib


def phase_lines(table: int, cycles: np.ndarray) -> list:
    from consensus_specs_tpu_torch.ops.bls import schedule

    s = schedule.build(table)
    lines = []
    for p, (first, n_mul, n_rest) in enumerate(s.phases):
        ops = s.ops[first:first + n_mul + n_rest]
        widest = int(max(max(o[2] - o[1], o[3] - o[2]) for o in ops))
        lines.append(f"  phase {p}: {n_mul} products, {n_rest} renorms, "
                     f"operands of up to {widest} terms: {cycles[p]:.0f} cycles")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bls_phase_clock: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from consensus_specs_tpu_torch.ops.bls import pairing, schedule

    B, K, n = args.batch, args.pairs, args.steps
    if n < 2:
        raise SystemExit("--steps must be at least 2")
    lib = build()
    pairing._library = lambda: lib  # the wrappers launch the clocked copy
    rng = np.random.default_rng(args.seed)
    dev = [torch.from_numpy(chip_smoke._residues(rng, shape)).cuda()
           for shape in ((B, 6, 2), (K, B, 2), (K, B, 2), (K, B, 2), (K, B),
                         (K, B))]
    clock = np.zeros(CLOCK_WORDS, dtype=np.int64)
    runs = (("K4", K, lambda: pairing._dbl_run(*dev, n),
             lambda: pairing._dbl_run_plain(*dev, n)),
            ("K5", schedule.SQ, lambda: (pairing._sq_run(dev[0], n),),
             lambda: (pairing._sq_run_plain(dev[0], n),)))
    for label, table, kernel, plain in runs:
        got = kernel()
        torch.cuda.synchronize()
        if lib.phase_clock_read(clock.ctypes.data) != 0:
            raise RuntimeError("reading the phase clock failed")
        if not all(torch.equal(g, w) for g, w in zip(got, plain())):
            raise AssertionError(f"{label} != its plain version")
        phases = len(schedule.build(table).phases)
        per_step = clock[:n * phases].reshape(n, phases)[1:].mean(axis=0)
        print(f"{label} at B={B}" + (f", K={K}" if label == "K4" else "")
              + f", n={n}: {chip_smoke.cuda_ms(kernel):.4f} ms (CUDA events, "
              f"clock reads in), {per_step.sum():.0f} cycles a step in block 0; "
              "equal to the plain version", flush=True)
        print("\n".join(phase_lines(table, per_step)), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
