"""Batched SHA-256 for merkle layer hashing, in torch and CUDA.

Each merkle parent is SHA-256 over exactly 64 bytes (two child roots) —
one message block plus one constant padding block (reference semantics:
eth2spec/utils/hash_function.py:8; merkleize rules
ssz/simple-serialize.md:210-248).

Port of ``consensus_specs_tpu/ops/sha256_jax.py`` (``sha256_block64``,
``hash_blocks_u32``, ``hash_layer``) and of the Pallas kernel
``consensus_specs_tpu/ops/sha256_pallas.py`` (``_block64_t_impl``), which
becomes the hand-written CUDA kernel ``csrc/sha256.cu`` (K1; its bound and
design are noted in the source).

``sha256_block64`` is the one entry: on a CUDA tensor it launches K1 (or
raises), on a CPU tensor it runs ``sha256_block64_plain``, the plain torch
version of the same function.  The same library holds K2
(``csrc/sha256_tree.cu``), the merkle root of a packed uint64 list in one
launch up to 1,024 chunks, two up to 2^20 and three up to 2^30;
``launch_u64_list_root`` binds it, and
``ops/merkle_resident.packed_u64_root`` is its entry.  Every failure of
the kernels (no compiler, a failed build or load, a launch error, a pass
count off its plan) raises ``KernelError``, so that callers can tell it
from the errors of their own logic and let it through.
Words cross the kernel boundary as ``torch.int32`` tensors holding uint32
bit patterns; the plain version computes on int64 masked to 32 bits,
because torch on the CPU has no shift or add for uint32.  The conversions between the two are exact
(``to_int32_bits`` / ``from_int32_bits``).

Registered as the ``"torch"`` SSZ hashing backend:
``ssz.hashing.set_backend("torch", device=...)``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import List

import numpy as np
import torch

from consensus_specs_tpu_torch import _build

# SHA-256 round constants
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

# Message schedule of the constant second (padding) block for a 64-byte
# message: 0x80, zeros, 64-bit bit-length (512).
_PAD_BLOCK = np.zeros(16, dtype=np.uint32)
_PAD_BLOCK[0] = 0x80000000
_PAD_BLOCK[15] = 512

_MASK = 0xFFFFFFFF

# Work per message, for the kernel's bound (derivation in csrc/sha256.cu):
# 32-bit ALU operations, and bytes moved (64 read + 32 written).
OPS_PER_MESSAGE = 2 * 64 * 14 + 48 * 10 + 16
BYTES_PER_MESSAGE = 96

# Kernel launches, counted by the wrappers where they launch the kernels
# and nowhere else (a run shows the main path went through them): K1, and
# K2's passes (one or two a root at the main path's sizes)
counts = {"sha256_block64": 0, "u64_list_root": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class KernelError(RuntimeError):
    """K1 or K2 could not be built, loaded or launched, or failed on the
    device.  Never a reason to take another path: it is raised to the
    caller."""


# -- exact int32 <-> uint32-in-int64 conversion ------------------------------


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _MASK


# -- the plain torch version ---------------------------------------------------


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _MASK


def _schedule(w16) -> list:
    """Extend 16 message words to the 64-word schedule (tensors or ints)."""
    w = list(w16)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _MASK)
    return w


# K[i] + W_pad[i]: the padding block's schedule is the same for every message
_K_PAD = [(int(k) + w) & _MASK
          for k, w in zip(_K, _schedule(int(x) for x in _PAD_BLOCK))]


def _compress(state, kw) -> tuple:
    """One compression; ``kw[i]`` is K[i] + W[i] (tensor or int)."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + kw[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & _MASK, a, b, c,
                                  (d + t1) & _MASK, e, f, g)
    return tuple((x + y) & _MASK for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def sha256_block64_plain(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N 64-byte messages: [N, 16] int64 big-endian words in
    [0, 2^32) -> [N, 8] int64 digest words, on ``words``' device."""
    n = words.shape[0]
    init = tuple(torch.full((n,), int(h), dtype=torch.int64, device=words.device)
                 for h in _H0)
    w = _schedule(words[:, i] for i in range(16))
    mid = _compress(init, [int(k) + x for k, x in zip(_K, w)])
    return torch.stack(_compress(mid, _K_PAD), dim=1)


# -- K1 and K2: the CUDA kernels ------------------------------------------------

_CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# compiled into one library by one nvcc call
_CU_SOURCES = tuple(os.path.join(_CSRC_DIR, name)
                    for name in ("sha256.cu", "sha256_tree.cu"))
# everything the library is built from, the shared header included: the
# build digest covers all of it, so an edited header rebuilds
SOURCES = _CU_SOURCES + (os.path.join(_CSRC_DIR, "sha256_core.cuh"),)
_NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib = None


def _nvcc() -> str:
    local = "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc") or (local if os.path.exists(local) else None)
    if found is None:
        raise RuntimeError("nvcc not found: the SHA-256 kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def build_kernel() -> str:
    """Compile K1 and K2 with one nvcc call for sm_90a into the build
    directory (once per source digest) and return the library's path.  The
    compiler's report (registers, spills) is kept beside it as
    ``<library>.log``."""
    nvcc = _nvcc()
    return _build.build_shared(
        "sha256", SOURCES,
        lambda out: [nvcc, *_NVCC_FLAGS, *_CU_SOURCES, "-o", out],
        flags=_NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(build_kernel())
        except (OSError, RuntimeError) as exc:
            raise KernelError(f"the SHA-256 kernels are not available: "
                              f"{exc}") from exc
        lib.sha256_block64_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.sha256_block64_launch.restype = ctypes.c_int
        lib.u64_list_root_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.u64_list_root_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch_k1(words: torch.Tensor) -> torch.Tensor:
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    if words.data_ptr() % 16:
        raise ValueError("K1 needs a 16-byte aligned input")
    lib = _library()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    with torch.cuda.device(words.device):
        rc = lib.sha256_block64_launch(
            ctypes.c_void_p(words.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelError(f"K1 launch failed with CUDA error {rc}")
    counts["sha256_block64"] += 1
    return out


K2_LEAVES_PER_CTA = 1024  # kLeavesPerCta in csrc/sha256_tree.cu


def k2_plan(n_chunks: int) -> tuple:
    """(passes, scratch digests) of K2 for a 2^k-chunk tree: each pass
    reduces 1,024 leaves a CTA, and every pass but the last writes its CTA
    roots to scratch.  Sizes the scratch; the launcher reports the passes
    it ran, and the wrapper holds them to this plan."""
    passes, scratch, n = 1, 0, n_chunks
    while n > K2_LEAVES_PER_CTA:
        n //= K2_LEAVES_PER_CTA
        passes += 1
        scratch += n
    return passes, scratch


def launch_u64_list_root(values: torch.Tensor) -> torch.Tensor:
    """K2 on a contiguous, 16-byte aligned CUDA int64 tensor of 4 * 2^k
    values (the caller has checked that) -> [8] int32 root words.  One
    allocation holds the root and the passes' scratch; the launcher refuses
    a pass that would not fit in it."""
    if values.device.index != torch.cuda.current_device():
        with torch.cuda.device(values.device):
            return launch_u64_list_root(values)
    n_chunks = values.shape[0] // 4
    planned, scratch = k2_plan(n_chunks)
    buf = torch.empty(8 * (1 + scratch), dtype=torch.int32, device=values.device)
    passes = ctypes.c_int(0)
    rc = _library().u64_list_root_launch(
        values.data_ptr(), buf.data_ptr() + 32, scratch, buf.data_ptr(),
        n_chunks, torch.cuda.current_stream().cuda_stream, ctypes.byref(passes))
    counts["u64_list_root"] += passes.value
    if rc != 0:
        raise KernelError(f"K2 launch failed with CUDA error {rc} after "
                           f"{passes.value} passes")
    if passes.value != planned:
        raise KernelError(f"K2 ran {passes.value} passes for {n_chunks} "
                           f"chunks; its plan has {planned}")
    return buf[:8]


def sha256_block64(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N 64-byte messages: [N, 16] int32 (uint32 bit patterns of
    the big-endian words) -> [N, 8] int32 digest words, on ``words``'
    device.  CUDA launches K1; the CPU runs the plain version."""
    if words.dtype != torch.int32:
        raise TypeError(f"sha256_block64 takes int32 words, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != 16:
        raise ValueError(f"sha256_block64 takes [N, 16], got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("sha256_block64 takes a contiguous tensor")
    if words.device.type == "cuda":
        return _launch_k1(words)
    if words.device.type == "cpu":
        return to_int32_bits(sha256_block64_plain(from_int32_bits(words)))
    raise ValueError(f"sha256_block64 runs on cuda or cpu, not {words.device}")


# -- numpy / byte-level entries ------------------------------------------------


def hash_blocks_u32(words: np.ndarray, device) -> np.ndarray:
    """Hash [N,16] big-endian uint32 words to [N,8] digests (numpy in/out)
    on ``device``."""
    host = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    out = sha256_block64(torch.from_numpy(host).to(device))
    return out.cpu().numpy().view(np.uint32)


def hash_layer(blocks: List[bytes], device) -> List[bytes]:
    """Backend for ssz.hashing: list of 64-byte inputs -> 32-byte digests."""
    n = len(blocks)
    if n == 0:
        return []
    words = np.frombuffer(b"".join(blocks), dtype=">u4").reshape(n, 16).astype(np.uint32)
    flat = hash_blocks_u32(words, device).astype(">u4").tobytes()
    return [flat[i * 32:(i + 1) * 32] for i in range(n)]
