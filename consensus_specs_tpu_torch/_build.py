"""Build native sources into the port's build directory.

Compiled artifacts (the host BLS library, the CUDA kernels) go to
``<package>/.build/``, named by a digest of their sources so an edited
source rebuilds and a concurrent builder converges on the same file.
The directory is listed in ``.gitignore``: a fresh checkout builds at
first use.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build")


def source_digest(paths: Sequence[str], flags: Sequence[str] = ()) -> str:
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def build_shared(stem: str, sources: Sequence[str],
                 command: Callable[[str], Sequence[str]],
                 flags: Sequence[str] = (), timeout: float = 600) -> str:
    """Path of ``<stem>_<digest>.so`` in the build directory, compiling it
    first when absent.  ``command(out_path)`` is the compiler invocation;
    its output lands under a temporary name and is renamed into place, so
    a reader never sees a half-written library.  The compiler's report is
    kept beside the library as ``<library>.log``.  Raises ``OSError`` when
    the compiler cannot run or fails (with the end of its stderr)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(
        BUILD_DIR, f"{stem}_{source_digest(sources, flags)}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(list(command(tmp_path)), capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise OSError(f"{stem} build failed:\n{proc.stderr[-2000:]}")
        with open(so_path + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        os.replace(tmp_path, so_path)
    except subprocess.TimeoutExpired as exc:
        raise OSError(f"{stem} build timed out: {exc}") from exc
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return so_path


# one nvcc call builds one library of sm_90a kernels with a plain C
# interface; -Xptxas -v puts each kernel's registers and spills in its log
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    local = "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc") or (local if os.path.exists(local) else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def build_cuda(stem: str, cu_sources: Sequence[str],
               headers: Sequence[str] = ()) -> str:
    """``build_shared`` for CUDA sources: one nvcc call for sm_90a compiles
    ``cu_sources`` into one library, rebuilt when a source or one of the
    ``headers`` changes."""
    compiler = nvcc()
    return build_shared(
        stem, tuple(cu_sources) + tuple(headers),
        lambda out: [compiler, *NVCC_FLAGS, *cu_sources, "-o", out],
        flags=NVCC_FLAGS)
