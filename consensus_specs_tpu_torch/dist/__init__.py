"""Cross-process execution fabric: a coordinator/worker process pool with
supervision, deadline/retry/hedge re-dispatch, and the process as a
first-class failure domain.

Port of ``consensus_specs_tpu/dist/``.  The workers are
``python -m consensus_specs_tpu_torch.dist.worker`` subprocesses whose
tensor work runs on the fabric's device (None: the CUDA card in each
worker).  The package supplies:

* ``codec``     — versioned length-framed messages over pipes, each frame
  wrapped in the ``persist/atomic.py`` digest envelope so a torn or
  corrupted reply is a DETECTED miss (``ArtifactCorrupt``), never garbage;
  a frame is the reference's byte for byte;
* ``worker``    — the subprocess body: executes task chunks, heartbeats
  from a side thread, inherits the coordinator's fault plan via env with
  per-process scope (``faults.py`` ``site[@nth][=kind][@procK]``);
* ``fabric``    — worker lifecycle: spawn, per-worker sender/reader
  threads, heartbeat bookkeeping, loss detection (EOF, corrupt frame,
  dead process), respawn for recovery probes;
* ``dispatch``  — deterministic chunk assignment with per-task deadlines
  (exponential backoff), hedged duplicate dispatch for stragglers
  (first-valid-reply wins, duplicates discarded by task id), re-dispatch
  of a dead/timed-out/corrupt-replying worker's chunks to survivors, and
  the degradation ladder: repeated fabric failures open a breaker that
  demotes runs to in-process execution with recovery probes — serving
  never halts;
* ``workloads`` — the chunked workloads themselves (BLS verification
  chunks, the pairing lanes' partial Miller products, the epoch balance
  slices, packed-uint64 subtree roots), each carrying its bit-identical
  in-process twin: the fixed merge order (chunk-index partial products,
  leftmost-failure minima, ordered slice concat) makes verdict and root
  parity hold at every failure schedule.
"""
from consensus_specs_tpu_torch.dist.dispatch import (  # noqa: F401
    FabricDown,
    FabricExecutor,
)
from consensus_specs_tpu_torch.dist.fabric import Fabric  # noqa: F401
