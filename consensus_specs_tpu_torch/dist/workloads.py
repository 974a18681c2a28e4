"""The chunkable workloads the fabric distributes, each carrying its
bit-identical in-process twin.

Port of ``consensus_specs_tpu/dist/workloads.py``.  Every workload here
has the same shape: split the work into contiguous chunks, ship one task
per chunk, merge replies in FIXED chunk-index order.  The merge
operations are exact (integer limb products, leftmost minima, ordered
concatenation, sha256 folds), so WHICH worker computed a chunk — and
whether it took one attempt or five — cannot perturb the result:
verdicts and roots are bit-identical to the in-process twin at every
failure schedule.

* ``batch_first_invalid`` — the verify lane: each worker runs
  ``stf/verify.first_invalid`` on its contiguous entry chunk (the SAME
  bisection the in-process path uses), the coordinator takes the minimum
  of ``chunk_offset + local_index`` — the same leftmost failing index
  the unchunked bisection names;
* ``pairing_lanes_check`` — the reference's fixed-merge-order pairing
  with PROCESSES as the chunk axis: identical chunking, padding,
  conjugated partial products (``ops/bls/pairing.lane_product``: K4 on
  the card, at most ``MAX_PAIRS`` pairs a launch), chunk-index merge, one
  final exponentiation on the coordinator's device;
* ``epoch_balances`` — registry-sharded epoch slices: every worker runs
  the full ``ops/epoch.attestation_deltas`` (global scalars ride
  precomputed in ``DeltaInputs``) on its device and returns its [lo, hi)
  rows; ordered concat;
* ``uint64_list_root`` — the subtree split with processes as shards:
  per-chunk sha256 subtree roots on the host, the same host fold
  (pairwise, zero-capped limit levels, length mixin).

Each takes a ``FabricExecutor`` and returns ``(value, mode)`` — mode is
``"fabric"`` or ``"inprocess"`` depending on where the ladder landed;
the value is the same either way.  The two that touch tensors take
``device=``: the in-process twin's and the coordinator's merge device,
None being the CUDA card (the workers' device is the fabric's).  A task's
deadline defaults to ``TASK_DEADLINE_S``, room for a worker's first
tensor task to import torch and reach its device.
"""
from __future__ import annotations

import hashlib
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from consensus_specs_tpu_torch.dist import dispatch
from consensus_specs_tpu_torch.dist.dispatch import FabricExecutor, TaskSpec

# a worker's first tensor task imports torch, creates the device context
# and loads the kernel libraries: seconds, more on a loaded host
TASK_DEADLINE_S = 300.0


def _opts(dispatch_opts: dict) -> dict:
    return {"deadline_s": TASK_DEADLINE_S, **dispatch_opts}


def _chunk_bounds(n: int, n_chunks: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) bounds, first chunks one longer on a ragged
    split — deterministic in (n, n_chunks) alone."""
    n_chunks = max(1, min(n_chunks, n))
    base, extra = divmod(n, n_chunks)
    bounds, lo = [], 0
    for i in range(n_chunks):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


# -- BLS verification lane: chunked leftmost-failure ---------------------------


def batch_first_invalid(executor: FabricExecutor, entries, seed=None,
                        n_chunks: int = 2, **dispatch_opts
                        ) -> Tuple[Optional[int], str]:
    """``stf/verify.first_invalid`` with the entry batch chunked over the
    fabric.  The in-process twin IS ``first_invalid``; the fabric path
    min-merges chunk-local indices — the same leftmost failure."""
    from consensus_specs_tpu_torch.stf import verify as stf_verify

    entries = list(entries)

    def inprocess():
        return stf_verify.first_invalid(entries, seed=seed)

    if not entries:
        return inprocess(), "inprocess"

    def on_fabric(fabric):
        bounds = _chunk_bounds(len(entries), n_chunks)
        tasks = [
            TaskSpec("verify_chunk", {},
                     pickle.dumps({"entries": entries[lo:hi], "seed": seed}))
            for lo, hi in bounds]
        replies = dispatch.run_tasks(fabric, tasks, **_opts(dispatch_opts))
        firsts = [
            lo + pickle.loads(body)["first"]
            for (lo, _), (_, body) in zip(bounds, replies)
            if pickle.loads(body)["first"] is not None]
        return min(firsts) if firsts else None

    return executor.run(on_fabric, inprocess)


# -- pairing lanes: one product, chunks over processes -------------------------


def _pairing_lane_chunks(pairs, n_chunks: int):
    """The EXACT chunk/pad layout of the reference's
    ``sharded_pairing_lanes_check`` with ``n_chunks`` as the device count:
    returns per-chunk (px, py, qx, qy) limb arrays of shape [C, 1, ...]
    (C lanes of one item), or None when the product is empty (vacuously
    1)."""
    from consensus_specs_tpu_torch.crypto.bls.curve import (
        g1_generator,
        g2_generator,
    )
    from consensus_specs_tpu_torch.ops.bls import _g1_coords, _g2_coords, limbs

    lanes = [(p, q) for p, q in pairs
             if not (p.is_infinity() or q.is_infinity())]
    if not lanes:
        return None
    D = n_chunks
    C = -(-len(lanes) // D)  # lanes per chunk
    m = C * D - len(lanes)
    if m == 1:
        # a single non-trivial pad lane cannot be the identity; widen so
        # the pad group cancels within itself (bls_sharded's rule)
        C += 1
        m += D
    if m:
        G, H = g1_generator(), g2_generator()
        lanes += [(G, H)] * (m - 1) + [(-G.mul(m - 1), H)]
    px = np.zeros((C, D, limbs.N_LIMBS), dtype=np.int64)
    py = np.zeros_like(px)
    qx = np.zeros((C, D, 2, limbs.N_LIMBS), dtype=np.int64)
    qy = np.zeros_like(qx)
    for l, (p, q) in enumerate(lanes):
        d, c = divmod(l, C)  # chunk d owns lanes [d*C, (d+1)*C)
        px[c, d], py[c, d] = _g1_coords(p)
        qx[c, d], qy[c, d] = _g2_coords(q)
    return [(px[:, d:d + 1], py[:, d:d + 1], qx[:, d:d + 1], qy[:, d:d + 1])
            for d in range(D)]


def chunk_partial(px, py, qx, qy, device) -> np.ndarray:
    """One chunk's conjugated Miller product on ``device``: int64
    ``[1, 6, 2, 16]`` on the host.  The worker's handler and the
    in-process twin both run this."""
    import torch

    from consensus_specs_tpu_torch._device import resolve_device, upload
    from consensus_specs_tpu_torch.ops.bls import pairing

    dev = resolve_device(device)
    with torch.inference_mode():
        f = pairing.lane_product(*(
            upload(np.ascontiguousarray(a, dtype=np.int64), dev)
            for a in (px, py, qx, qy)))
        return f.cpu().numpy()


def _merge_pairing_partials(partials: Sequence[np.ndarray], device) -> bool:
    """Fixed chunk-index merge + the single shared final exponentiation,
    on ``device``."""
    import torch

    from consensus_specs_tpu_torch._device import resolve_device, upload
    from consensus_specs_tpu_torch.ops.bls import pairing, tower

    dev = resolve_device(device)
    with torch.inference_mode():
        f = upload(np.asarray(partials[0][0], dtype=np.int64), dev)
        for d in range(1, len(partials)):
            f = tower.fq12_mul(
                f, upload(np.asarray(partials[d][0], dtype=np.int64), dev))
        return bool(pairing.final_exp_is_one(f[None])[0])


def pairing_tasks(chunks) -> List[TaskSpec]:
    """One ``pairing_partial`` task a chunk of ``_pairing_lane_chunks``."""
    return [TaskSpec("pairing_partial", {},
                     pickle.dumps({"px": px, "py": py, "qx": qx, "qy": qy}))
            for px, py, qx, qy in chunks]


def pairing_lanes_check(executor: FabricExecutor, pairs,
                        n_chunks: int = 2, device=None,
                        replies_out: Optional[list] = None,
                        **dispatch_opts) -> Tuple[bool, str]:
    """prod e(P_i, Q_i) == 1 with the lanes chunked over worker
    PROCESSES — the multi-process mirror of the reference's
    ``sharded_pairing_lanes_check``.  The in-process twin runs the same
    per-chunk partials on ``device``; exact limb arithmetic + fixed merge
    order make the two bit-identical regardless of chunk placement.  A
    ``replies_out`` list receives, from the fabric path, each chunk's
    ``(reply meta, partial)`` in chunk order (the meta names the worker
    and the kernel launches it made)."""
    chunks = _pairing_lane_chunks(pairs, n_chunks)
    if chunks is None:
        return True, "inprocess"  # empty product, both paths vacuous

    def inprocess():
        return _merge_pairing_partials(
            [chunk_partial(*c, device) for c in chunks], device)

    def on_fabric(fabric):
        replies = dispatch.run_tasks(fabric, pairing_tasks(chunks),
                                     **_opts(dispatch_opts))
        partials = [pickle.loads(body) for _, body in replies]
        if replies_out is not None:
            replies_out.extend(
                (meta, p) for (meta, _), p in zip(replies, partials))
        return _merge_pairing_partials(partials, device)

    return executor.run(on_fabric, inprocess)


# -- epoch kernel: registry-sharded balance slices -----------------------------


def balance_update(inp, balances: np.ndarray, device) -> np.ndarray:
    """balances + rewards - penalties, floored at 0, with the deltas of
    ``ops/epoch.attestation_deltas`` on ``device``: int64 numpy."""
    from consensus_specs_tpu_torch._device import resolve_device
    from consensus_specs_tpu_torch.ops.epoch import attestation_deltas

    rewards, penalties = attestation_deltas(inp, resolve_device(device))
    new = np.asarray(balances, dtype=np.int64) + rewards
    return np.where(penalties > new, 0, new - penalties)


def epoch_balances(executor: FabricExecutor, inp, balances: np.ndarray,
                   n_slices: int = 2, device=None, **dispatch_opts
                   ) -> Tuple[np.ndarray, str]:
    """The epoch balance update (rewards - penalties, floored at 0) with
    the registry sliced over workers.  Every worker runs the full
    ``attestation_deltas`` — the global reductions arrive precomputed
    inside ``DeltaInputs`` — and returns its [lo, hi) rows; the ordered
    concat is the in-process result by construction."""
    balances = np.asarray(balances, dtype=np.int64)

    def inprocess():
        return balance_update(inp, balances, device)

    def on_fabric(fabric):
        inp_dict = dict(inp._asdict())
        tasks = [
            TaskSpec("epoch_slice", {},
                     pickle.dumps({"inp": inp_dict, "balances": balances,
                                   "lo": lo, "hi": hi}))
            for lo, hi in _chunk_bounds(len(balances), n_slices)]
        replies = dispatch.run_tasks(fabric, tasks, **_opts(dispatch_opts))
        return np.concatenate([pickle.loads(body) for _, body in replies])

    return executor.run(on_fabric, inprocess)


# -- merkle: per-process subtree roots -----------------------------------------


def _subtree_root(lanes: np.ndarray) -> bytes:
    """Bottom-up sha256 subtree root of one packed-uint64 chunk, on the
    host (the worker handler runs this same reduction)."""
    data = b"".join(int(v).to_bytes(8, "little") for v in lanes)
    nodes = [data[i:i + 32] for i in range(0, len(data), 32)]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def _fold_subtree_roots(roots: List[bytes], n: int, n_pad: int,
                        limit: int) -> bytes:
    """The host fold: pairwise reduce the shard roots, zero-extend to the
    limit depth, mix in the length."""
    from consensus_specs_tpu_torch.ssz.hashing import sha256
    from consensus_specs_tpu_torch.ssz.node import ZERO_HASHES

    level = list(roots)
    while len(level) > 1:
        level = [sha256(level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
    node = level[0]
    chunks_hashed = n_pad // 4
    depth = (chunks_hashed - 1).bit_length()
    limit_chunks = (limit * 8 + 31) // 32
    limit_depth = max((limit_chunks - 1).bit_length(), 0)
    for d in range(depth, limit_depth):
        node = sha256(node + ZERO_HASHES[d])
    return sha256(node + n.to_bytes(8, "little") + b"\x00" * 24)


def uint64_list_root(executor: FabricExecutor, arr: np.ndarray, limit: int,
                     n_chunks: int = 2, **dispatch_opts
                     ) -> Tuple[bytes, str]:
    """``hash_tree_root(List[uint64, limit](arr))`` with the subtree
    split over worker processes.  ``n_chunks`` must be a power of two
    (the pairwise fold's assumption)."""
    assert n_chunks & (n_chunks - 1) == 0, (
        "uint64_list_root needs a power-of-two chunk count")
    arr = np.asarray(arr, dtype=np.int64)
    n = len(arr)
    per_shard = 8
    while per_shard * n_chunks < max(n, 1):
        per_shard *= 2
    n_pad = per_shard * n_chunks
    limit_chunks = (limit * 8 + 31) // 32
    if limit_chunks < n_pad // 4:
        # too small to fill the padded shards: the ssz host path is right
        # (and identical for both execution domains)
        from consensus_specs_tpu_torch.ssz.types import List as SSZList, uint64

        root = bytes(
            SSZList[uint64, limit]([int(x) for x in arr]).hash_tree_root())
        return root, "inprocess"
    padded = np.zeros(n_pad, dtype=np.int64)
    padded[:n] = arr
    shards = [padded[i * per_shard:(i + 1) * per_shard]
              for i in range(n_chunks)]

    def inprocess():
        return _fold_subtree_roots(
            [_subtree_root(s) for s in shards], n, n_pad, limit)

    def on_fabric(fabric):
        tasks = [TaskSpec("merkle_subtree", {},
                          pickle.dumps({"lanes": s})) for s in shards]
        replies = dispatch.run_tasks(fabric, tasks, **_opts(dispatch_opts))
        return _fold_subtree_roots(
            [body for _, body in replies], n, n_pad, limit)

    return executor.run(on_fabric, inprocess)
