"""Content-addressed on-disk checkpoint store.

A checkpoint is one atomic artifact capturing the node's fork-choice
world at a journal position: the finalized anchor (block + post-state),
the since-finality window of blocks and post-states descending from it,
and the store extras a byte-identical resume needs (clock, checkpoints,
proposer boost, latest messages, equivocating set).  ``recover_node``
restores the newest valid checkpoint and replays only the journal
suffix — crash recovery drops from O(history) to O(since-last-epoch-
fence) — with journal replay as the unconditional fallback when every
artifact is damaged or stale.

**Serialization: root-deduped merkle subtrees.**  The states are NOT
re-encoded as flat SSZ (decoding a 400k-validator registry element by
element is exactly the ``state_build_s`` cost this store exists to
skip).  Instead the backing tree serializes directly, deduplicated by
memoized node root: every unique subtree is emitted once and referenced
thereafter, so the window's states — which share almost everything
structurally — cost one anchor tree plus per-block deltas, and packed
columns (balances, participation) ride as raw bytes that come back as
lazily-materializing ``PackedLazySubtree``s with their roots installed.
Rebuild is O(unique subtrees): caches (resident columns, device
buffers, plan memos) are NOT persisted — they are root-keyed and
rebuild lazily and honestly on first read.

**Corruption-degradation ladder** (the native-BLS ladder's disk twin):
a truncated, bit-flipped, or stale-tagged artifact fails the atomic
layer's digest/tag verification at load, is counted
(``store_corruptions``), flight-recorded (``store_corrupt``),
quarantined on disk (``<file>.corrupt``), and recovery moves to the
next-newest candidate — exhausting them all falls back to full journal
replay.  No path serves a wrong state; parity is asserted byte-exactly
in the bench row and the chaos suite either way.

**Bounds.**  The store keeps at most ``cap`` checkpoints on disk and
prunes the oldest as finalization advances (the epoch fence in
node/service.py drives the cadence); depth-vs-cap and bytes-on-disk ride
the ``persist`` telemetry provider, joined to soak's cap-flatness
samples.
"""
from __future__ import annotations

import json
import mmap
import os
import threading
import weakref
from hashlib import sha256
from typing import Dict, List, NamedTuple, Optional, Tuple

from consensus_specs_tpu_torch import telemetry
from consensus_specs_tpu_torch.ssz.node import (
    BranchNode,
    LeafNode,
    Node,
    PackedLazySubtree,
    branch_with_root,
    zero_node,
)
from consensus_specs_tpu_torch.ssz.hashing import ZERO_HASHES
from consensus_specs_tpu_torch.stf import staging
from consensus_specs_tpu_torch.telemetry import recorder

from . import atomic

CHECKPOINT_KIND = "node-checkpoint"
# format/ABI tag of the checkpoint payload layout: bump on any codec or
# section change so an old artifact degrades to a stale-tag miss, never
# a misparse
FORMAT_TAG = "ckpt-v1"

DEFAULT_CAP = 3

stats = {
    "checkpoints_written": 0,
    "checkpoints_restored": 0,
    "write_failures": 0,
    "corruptions": 0,       # damaged artifacts seen at load (quarantined)
    "stale_artifacts": 0,   # intact artifacts from a foreign format/journal
    "restore_fallbacks": 0,  # recoveries that fell back to journal replay
    "pruned": 0,
    "bytes_written": 0,
}

_LIVE: Optional[weakref.ref] = None  # most recent store, for the gauges

# the in-memory index over every checkpoint artifact this process knows
# (absolute path -> {journal_pos, bytes}), module-wide like the engines'
# stats so two stores over one directory agree.  Analyzer-registered
# (CC01 "persist checkpoint index"; EF01 inherits): inserts happen only
# through ``_index_put`` here — riding the cache-transaction protocol —
# and quarantining/pruning an entry is the registered legal invalidation
_INDEX: Dict[str, dict] = {}
_INDEX_LOCK = threading.Lock()

# set (thread-local) inside the background writer: staging's block
# transaction is a process-global owned by the single-writer apply
# thread, so a note_insert from the writer thread would land a DURABLE
# artifact's index entry in some unrelated in-flight block's undo log —
# that block's routine rollback would then delete the entry of a
# checkpoint that IS on disk.  The transactional ride applies only to
# same-thread (synchronous) writes, where an enclosing transaction is
# genuinely the caller's own.
_WRITER_THREAD = threading.local()


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def reset_index() -> None:
    """Drop every index entry (test isolation; the artifacts on disk are
    untouched — a fresh store re-adopts them by scanning)."""
    with _INDEX_LOCK:
        _INDEX.clear()


def _index_put(path: str, meta: dict) -> None:
    with _INDEX_LOCK:
        _INDEX[path] = meta
    if not getattr(_WRITER_THREAD, "active", False):
        # thread-safe: the _WRITER_THREAD.active flag above gates this
        # off the background writer — only same-thread (synchronous)
        # callers ride the apply thread's own open transaction
        staging.note_insert(_INDEX, path)


def _index_pop(path: str) -> None:
    with _INDEX_LOCK:
        _INDEX.pop(path, None)


def _index_under(directory: str) -> Dict[str, dict]:
    prefix = os.path.join(os.path.abspath(directory), "")
    with _INDEX_LOCK:
        return {p: dict(m) for p, m in _INDEX.items()
                if p.startswith(prefix)}


def _telemetry_provider() -> dict:
    out = dict(stats)
    live = _LIVE() if _LIVE is not None else None
    # size/cap spelling matches the other bounded stores so soak's
    # cap-flatness sweep picks the store up like any ring
    out["size"] = live.depth() if live is not None else 0
    out["cap"] = live.cap if live is not None else DEFAULT_CAP
    out["bytes_on_disk"] = live.bytes_on_disk() if live is not None else 0
    return out


telemetry.register_provider("persist", _telemetry_provider, replace=True)


class CheckpointError(Exception):
    """One candidate checkpoint is unusable (corrupt, stale, or from a
    different journal).  Recovery's ladder catches this and moves on."""


# -- merkle tree codec ---------------------------------------------------------

_TAG_LEAF = 0x01
_TAG_ZERO = 0x02
_TAG_PACKED = 0x03
_TAG_BRANCH = 0x04
_TAG_REF = 0x05

# zero-subtree roots -> depth, BRANCH depths only (a 32-zero-byte leaf
# is just a leaf): emitted as one-byte-depth Z records so a mostly-empty
# registry tail costs nothing
_ZERO_DEPTH = {ZERO_HASHES[d]: d for d in range(1, 64)}


def _host_root(node: Node) -> bytes:
    """``node``'s root by hashlib, memoized on every node below it that
    had none.  Plain hashlib, whatever the SSZ hashing backend: the wave
    route parks integers in ``_root`` while it runs, which a thread other
    than the one hashing must never see."""
    if node._root is None:
        node._root = sha256(
            _host_root(node.left) + _host_root(node.right)).digest()
    return node._root


def encode_tree(node: Node, out: bytearray, index: Dict[tuple, int]) -> None:
    """Append ``node``'s serialization to ``out``, deduplicating by
    memoized root across everything already emitted under ``index``
    (shared across trees: window states dedup against each other).
    The dedup key carries the node's leaf/branch shape alongside the
    root: a LEAF whose 32 content bytes happen to equal some subtree's
    digest (``genesis_validators_root`` literally stores the genesis
    registry's root) must never alias that subtree.  Callers hash the
    view first; the walk never materializes a ``PackedLazySubtree``'s
    children.  One case still meets a node with no root: a subtree under
    a root the device computed (the fused epoch update and the resident
    slot root memoize only the balances list's contents root, so its
    interior was never hashed on the host).  ``_host_root`` hashes that
    subtree here, once, and memoizes its roots; a reader on another
    thread sees either no root or the right one.  The bytes written are
    those of the host-hashed state."""
    root = node._root
    if root is None:
        root = _host_root(node)
    is_leaf = not isinstance(node, BranchNode)
    key = (is_leaf, bytes(root))
    ref = index.get(key)
    if ref is not None:
        out.append(_TAG_REF)
        out += ref.to_bytes(4, "little")
        return
    index[key] = len(index)
    if is_leaf:
        out.append(_TAG_LEAF)
        out += key[1]  # a leaf's root IS its 32 content bytes
        return
    depth = _ZERO_DEPTH.get(key[1])
    if depth is not None:
        out.append(_TAG_ZERO)
        out.append(depth)
        return
    if isinstance(node, PackedLazySubtree):
        out.append(_TAG_PACKED)
        out.append(node._depth)
        data = node._data
        out += len(data).to_bytes(8, "little")
        out += data
        out += key[1]
        return
    out.append(_TAG_BRANCH)
    out += key[1]
    encode_tree(node.left, out, index)
    encode_tree(node.right, out, index)


def decode_tree(buf, off: int, nodes: List[Optional[Node]]) -> Tuple[Node, int]:
    """Decode one tree from ``buf`` at ``off``; ``nodes`` is the shared
    ref table (same emission order as ``encode_tree``'s index).  Roots
    install from the stream — integrity is the artifact digest's job —
    so a restored state's ``hash_tree_root`` is a field read, and packed
    subtrees come back lazy (children materialize on first descent)."""
    tag = buf[off]
    off += 1
    if tag == _TAG_REF:
        ref = int.from_bytes(buf[off:off + 4], "little")
        node = nodes[ref]
        if node is None:
            raise CheckpointError(f"forward tree ref {ref}")
        return node, off + 4
    slot = len(nodes)
    nodes.append(None)
    if tag == _TAG_ZERO:
        node = zero_node(buf[off])
        off += 1
    elif tag == _TAG_LEAF:
        node = LeafNode(bytes(buf[off:off + 32]))
        off += 32
    elif tag == _TAG_PACKED:
        depth = buf[off]
        n = int.from_bytes(buf[off + 1:off + 9], "little")
        off += 9
        data = bytes(buf[off:off + n])
        off += n
        root = bytes(buf[off:off + 32])
        off += 32
        node = PackedLazySubtree(data, depth, root)
    elif tag == _TAG_BRANCH:
        root = bytes(buf[off:off + 32])
        off += 32
        left, off = decode_tree(buf, off, nodes)
        right, off = decode_tree(buf, off, nodes)
        node = branch_with_root(left, right, root)
    else:
        raise CheckpointError(f"unknown tree tag {tag:#x} at {off - 1}")
    nodes[slot] = node
    return node, off


# -- checkpoint payload --------------------------------------------------------


class CheckpointPayload(NamedTuple):
    """What the apply loop gathers under the single-writer lock — cheap
    references and shallow copies of immutable structures; the expensive
    serialization happens on the store's writer thread."""

    journal_pos: int                    # journal prefix this covers
    trigger: tuple                      # token of journal[pos-1]
    time: int
    justified: Tuple[int, bytes]
    best_justified: Tuple[int, bytes]
    finalized: Tuple[int, bytes]
    proposer_boost_root: bytes
    latest_messages: dict               # ValidatorIndex -> LatestMessage
    equivocating: frozenset
    anchor_root: bytes
    window: tuple                       # ((root, block, state), ...) slot order
    head_state_root: bytes              # content address (newest window state)
    # (position, root-hex) of the newest "block" journal entry in the
    # covered prefix: the content-bound anchor recovery verifies before
    # trusting that this checkpoint belongs to a given journal (the
    # trigger token alone would collide for tick entries, whose times
    # repeat across any two runs on the same slot schedule)
    last_block: Optional[tuple] = None


class RestoredCheckpoint(NamedTuple):
    journal_pos: int
    trigger: tuple
    meta: dict
    blocks: dict                        # root bytes -> BeaconBlock
    states: dict                        # root bytes -> BeaconState
    anchor_root: bytes

    def as_store(self, spec):
        """A spec-true ``Store`` resumed at the checkpoint's journal
        position: anchor through the spec's own constructor, then the
        window and extras installed verbatim.  ``ForkChoiceEngine``'s
        warm-store path does the rest (proto inserts, vote seeding,
        justified refresh, finalized prune)."""
        m = self.meta
        anchor_block = self.blocks[self.anchor_root]
        anchor_state = self.states[self.anchor_root]
        store = spec.get_forkchoice_store(anchor_state, anchor_block)
        store.time = spec.uint64(m["time"])
        store.justified_checkpoint = _checkpoint(spec, m["justified"])
        store.best_justified_checkpoint = _checkpoint(
            spec, m["best_justified"])
        store.finalized_checkpoint = _checkpoint(spec, m["finalized"])
        store.proposer_boost_root = spec.Root(bytes.fromhex(
            m["proposer_boost_root"]))
        # plain ints/bytes inside the rebuilt vote state: the spec types
        # are value-equal and hash-equal (uint64 IS int, Root IS bytes),
        # and at mainnet registry sizes constructing hundreds of
        # thousands of typed wrappers costs seconds the restore path
        # exists to save — the fold, the proto seeding, and the parity
        # compares all operate by value
        store.equivocating_indices = set(m["equivocating"])
        for root, block in self.blocks.items():
            if root == self.anchor_root:
                continue
            store.blocks[spec.Root(root)] = block
            store.block_states[spec.Root(root)] = self.states[root]
        LatestMessage = spec.LatestMessage
        store.latest_messages = {
            i: LatestMessage(epoch=e, root=r)
            for i, e, r in m["latest_messages"]}
        # the synthetic anchor-epoch checkpoint state the spec
        # constructor seeded is not part of the resumed world; the
        # engine re-materializes the justified state the spec's own way
        store.checkpoint_states.clear()
        return store


def _checkpoint(spec, pair):
    epoch, root = pair
    return spec.Checkpoint(epoch=spec.Epoch(epoch),
                           root=spec.Root(bytes.fromhex(root)))


def serialize_checkpoint(payload: CheckpointPayload) -> bytes:
    """The artifact payload: a small JSON meta section (audit-friendly),
    a PACKED latest-message table (hundreds of thousands of entries at
    mainnet registry sizes — (u64 index, u64 epoch, 32-byte root)
    records, not JSON), the equivocating set, the window's SSZ block
    bytes, and ONE root-deduped tree stream covering every window
    state."""
    meta = {
        "journal_pos": payload.journal_pos,
        "trigger": list(_jsonable(payload.trigger)),
        "time": payload.time,
        "justified": [payload.justified[0], payload.justified[1].hex()],
        "best_justified": [payload.best_justified[0],
                           payload.best_justified[1].hex()],
        "finalized": [payload.finalized[0], payload.finalized[1].hex()],
        "proposer_boost_root": payload.proposer_boost_root.hex(),
        "anchor_root": payload.anchor_root.hex(),
        "head_state_root": payload.head_state_root.hex(),
        "window": [root.hex() for root, _b, _s in payload.window],
        "last_block": (list(payload.last_block)
                       if payload.last_block else None),
    }
    out = bytearray()
    meta_raw = json.dumps(meta, sort_keys=True).encode()
    out += len(meta_raw).to_bytes(4, "little")
    out += meta_raw
    eq = sorted(int(i) for i in payload.equivocating)
    out += len(eq).to_bytes(4, "little")
    for i in eq:
        out += i.to_bytes(8, "little")
    lm = payload.latest_messages
    out += len(lm).to_bytes(4, "little")
    for i in sorted(lm, key=int):
        msg = lm[i]
        out += int(i).to_bytes(8, "little")
        out += int(msg.epoch).to_bytes(8, "little")
        out += bytes(msg.root)
    for _root, block, _state in payload.window:
        enc = block.encode_bytes()
        out += len(enc).to_bytes(4, "little")
        out += enc
    index: Dict[tuple, int] = {}
    for _root, _block, state in payload.window:
        encode_tree(state.get_backing(), out, index)
    return bytes(out)


def deserialize_checkpoint(spec, payload) -> RestoredCheckpoint:
    """Inverse of ``serialize_checkpoint``; raises ``CheckpointError``
    on any structural surprise (the digest already passed, so a failure
    here means a format drift the tag should have caught — treated as
    one more rung of the ladder, never a crash)."""
    try:
        off = 0
        n = int.from_bytes(payload[off:off + 4], "little")
        off += 4
        meta = json.loads(bytes(payload[off:off + n]).decode())
        off += n
        n_eq = int.from_bytes(payload[off:off + 4], "little")
        off += 4
        equivocating = [
            int.from_bytes(payload[off + 8 * k:off + 8 * k + 8], "little")
            for k in range(n_eq)]
        off += 8 * n_eq
        n_lm = int.from_bytes(payload[off:off + 4], "little")
        off += 4
        # hundreds of thousands of records at mainnet sizes: one
        # struct pass, not a per-entry slicing loop
        import struct

        latest = list(struct.iter_unpack(
            "<QQ32s", payload[off:off + 48 * n_lm]))
        off += 48 * n_lm
        meta["equivocating"] = equivocating
        meta["latest_messages"] = latest
        roots = [bytes.fromhex(h) for h in meta["window"]]
        blocks: dict = {}
        for root in roots:
            n = int.from_bytes(payload[off:off + 4], "little")
            off += 4
            blocks[root] = spec.BeaconBlock.decode_bytes(
                bytes(payload[off:off + n]))
            off += n
        nodes: List[Optional[Node]] = []
        states: dict = {}
        for root in roots:
            backing, off = decode_tree(payload, off, nodes)
            states[root] = spec.BeaconState.view_from_backing(backing)
        anchor_root = bytes.fromhex(meta["anchor_root"])
        if anchor_root not in blocks:
            raise CheckpointError("anchor root missing from the window")
        # the content address must agree with what the tree stream
        # rebuilt (roots are memoized from the stream; the whole-file
        # digest vouches for the bytes, this cross-check vouches the
        # sections belong together)
        head_root = bytes(states[roots[-1]].hash_tree_root())
        if head_root != bytes.fromhex(meta["head_state_root"]):
            raise CheckpointError("head state root mismatch")
        for root in roots:
            if bytes(blocks[root].state_root) != bytes(
                    states[root].hash_tree_root()):
                raise CheckpointError("block/state pairing mismatch")
        return RestoredCheckpoint(
            journal_pos=int(meta["journal_pos"]),
            trigger=tuple(meta["trigger"]),
            meta=meta, blocks=blocks, states=states,
            anchor_root=anchor_root)
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(f"malformed checkpoint payload: {exc!r}")


def _jsonable(token: tuple):
    return tuple(t.hex() if isinstance(t, (bytes, bytearray)) else t
                 for t in token)


# -- the store -----------------------------------------------------------------


class CheckpointStore:
    """Bounded directory of checkpoint artifacts over the module-wide
    in-memory index (``_INDEX``, analyzer-registered): the write path,
    the prune policy, and the restore ladder for one base directory."""

    def __init__(self, base_dir: str, cap: int = DEFAULT_CAP,
                 asynchronous: bool = True):
        if cap < 1:
            raise ValueError(f"checkpoint cap must be >= 1, got {cap}")
        self._dir = os.path.abspath(base_dir)
        self._cap = cap
        self._async = asynchronous
        self._cond = threading.Condition()
        self._pending: Optional[tuple] = None  # newest-wins depth-1 queue
        self._busy = False
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        os.makedirs(self._dir, exist_ok=True)
        self._scan()
        global _LIVE
        _LIVE = weakref.ref(self)

    # -- index ---------------------------------------------------------------

    def _scan(self) -> None:
        """Adopt artifacts already on disk (a restarted process resumes
        the crashed one's store) and drop index entries whose files are
        gone.  Validity is judged at restore time — the scan only needs
        the ordering key from the filename."""
        for path in list(_index_under(self._dir)):
            if not os.path.exists(path):
                _index_pop(path)
        for name in os.listdir(self._dir):
            if not (name.startswith("ckpt_") and name.endswith(".bin")):
                continue
            try:
                pos = int(name.split("_")[1])
            except (IndexError, ValueError):
                continue
            path = os.path.join(self._dir, name)
            _index_put(path, {"journal_pos": pos,
                              "bytes": _size_of(path)})

    def depth(self) -> int:
        return len(_index_under(self._dir))

    @property
    def cap(self) -> int:
        return self._cap

    @property
    def directory(self) -> str:
        return self._dir

    def bytes_on_disk(self) -> int:
        return sum(m.get("bytes", 0)
                   for m in _index_under(self._dir).values())

    def candidates(self) -> List[str]:
        """Checkpoint paths newest-first (by covered journal prefix) —
        the restore ladder's probe order."""
        entries = _index_under(self._dir)
        return sorted(entries,
                      key=lambda p: entries[p]["journal_pos"],
                      reverse=True)

    def entries(self) -> Dict[str, dict]:
        """Index snapshot for this directory (path -> {journal_pos,
        bytes}) — introspection for bench rows and tests."""
        return _index_under(self._dir)

    # -- writes --------------------------------------------------------------

    def submit(self, spec, payload: CheckpointPayload) -> None:
        """Hand one gathered checkpoint to the store.  Asynchronous mode
        (the default) enqueues for the writer thread — the apply loop
        returns immediately and a newer checkpoint arriving before the
        write starts simply replaces the pending one (newest wins; the
        skipped one is strictly dominated).  Synchronous mode (tests,
        chaos determinism) writes inline and lets failures surface to
        the caller's containment."""
        if not self._async:
            self.write_checkpoint(spec, payload)
            return
        with self._cond:
            if self._closed:
                raise RuntimeError("submit on a closed CheckpointStore")
            self._pending = (spec, payload)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, name="cstpu-ckpt-writer", daemon=True)
                self._worker.start()
            self._cond.notify_all()

    def _drain(self) -> None:
        _WRITER_THREAD.active = True
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                spec, payload = self._pending
                self._pending = None
                self._busy = True
            try:
                self.write_checkpoint(spec, payload)
            except Exception:
                # already counted; the writer thread must survive to
                # take the next epoch's checkpoint
                pass
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def flush(self, timeout: Optional[float] = 30.0) -> bool:
        """Wait until no write is pending or in flight (bench/tests)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._pending is None and not self._busy, timeout)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30.0)

    def _path_for(self, payload: CheckpointPayload) -> str:
        return os.path.join(
            self._dir,
            f"ckpt_{payload.journal_pos:012d}_"
            f"{payload.head_state_root.hex()[:16]}.bin")

    def write_checkpoint(self, spec, payload: CheckpointPayload) -> str:
        """Serialize + atomically persist one checkpoint, index it, and
        prune past the cap.  Any failure counts ``write_failures`` and
        re-raises; the atomic layer guarantees no torn final and no
        stray temp either way."""
        path = self._path_for(payload)
        try:
            raw = serialize_checkpoint(payload)
            size = atomic.write_artifact(
                path, raw, CHECKPOINT_KIND, FORMAT_TAG)
        except Exception:
            stats["write_failures"] += 1
            raise
        _index_put(path, {"journal_pos": payload.journal_pos,
                          "bytes": size})
        stats["checkpoints_written"] += 1
        stats["bytes_written"] += size
        self.prune()
        recorder.record("checkpoint_written",
                        journal_pos=payload.journal_pos,
                        epoch=payload.finalized[0],
                        bytes=size,
                        root=payload.head_state_root.hex()[:16])
        return path

    def prune(self) -> int:
        """Drop the oldest checkpoints past the cap (finalization
        advanced; the newer artifacts strictly dominate them)."""
        victims = self.candidates()[self._cap:]
        for path in victims:
            _index_pop(path)
            try:
                os.unlink(path)
            except OSError:
                pass
            stats["pruned"] += 1
        return len(victims)

    # -- restore (the corruption ladder) -------------------------------------

    def restore(self, spec, path: str) -> RestoredCheckpoint:
        """Load + verify one candidate.  A damaged artifact is counted,
        flight-recorded, quarantined on disk (its index entry
        invalidated), and surfaces as ``CheckpointError`` so the
        recovery ladder moves to the next candidate; a stale tag is
        counted separately (it is a format miss, not damage) but walks
        the same ladder."""
        try:
            payload = self._read_mmap(path)
            restored = deserialize_checkpoint(spec, payload)
        except atomic.ArtifactMissing as exc:
            # a vanished candidate (out-of-band cleanup, another process
            # pruning a shared directory) is a plain miss, NOT damage:
            # no corruption counter, nothing to quarantine — just drop
            # the index entry and let the ladder move on
            _index_pop(path)
            raise CheckpointError(str(exc)) from None
        except atomic.ArtifactStaleTag as exc:
            stats["stale_artifacts"] += 1
            self._quarantine(path, "stale_tag", exc)
            raise CheckpointError(str(exc)) from None
        except Exception as exc:
            # ArtifactCorrupt/CheckpointError are the expected rungs; an
            # UNEXPECTED reader failure (an OSError flavor, the digest
            # machinery itself dying — chaos' persist.digest probe) is
            # still disk trouble the node must survive: same rung, the
            # ladder moves on, never a crash out of recovery
            stats["corruptions"] += 1
            self._quarantine(path, "corrupt", exc)
            raise CheckpointError(repr(exc)) from None
        stats["checkpoints_restored"] += 1
        return restored

    def _read_mmap(self, path: str) -> bytes:
        """The artifact payload via an mmap-backed read: the digest pass
        streams over the mapped pages (no heap copy of the multi-MB
        artifact during verification); only the verified payload is
        sliced out for the tree decode."""
        try:
            with open(path, "rb") as f:
                try:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                except (ValueError, OSError):
                    # zero-length or unmappable file: the plain read
                    # path produces the same ladder verdicts
                    return atomic.read_artifact(
                        path, CHECKPOINT_KIND, FORMAT_TAG)
                with mm:
                    return atomic.verify_buffer(
                        path, mm, CHECKPOINT_KIND, FORMAT_TAG)
        except FileNotFoundError:
            raise atomic.ArtifactMissing(path) from None

    # -- serving read path ----------------------------------------

    def map_payload(self, path: str) -> "MappedPayload":
        """Open one candidate for SERVING: mmap the artifact, verify the
        envelope (digest pass streams over the mapped pages), and return
        a handle exposing the payload bounds without copying it — the
        query engine walks tree-stream offsets straight off the map.
        Failures ride the exact restore ladder: missing is a plain miss,
        a stale tag or damage is counted, flight-recorded, quarantined,
        and surfaces as ``CheckpointError`` so the caller moves to the
        next candidate."""
        mapped = None
        try:
            mapped = self._map_verified(path)
        except atomic.ArtifactMissing as exc:
            _index_pop(path)
            raise CheckpointError(str(exc)) from None
        except atomic.ArtifactStaleTag as exc:
            stats["stale_artifacts"] += 1
            self._quarantine(path, "stale_tag", exc)
            raise CheckpointError(str(exc)) from None
        except Exception as exc:
            stats["corruptions"] += 1
            self._quarantine(path, "corrupt", exc)
            raise CheckpointError(repr(exc)) from None
        return mapped

    def discard_corrupt(self, path: str, exc: Exception) -> None:
        """A reader that discovered damage PAST envelope verification
        (a malformed section mid-query) hands the artifact back here:
        same ladder accounting as a load-time failure — counted,
        flight-recorded, quarantined, index entry invalidated."""
        stats["corruptions"] += 1
        self._quarantine(path, "corrupt", exc)

    def _map_verified(self, path: str) -> "MappedPayload":
        f = mm = None
        try:
            f = open(path, "rb")
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                buf = mm
            except (ValueError, OSError):
                # zero-length or unmappable file: fall back to a plain
                # read — same ladder verdicts, just not zero-copy
                f.seek(0)
                buf = f.read()
            used, start, stop = atomic.payload_bounds(
                path, buf, CHECKPOINT_KIND, FORMAT_TAG)
            if used is not buf and mm is not None:
                # an armed fault plan materialized the buffer; the map
                # itself is no longer referenced
                mm.close()
                mm = None
            if mm is None:
                f.close()
                f = None
            return MappedPayload(used, start, stop, mm=mm, fobj=f)
        except FileNotFoundError:
            raise atomic.ArtifactMissing(path) from None
        except BaseException:
            if mm is not None:
                mm.close()
            if f is not None:
                f.close()
            raise

    def _quarantine(self, path: str, reason: str, exc: Exception) -> None:
        dest = atomic.quarantine(path)
        # a corrupt entry leaves the index (the registered legal
        # invalidation): candidates() never offers it again
        _index_pop(path)
        recorder.record("store_corrupt", path=os.path.basename(path),
                        reason=reason, detail=repr(exc)[:160],
                        quarantined=bool(dest))


class MappedPayload:
    """A verified, servable artifact payload: ``buf[start:stop]`` is the
    checkpoint payload, backed by the live mmap when the platform allows
    (else a plain read's bytes).  The owner (the query engine's artifact
    index) holds it open across queries and ``close()``s on eviction."""

    __slots__ = ("buf", "start", "stop", "_mm", "_fobj")

    def __init__(self, buf, start: int, stop: int, mm=None, fobj=None):
        self.buf, self.start, self.stop = buf, start, stop
        self._mm, self._fobj = mm, fobj

    @property
    def nbytes(self) -> int:
        return self.stop - self.start

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fobj is not None:
            self._fobj.close()
            self._fobj = None
        self.buf = b""
        self.start = self.stop = 0


def _size_of(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0
