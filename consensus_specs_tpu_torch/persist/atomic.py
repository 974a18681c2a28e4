"""Atomic durable artifacts: one torn-write-safe write path for the tree.

Every durable byte the port writes — node checkpoints, cold-start
state snapshots — must survive the same three failure shapes:

* **torn writes** — a process killed mid-write must never leave a final
  path holding half an artifact.  Writes go to a uniquely-named temp
  file (``tempfile.mkstemp`` in the destination directory) promoted with
  ``os.replace``: concurrent writers each own their temp, the rename is
  atomic, and a reader can never observe a partial file.  Any failure
  before the promotion unlinks the temp — no strays.

* **bit rot / disk damage** — every artifact carries a trailing SHA-256
  over everything before it.  A flipped byte anywhere (header, payload,
  even the digest itself) fails verification at load and surfaces as
  ``ArtifactCorrupt`` — never as garbage fed to a consumer.

* **stale formats** — the header binds a ``kind`` (what the artifact is)
  and a caller-supplied ``tag`` (format version + host ABI, e.g. the
  checkpoint codec's generation).  An artifact written by an
  older layout or a foreign host fails the tag compare and surfaces as
  ``ArtifactStaleTag`` — a cache miss, not garbage input.

Layout::

    MAGIC(4) | u16 version | u16 len(kind) | kind | u16 len(tag) | tag
    | u64 len(payload) | payload | sha256(everything before)

The ``persist.{write,replace,read,digest}`` fault sites instrument the
four seams (tests/test_torch_persist.py): an injected failure
mid-write leaves no torn final and no stray temp; injected read/digest
corruption is detected and flows into the caller's degradation ladder.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Tuple

from consensus_specs_tpu_torch import faults

MAGIC = b"CSTP"
FORMAT_VERSION = 1
_HDR_FIXED = len(MAGIC) + 2  # magic + u16 version
_DIGEST_LEN = 32

# the four durable-IO seams, probed in order along the write/read paths:
#   write   — before the payload hits the temp file (error = the write
#             dying mid-stream; corrupt = a poisoned buffer on its way
#             to disk, caught by the reader's digest check later)
#   replace — before the atomic promotion (error = killed between write
#             and rename: the final path must keep its previous content
#             and the temp must not leak)
#   read    — after the raw bytes come back (corrupt = bit rot between
#             write and read, the canonical disk-damage model)
#   digest  — before the integrity compare (error = the verification
#             machinery itself dying; the caller's ladder must treat it
#             as corruption, not crash)
_SITE_WRITE = faults.site("persist.write")
_SITE_REPLACE = faults.site("persist.replace")
_SITE_READ = faults.site("persist.read")
_SITE_DIGEST = faults.site("persist.digest")


class ArtifactError(Exception):
    """Base of every load-time artifact failure: a caller that catches
    this has seen the whole corruption ladder."""


class ArtifactMissing(ArtifactError):
    """No artifact at the path (a plain cache miss)."""


class ArtifactCorrupt(ArtifactError):
    """Truncated or damaged artifact: short file, bad magic, payload
    length mismatch, or digest mismatch."""


class ArtifactStaleTag(ArtifactError):
    """Structurally intact artifact written under a different kind,
    format version, or ABI/format tag — a miss, never an input."""


def _encode_str(s: str) -> bytes:
    raw = s.encode()
    if len(raw) > 0xFFFF:
        raise ValueError(f"artifact kind/tag too long ({len(raw)} bytes)")
    return len(raw).to_bytes(2, "little") + raw


def _header(kind: str, tag: str, payload_len: int) -> bytes:
    return (MAGIC + FORMAT_VERSION.to_bytes(2, "little")
            + _encode_str(kind) + _encode_str(tag)
            + payload_len.to_bytes(8, "little"))


def write_artifact(path: str, payload: bytes, kind: str,
                   tag: str = "") -> int:
    """Atomically persist ``payload`` at ``path`` under the digest
    envelope.  Returns the artifact's total on-disk size.  Any failure
    (including injected ones) unlinks the temp file — the final path is
    either the previous artifact or the complete new one, never a torn
    middle."""
    payload = _SITE_WRITE(bytes(payload))
    header = _header(kind, tag, len(payload))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp",
        dir=os.path.dirname(path) or ".")
    try:
        # mkstemp creates 0600; restore plain-open() semantics so a
        # shared cache stays readable by other accounts' processes
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        digest = hashlib.sha256()
        with os.fdopen(fd, "wb") as f:
            for chunk in (header, payload):
                digest.update(chunk)
                f.write(chunk)
            f.write(digest.digest())
            f.flush()
            os.fsync(f.fileno())
        _SITE_REPLACE()
        os.replace(tmp, path)  # atomic: concurrent writers converge
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(header) + len(payload) + _DIGEST_LEN


def envelope(payload: bytes, kind: str, tag: str = "") -> bytes:
    """The in-memory artifact envelope (header | payload | digest) — the
    exact byte layout ``write_artifact`` persists, for callers framing
    payloads over a CHANNEL instead of a file (the dist fabric's message
    codec, dist/codec.py).  Round-trips through ``verify_buffer`` /
    ``parse_buffer``, so a torn or damaged frame surfaces as
    ``ArtifactCorrupt`` — a detected miss, never garbage input."""
    payload = bytes(payload)
    header = _header(kind, tag, len(payload))
    digest = hashlib.sha256(header + payload).digest()
    return header + payload + digest


def parse_buffer(path: str, raw) -> Tuple[str, str, bytes]:
    """Digest-verify one envelope WITHOUT pinning kind/tag up front (a
    channel receiver learns the message kind from the frame itself, so
    the ``verify_buffer`` compare-against-expected shape does not fit).
    Returns ``(kind, tag, payload)``; the same corruption ladder as
    ``verify_buffer``, minus the kind/tag staleness compare — which the
    caller owns."""
    kind, tag, start, stop = _split_bounds(path, raw)
    return kind, tag, bytes(raw[start:stop])


def read_artifact(path: str, kind: str, tag: str = "",
                  expected_payload_len: Optional[int] = None) -> bytes:
    """Load and verify one artifact; returns the payload.  Raises the
    ladder: ``ArtifactMissing`` (no file), ``ArtifactCorrupt``
    (truncated / damaged / digest mismatch), ``ArtifactStaleTag`` (wrong
    kind, format version, or tag).  ``expected_payload_len`` adds a
    structural length check on top of the digest."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        raise ArtifactMissing(path) from None
    except OSError as exc:
        raise ArtifactCorrupt(f"{path}: unreadable ({exc})") from None
    return verify_buffer(path, raw, kind, tag,
                         expected_payload_len=expected_payload_len)


def verify_buffer(path: str, raw, kind: str, tag: str = "",
                  expected_payload_len: Optional[int] = None) -> bytes:
    """Verify one envelope held in any buffer (bytes, or an mmap so the
    digest pass streams over mapped pages without a heap copy) and
    return its payload as bytes.  Same ladder as ``read_artifact``."""
    buf, start, stop = payload_bounds(path, raw, kind, tag)
    payload = bytes(buf[start:stop])
    if (expected_payload_len is not None
            and len(payload) != expected_payload_len):
        raise ArtifactCorrupt(
            f"{path}: payload {len(payload)} bytes, expected "
            f"{expected_payload_len}")
    return payload


def payload_bounds(path: str, raw, kind: str, tag: str = ""):
    """``verify_buffer`` without the payload copy: verify the envelope
    and return ``(buf, start, stop)`` so the caller can serve straight
    off ``buf[start:stop]`` — the query engine's zero-copy read path
    over an mmap'd artifact.  ``buf`` is ``raw`` itself except under an
    armed fault plan, where the damage probe materializes the buffer
    first (the returned bounds always index the returned buffer)."""
    if faults.active_plan() is not None:
        # the disk-damage probe: under an armed plan, materialize the
        # buffer so a `corrupt` rule can flip a byte the way bit rot
        # would — disabled (the normal path) this costs nothing
        raw = _SITE_READ(bytes(raw))
    kind_found, tag_found, start, stop = _split_bounds(path, raw)
    if kind_found != kind or tag_found != tag:
        raise ArtifactStaleTag(
            f"{path}: kind/tag ({kind_found!r}, {tag_found!r}) != "
            f"expected ({kind!r}, {tag!r})")
    return raw, start, stop


def _split_bounds(path: str, raw) -> Tuple[str, str, int, int]:
    """Parse + digest-verify one envelope; (kind, tag, payload start,
    payload stop) — bounds into ``raw``, no payload copy."""
    if len(raw) < _HDR_FIXED + 4 + 8 + _DIGEST_LEN:
        raise ArtifactCorrupt(f"{path}: truncated ({len(raw)} bytes)")
    if raw[:4] != MAGIC:
        raise ArtifactCorrupt(f"{path}: bad magic {bytes(raw[:4])!r}")
    _SITE_DIGEST()
    view = memoryview(raw)
    digest = hashlib.sha256(view[:-_DIGEST_LEN]).digest()
    expected = bytes(view[-_DIGEST_LEN:])
    view.release()
    if digest != expected:
        raise ArtifactCorrupt(f"{path}: digest mismatch")
    version = int.from_bytes(raw[4:6], "little")
    off = _HDR_FIXED
    try:
        kind, off = _read_str(raw, off)
        tag, off = _read_str(raw, off)
        payload_len = int.from_bytes(raw[off:off + 8], "little")
        # thread-safe: `off` is a function-local cursor seeded FROM the
        # module constant _HDR_FIXED, never the constant itself
        off += 8
    except (IndexError, UnicodeDecodeError) as exc:
        raise ArtifactCorrupt(f"{path}: malformed header ({exc})") from None
    if version != FORMAT_VERSION:
        # checked only after the digest: an intact artifact from another
        # format generation is STALE; a damaged one is corrupt
        raise ArtifactStaleTag(
            f"{path}: format version {version} != {FORMAT_VERSION}")
    start, stop = off, len(raw) - _DIGEST_LEN
    if stop - start != payload_len:
        raise ArtifactCorrupt(
            f"{path}: payload {stop - start} bytes, header says "
            f"{payload_len}")
    return kind, tag, start, stop


def _read_str(raw: bytes, off: int) -> Tuple[str, int]:
    n = int.from_bytes(raw[off:off + 2], "little")
    off += 2
    return raw[off:off + n].decode(), off + n


def quarantine(path: str) -> Optional[str]:
    """Move a damaged artifact aside (``<path>.corrupt``) so the next
    writer starts clean and the evidence survives for a post-mortem.
    Atomic like every promotion here; returns the quarantine path, or
    None when the move itself failed (read-only tree — the caller's
    ladder proceeds either way)."""
    dest = path + ".corrupt"
    try:
        os.replace(path, dest)
    except OSError:
        return None
    return dest
