"""Length-framed message codec for the dist fabric.

Port of ``consensus_specs_tpu/dist/codec.py``: a frame is the
reference's frame byte for byte, protocol tag included.

One frame on the wire::

    u32 len(envelope) | envelope

where ``envelope`` is the ``persist/atomic.py`` artifact envelope
(``MAGIC | u16 version | kind | tag | u64 len(payload) | payload |
sha256``) — the SAME torn-write discipline the durable tree uses, applied
to the pipe: a truncated stream, a flipped bit, or a stale protocol
generation surfaces as ``ArtifactMissing``/``ArtifactCorrupt``/
``ArtifactStaleTag`` at parse time, never as garbage handed to a task
merge.  The envelope ``kind`` is the message kind (``hello`` /
``heartbeat`` / ``task`` / ``reply`` / ``shutdown``); the ``tag`` pins
the wire protocol version (``PROTOCOL_TAG``), so a coordinator and a
worker from different generations refuse each other loudly.

The payload is ``json(meta) | NUL | body``: small structured routing
fields (task id, task kind, ok flag) ride the JSON head; bulk task data
(pickled arrays, entry lists) rides the opaque body tail untouched.

EOF semantics: a clean EOF at a frame boundary returns None (the peer
closed — end of stream); EOF anywhere inside a frame is a torn frame and
raises ``ArtifactCorrupt`` (a detected channel loss).
"""
from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

from consensus_specs_tpu_torch.persist import atomic

PROTOCOL_TAG = "dist-v1"

# a corrupted length prefix must never drive a wild allocation: frames
# beyond this bound are declared damage, not data
MAX_FRAME = 1 << 30


def encode_frame(kind: str, meta: dict, body: bytes = b"") -> bytes:
    """One wire frame: length prefix + digest envelope over meta/body."""
    meta_raw = json.dumps(meta, sort_keys=True,
                          separators=(",", ":")).encode()
    env = atomic.envelope(meta_raw + b"\x00" + bytes(body), kind,
                          PROTOCOL_TAG)
    return struct.pack("<I", len(env)) + env


def write_frame(stream, kind: str, meta: dict, body: bytes = b"") -> None:
    """Encode + write + flush one frame (callers serialize writes per
    stream under their own lock — frames must never interleave)."""
    stream.write(encode_frame(kind, meta, body))
    stream.flush()


def read_envelope(stream) -> Optional[bytes]:
    """Read one frame's raw envelope bytes (length prefix stripped).
    None on clean EOF at a frame boundary; ``ArtifactCorrupt`` on a torn
    frame or an insane length prefix.  Split from ``parse_envelope`` so
    the coordinator's reply-damage probe (``dist.reply``) can corrupt the
    raw bytes BEFORE the digest check — modeling bit rot on the wire."""
    head = _read_exact(stream, 4)
    if head is None:
        return None
    (n,) = struct.unpack("<I", head)
    if not 0 < n <= MAX_FRAME:
        raise atomic.ArtifactCorrupt(
            f"<channel>: insane frame length {n}")
    env = _read_exact(stream, n)
    if env is None:
        raise atomic.ArtifactCorrupt(
            f"<channel>: EOF before frame body ({n} bytes expected)")
    return env


def parse_envelope(env: bytes) -> Tuple[str, dict, bytes]:
    """Digest-verify one envelope and split its payload into (kind, meta,
    body).  Damage anywhere raises the atomic ladder; a foreign protocol
    generation raises ``ArtifactStaleTag``."""
    kind, tag, payload = atomic.parse_buffer("<channel>", env)
    if tag != PROTOCOL_TAG:
        raise atomic.ArtifactStaleTag(
            f"<channel>: protocol tag {tag!r} != {PROTOCOL_TAG!r}")
    meta_raw, sep, body = payload.partition(b"\x00")
    if not sep:
        raise atomic.ArtifactCorrupt("<channel>: frame missing meta/body split")
    try:
        meta = json.loads(meta_raw.decode())
    except (UnicodeDecodeError, ValueError) as exc:
        raise atomic.ArtifactCorrupt(
            f"<channel>: undecodable frame meta ({exc})") from None
    return kind, meta, body


def read_frame(stream) -> Optional[Tuple[str, dict, bytes]]:
    """``read_envelope`` + ``parse_envelope``: one decoded frame, or None
    on clean EOF."""
    env = read_envelope(stream)
    if env is None:
        return None
    return parse_envelope(env)


def _read_exact(stream, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, looping over short reads.  None when the
    stream is ALREADY at EOF (nothing read); ``ArtifactCorrupt`` when EOF
    lands mid-read — a torn frame, the channel-loss signal."""
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise atomic.ArtifactCorrupt(
                f"<channel>: truncated read ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf
