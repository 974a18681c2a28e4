"""Snappy block-format codec, from scratch.

The vector format requires `.ssz_snappy` parts (snappy *block* format, the
same `snappy.compress` payload the reference writes in
gen_base/gen_runner.py); python-snappy is not available in this image, so
the codec lives here.  Format: a little-endian varint of the uncompressed
length, then tagged elements — literals and back-references (copy with
1/2/4-byte offsets).  The compressor uses a greedy 4-byte hash matcher
(matches >= 4 bytes, copy length capped at 64 per element, long matches
split); the decompressor implements the full tag set including
overlapping copies.  Tests: tests/test_torch_debug.py holds its bytes
against the JAX package's codec.
"""
from __future__ import annotations

_MAX_COPY_LEN = 64
_MIN_MATCH = 4


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple:
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk)
    if n == 0:
        return
    rem = n - 1
    if rem < 60:
        out.append(rem << 2)
    elif rem < (1 << 8):
        out.append(60 << 2)
        out.append(rem)
    elif rem < (1 << 16):
        out.append(61 << 2)
        out += rem.to_bytes(2, "little")
    elif rem < (1 << 24):
        out.append(62 << 2)
        out += rem.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += rem.to_bytes(4, "little")
    out += chunk


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # prefer the 2-byte-offset form; fall back to 4-byte offsets
    while length > 0:
        chunk = min(length, _MAX_COPY_LEN)
        if chunk < _MIN_MATCH:
            break  # never emit copies shorter than a match
        if offset < (1 << 16):
            out.append(((chunk - 1) << 2) | 0b10)
            out += offset.to_bytes(2, "little")
        else:
            out.append(((chunk - 1) << 2) | 0b11)
            out += offset.to_bytes(4, "little")
        length -= chunk


def compress(data: bytes) -> bytes:
    data = bytes(data)
    n = len(data)
    out = bytearray(_write_varint(n))
    if n == 0:
        return bytes(out)

    table: dict = {}
    i = 0
    lit_start = 0
    while i + _MIN_MATCH <= n:
        key = data[i : i + _MIN_MATCH]
        cand = table.get(key)
        table[key] = i
        if cand is not None:
            length = _MIN_MATCH
            while i + length < n and data[cand + length] == data[i + length]:
                length += 1
            # avoid splitting off sub-minimum tails the emitter would drop
            if length % _MAX_COPY_LEN != 0 and length % _MAX_COPY_LEN < _MIN_MATCH:
                length -= length % _MAX_COPY_LEN
            _emit_literal(out, data[lit_start:i])
            _emit_copy(out, i - cand, length)
            i += length
            lit_start = i
        else:
            i += 1
    _emit_literal(out, data[lit_start:])
    return bytes(out)


def decompress(data: bytes) -> bytes:
    data = bytes(data)
    expected, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0b00:  # literal
            rem = tag >> 2
            if rem >= 60:
                nbytes = rem - 59
                if pos + nbytes > n:
                    raise ValueError("truncated literal length")
                rem = int.from_bytes(data[pos : pos + nbytes], "little")
                pos += nbytes
            length = rem + 1
            if pos + length > n:
                raise ValueError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 0b01:  # copy, 1-byte offset
            length = ((tag >> 2) & 0b111) + 4
            if pos >= n:
                raise ValueError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 0b10:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("truncated copy-2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("truncated copy-4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("copy offset out of range")
        start = len(out) - offset
        for k in range(length):  # byte-wise: copies may overlap themselves
            out.append(out[start + k])
    if len(out) != expected:
        raise ValueError(f"length mismatch: header {expected}, got {len(out)}")
    return bytes(out)
