"""Yield protocol: dual-mode test functions.

A spec test function yields named parts.  Under pytest the generator is
drained (assertions still run); in generator mode each yield is annotated
into ``(name, kind, value)`` with kind one of 'meta' | 'ssz' | 'data' and
SSZ views serialized — the contract the vector writers consume (parity
surface: reference test/utils/utils.py).

The part-annotation rules live in module-level functions rather than the
reference's nested closure, so the consumer (gen/consumer.py) and the
writers can share them.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

from consensus_specs_tpu_torch.ssz.impl import serialize
from consensus_specs_tpu_torch.ssz.types import View


def _as_ssz_bytes(value) -> bytes:
    return serialize(value) if isinstance(value, View) else bytes(value)


def annotate_part(key: str, value) -> Iterator[tuple]:
    """Classify one ``(key, value)`` yield into annotated part tuples.

    Views and raw bytes become 'ssz' parts; a homogeneous list of them fans
    out into indexed parts plus a count meta; everything else is 'data'.
    ``None`` values produce nothing (an aborted post-state, for example).
    """
    if value is None:
        return
    if isinstance(value, (View, bytes)):
        yield key, "ssz", _as_ssz_bytes(value)
    elif isinstance(value, list) and all(isinstance(el, (View, bytes)) for el in value):
        for i, el in enumerate(value):
            yield f"{key}_{i}", "ssz", _as_ssz_bytes(el)
        yield f"{key}_count", "meta", len(value)
    else:
        yield key, "data", value


def annotate_parts(raw_parts, description=None) -> Iterator[tuple]:
    """Annotate a stream of 2-tuples; 3-tuples pass through pre-annotated."""
    if description is not None:
        yield "description", "meta", description
    for part in raw_parts:
        if len(part) == 2:
            yield from annotate_part(*part)
        else:
            yield part  # e.g. ("bls_setting", "meta", 1)


def vector_test(description: str = None):
    def runner(fn):
        def entry(*args, **kw):
            if kw.pop("generator_mode", False):
                return annotate_parts(fn(*args, **kw), description)
            # pytest mode: drain so the whole body (and its asserts) runs.
            for _ in fn(*args, **kw):
                pass
            return None
        return entry
    return runner


def with_meta_tags(tags: Dict[str, Any]):
    """Append the given meta parts, but only for non-empty cases (parity
    surface: reference test/utils/utils.py with_meta_tags)."""
    def runner(fn):
        def entry(*args, **kw):
            produced = False
            for part in fn(*args, **kw):
                produced = True
                yield part
            if produced:
                yield from ((k, "meta", v) for k, v in tags.items())
        return entry
    return runner
