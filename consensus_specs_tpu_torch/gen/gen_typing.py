"""Test-case/provider dataclasses for the vector generators (reference
capability: gen_helpers/gen_base/gen_typing.py).

A case function yields ``(name, kind, value)`` parts with kind in
{'meta', 'data', 'ssz'} — exactly what vector_test produces in generator
mode (testing/utils.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Tuple

TestCasePart = Tuple[str, str, Any]


@dataclass
class TestCase:
    fork_name: str
    preset_name: str
    runner_name: str
    handler_name: str
    suite_name: str
    case_name: str
    case_fn: Callable[[], Iterable[TestCasePart]]


@dataclass
class TestProvider:
    # one-time context setup for the whole provider (e.g. BLS backend)
    prepare: Callable[[], None]
    make_cases: Callable[[], Iterable[TestCase]]
