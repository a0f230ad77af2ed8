"""Column filters used to select time series by label.

Reference: core/.../query/KeyFilter.scala (Filter ADT: Equals, In, And,
NotEquals, EqualsRegex, NotEqualsRegex) + ColumnFilter.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Filter:
    label: str

    def matches(self, value: str) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class Equals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value == self.value


@dataclass(frozen=True)
class NotEquals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value != self.value


@dataclass(frozen=True)
class In(Filter):
    values: tuple[str, ...]

    def matches(self, value: str) -> bool:
        return value in self.values


@dataclass(frozen=True)
class EqualsRegex(Filter):
    pattern: str

    def matches(self, value: str) -> bool:
        return re.fullmatch(self.pattern, value) is not None


@dataclass(frozen=True)
class NotEqualsRegex(Filter):
    pattern: str

    def matches(self, value: str) -> bool:
        return re.fullmatch(self.pattern, value) is None
