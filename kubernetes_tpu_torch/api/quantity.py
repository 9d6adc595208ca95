"""Resource quantities — "100m", "1Gi", "1.5", "2e3".

Re-implements the semantics of the reference's resource.Quantity
(staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go): decimal or
binary SI suffixes, milli-precision accessors, exact arithmetic. Internally a
`fractions.Fraction` for exactness (the reference uses scaled int64 + inf.Dec).

The scheduler tensorization path (scheduler/tensorize.py) consumes
`milli_value()` for cpu and `value()` for memory/storage, mirroring how
NodeInfo.Resource carries MilliCPU vs bytes (ref: pkg/scheduler/nodeinfo/
node_info.go:139-148).
"""

from __future__ import annotations

import re
from fractions import Fraction
from functools import lru_cache
from typing import Union

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4,
           "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"n": Fraction(1, 10**9), "u": Fraction(1, 10**6),
            "m": Fraction(1, 1000), "": Fraction(1),
            "k": 1000, "M": 10**6, "G": 10**9, "T": 10**12,
            "P": 10**15, "E": 10**18}

_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>[numkMGTPE]i?|Ki|Mi|Gi|Ti|Pi|Ei)?)$")


class Quantity:
    # _iv/_mv lazily cache value()/milli_value(): copiers reference-share
    # Quantity instances (immutable by contract), so the scheduler's repeated
    # per-pod request accounting pays the Fraction arithmetic once
    __slots__ = ("_value", "_format", "_iv", "_mv")

    def __init__(self, value: Union[str, int, float, Fraction, "Quantity"] = 0):
        self._format = ""
        self._iv = None
        self._mv = None
        if isinstance(value, Quantity):
            self._value = value._value
            self._format = value._format
        elif isinstance(value, str):
            self._value, self._format = self._parse(value)
        elif isinstance(value, (int, Fraction)):
            self._value = Fraction(value)
        elif isinstance(value, float):
            self._value = Fraction(value).limit_denominator(10**9)
        else:
            raise TypeError(f"cannot build Quantity from {type(value)!r}")

    @staticmethod
    @lru_cache(maxsize=4096)
    def _parse(s: str):
        m = _RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid quantity {s!r}")
        num = Fraction(m.group("num"))
        if m.group("sign") == "-":
            num = -num
        if m.group("exp"):
            e = int(m.group("exp")[1:])
            num *= Fraction(10) ** e
            return num, "exp"
        suffix = m.group("suffix") or ""
        if suffix in _BINARY:
            return num * _BINARY[suffix], "binary"
        if suffix in _DECIMAL:
            return num * Fraction(_DECIMAL[suffix]), suffix
        raise ValueError(f"invalid quantity suffix {suffix!r} in {s!r}")

    # --- accessors (semantics of quantity.go Value()/MilliValue()) ---
    def value(self) -> int:
        """Value rounded up to the nearest integer (ref Value())."""
        if self._iv is None:
            self._iv = -((-self._value.numerator) // self._value.denominator)
        return self._iv

    def milli_value(self) -> int:
        if self._mv is None:
            v = self._value * 1000
            self._mv = -((-v.numerator) // v.denominator)
        return self._mv

    def as_fraction(self) -> Fraction:
        return self._value

    def is_zero(self) -> bool:
        return self._value == 0

    # --- arithmetic ---
    def _coerce(self, other) -> Fraction:
        if isinstance(other, Quantity):
            return other._value
        return Quantity(other)._value

    def __add__(self, other):
        q = Quantity(self._value + self._coerce(other))
        q._format = self._format
        return q

    def __sub__(self, other):
        q = Quantity(self._value - self._coerce(other))
        q._format = self._format
        return q

    def __neg__(self):
        q = Quantity(-self._value)
        q._format = self._format
        return q

    def __eq__(self, other):
        if isinstance(other, (Quantity, str, int, float, Fraction)):
            return self._value == self._coerce(other)
        return NotImplemented

    def __lt__(self, other):
        return self._value < self._coerce(other)

    def __le__(self, other):
        return self._value <= self._coerce(other)

    def __gt__(self, other):
        return self._value > self._coerce(other)

    def __ge__(self, other):
        return self._value >= self._coerce(other)

    def __hash__(self):
        return hash(self._value)

    def __bool__(self):
        return self._value != 0

    # --- canonical form ---
    def canonical(self) -> str:
        v = self._value
        neg = "-" if v < 0 else ""
        v = abs(v)
        if self._format == "binary":
            for suf in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
                base = _BINARY[suf]
                if v >= base and (v / base).denominator == 1:
                    return f"{neg}{v / base}{suf}"
        if v.denominator == 1:
            return f"{neg}{v.numerator}"
        m = v * 1000
        if m.denominator == 1:
            return f"{neg}{m.numerator}m"
        n = v * 10**9
        num = -((-n.numerator) // n.denominator)  # round up like the reference
        return f"{neg}{num}n"

    def __str__(self):
        return self.canonical()

    def __repr__(self):
        return f"Quantity({self.canonical()!r})"

    # --- serde hooks ---
    def to_json(self):
        return self.canonical()

    @classmethod
    def from_json(cls, data):
        if isinstance(data, (int, float)):
            return cls(data)
        return cls(str(data))
