"""Injectable clocks (ref: k8s.io/utils/clock — the scheduler queue and
backoff take an injected clock so tests control time deterministically)."""

from __future__ import annotations

import threading
import time
from datetime import datetime, timezone


class Clock:
    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        """Interval measurement: a source that never steps backwards
        (time.time can — NTP), so durations computed from two reads are
        always >= 0. FakeClock unifies the two (virtual time only moves
        forward), which is what keeps traces deterministic under test."""
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Manually stepped clock; sleep() advances virtual time instantly."""

    def __init__(self, start: float = 1_000_000.0):
        self._now = start
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def now(self) -> float:
        with self._lock:
            return self._now

    def monotonic(self) -> float:
        return self.now()

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._cond:
            self._now += seconds
            self._cond.notify_all()


REAL_CLOCK = Clock()


def now_iso(clock: Clock = REAL_CLOCK) -> str:
    """RFC3339 with microseconds (the reference's MicroTime precision —
    plain second granularity makes sub-second grace periods flap)."""
    return datetime.fromtimestamp(clock.now(), tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def parse_iso(ts: str):
    """RFC3339 (with or without fractional seconds) -> unix seconds, or
    None on malformed input."""
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.strptime(ts, fmt) \
                .replace(tzinfo=timezone.utc).timestamp()
        except (ValueError, TypeError):
            continue
    return None
