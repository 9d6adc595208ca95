"""Log-once-per-streak accounting for deliberately swallowed errors.

The repo's error-handling contract (established piecemeal by PRs 2, 4,
and 8; machine-checked by ktpulint rule KTPU001) forbids silently
dropped exceptions: a handler that decides an error is survivable must
still (a) log the FIRST failure of a streak — so a soak's logs show
that something started failing without drowning in repeats — and
(b) count EVERY one, so metrics surface the failure rate the logs
deliberately compress. This helper packages that idiom for
drop-and-continue paths that do NOT want retries; writes that should
be retried route through utils.backoff.retry instead.

Usage:

    self._swallowed = SwallowedErrors("podgc", metrics)
    ...
    try:
        self.client.pods(ns).delete(name)
        self._swallowed.ok("delete_pod")
    except Exception as e:
        self._swallowed.swallow("delete_pod", e)
        return False

Counting lands in RobustnessMetrics.swallowed_errors
(`swallowed_errors_total{component,op}`); with no metrics wired the
helper still logs. Streaks are per-op: a success on an op re-arms its
log so the NEXT failure of that op is visible again (the same contract
state/wal.py and state/leaderelection.py implement inline).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional


class SwallowedErrors:
    """Per-component accounting for handled-and-dropped exceptions."""

    def __init__(self, component: str, metrics=None,
                 logger: Optional[logging.Logger] = None):
        self.component = component
        self.metrics = metrics  # utils.metrics.RobustnessMetrics or None
        self._logger = logger or logging.getLogger(
            f"kubernetes_tpu.{component}")
        self._lock = threading.Lock()
        #: op -> consecutive swallowed failures since the last ok()
        self._streaks: Dict[str, int] = {}

    def swallow(self, op: str, exc: BaseException) -> None:
        """Record a survivable, dropped failure: the first of a streak
        logs (with the exception), every one counts."""
        with self._lock:
            streak = self._streaks.get(op, 0)
            self._streaks[op] = streak + 1
        if streak == 0:
            self._logger.warning(
                "%s/%s: swallowed %r; further failures counted in "
                "swallowed_errors_total until the streak clears",
                self.component, op, exc)
        if self.metrics is not None:
            self.metrics.swallowed_errors.inc(
                component=self.component, op=op)

    def ok(self, op: str) -> None:
        """A success ends the op's failure streak; the next failure
        logs again."""
        with self._lock:
            if self._streaks.get(op):
                self._streaks[op] = 0

    def streak(self, op: str) -> int:
        """Current consecutive-failure count (introspection/tests)."""
        with self._lock:
            return self._streaks.get(op, 0)
