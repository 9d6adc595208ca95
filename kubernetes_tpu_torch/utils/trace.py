"""Step tracing — the k8s.io/utils/trace analog.

Ref: utiltrace.Trace as used per scheduling attempt
(generic_scheduler.go:185-186 creates one, steps at :204,223,246, and the
whole trace logs only when total time exceeds a threshold — 100ms there).

The clock is INJECTABLE (default REAL_CLOCK): a Trace created on the
chaos/serving harnesses' FakeClock measures virtual time, so threshold
logic is deterministic under test instead of blind to stepped clocks.
Intervals read `clock.monotonic()` — perf_counter on the real clock (an
NTP step must not suppress a slow-attempt log or fabricate one), virtual
time on FakeClock. Slow traces go through the logging module (logger
"kubernetes_tpu.trace"), not bare stderr prints; log_if_long still
returns the rendered string so tests can assert on it.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from .clock import Clock, REAL_CLOCK

LOGGER = logging.getLogger("kubernetes_tpu.trace")


class Trace:
    def __init__(self, name: str, clock: Clock = REAL_CLOCK, **fields):
        self.name = name
        self.fields = fields
        self.clock = clock
        self.start = clock.monotonic()
        self.steps: List[Tuple[float, str]] = []
        self._nested: List["Trace"] = []

    def step(self, msg: str) -> None:
        self.steps.append((self.clock.monotonic(), msg))

    def nest(self, name: str, **fields) -> "Trace":
        t = Trace(name, clock=self.clock, **fields)
        self._nested.append(t)
        return t

    def total_ms(self) -> float:
        return (self.clock.monotonic() - self.start) * 1000.0

    def log_if_long(self, threshold_ms: float = 100.0,
                    logger: Optional[logging.Logger] = None
                    ) -> Optional[str]:
        """Render + emit when total exceeds the threshold (ref:
        Trace.LogIfLong); returns the rendering (tests) or None."""
        if self.total_ms() < threshold_ms:
            return None
        text = self.render()
        (logger or LOGGER).warning("%s", text)
        return text

    def render(self) -> str:
        kv = ",".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}" {kv} '
                 f"(total {self.total_ms():.1f}ms):"]
        prev = self.start
        for ts, msg in self.steps:
            lines.append(f"  step {((ts - prev) * 1000):.1f}ms: {msg}")
            prev = ts
        for t in self._nested:
            lines.extend("  " + line for line in t.render().splitlines())
        return "\n".join(lines)
