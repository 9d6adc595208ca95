"""Exponential backoff with deterministic jitter — the shared retry helper.

Ref: k8s.io/client-go/util/retry (RetryOnConflict / OnError with a
wait.Backoff) and the reference's DefaultRetry{Steps:5, Duration:10ms,
Factor:1.0, Jitter:0.1}. Control-plane writes here used to swallow
failures (`except Exception: pass`); every such site now routes through
`retry()` so transient API errors are retried with backoff, logged once
on give-up, and counted in utils/metrics.RobustnessMetrics.

Jitter is DETERMINISTIC: it derives from a seeded `random.Random` keyed
by (seed, op) so a chaos run replayed from the same seed sleeps the same
virtual durations — `(seed, schedule)` fully reproduces a run (the
chaos/ subsystem's contract). Sleeps go through the injected Clock, so a
FakeClock makes retries free in tests and soaks.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Type

from .clock import Clock, REAL_CLOCK

logger = logging.getLogger("backoff")


@dataclass(frozen=True)
class BackoffPolicy:
    """Delay schedule: base * factor^n, jittered ±(jitter * delay), capped.

    `attempts` counts CALLS, not retries: attempts=4 means one initial
    try plus up to three retries."""

    base: float = 0.05
    factor: float = 2.0
    cap: float = 2.0
    attempts: int = 4
    jitter: float = 0.2

    def delays(self, seed: Optional[int] = None, op: str = "") -> Iterator[float]:
        """The (attempts - 1) sleep durations between calls."""
        # string seeding hashes via sha512 — stable across processes,
        # unlike tuple seeding which rides the salted builtin hash()
        rng = random.Random(f"{seed if seed is not None else 0}:{op}")
        delay = self.base
        for _ in range(max(0, self.attempts - 1)):
            jit = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield min(self.cap, delay) * jit
            delay *= self.factor

    def delays_forever(self, seed: Optional[int] = None,
                       op: str = "") -> Iterator[float]:
        """The retry-forever schedule: the policy's escalation, then its
        cap unjittered for good — for loops that must never exhaust
        (informer reflectors, replication followers)."""
        yield from self.delays(seed=seed, op=op)
        while True:
            yield self.cap


#: the control-plane default (nodelifecycle patches, scheduler binds)
DEFAULT_POLICY = BackoffPolicy()


def retry(fn: Callable[[], object], *,
          policy: BackoffPolicy = DEFAULT_POLICY,
          clock: Clock = REAL_CLOCK,
          give_up_on: Tuple[Type[BaseException], ...] = (),
          metrics=None, component: str = "", op: str = "",
          seed: Optional[int] = None):
    """Call `fn` until it succeeds or the policy is exhausted.

    Exceptions in `give_up_on` are PERMANENT (NotFound for a deleted
    object, Conflict the caller handles itself): re-raised immediately,
    uncounted — retrying a 404 only delays the informer's cleanup.
    Everything else is transient: counted in `metrics.api_retries`
    (RobustnessMetrics), slept through the injected clock, retried.
    Exhaustion logs once, counts `metrics.api_give_ups`, and re-raises
    the last error so callers' requeue machinery still fires.
    """
    last: Optional[BaseException] = None
    for delay in policy.delays(seed=seed, op=op):
        try:
            return fn()
        except give_up_on:
            raise
        except Exception as e:  # transient: back off and retry
            last = e
            if metrics is not None:
                metrics.api_retries.inc(component=component, op=op)
            # a server-supplied hint (TooManyRequestsError carries the
            # parsed Retry-After) is a FLOOR under the backoff delay:
            # retrying sooner than the server asked just re-joins the
            # overload it was shed from
            ra = getattr(e, "retry_after", None)
            if ra:
                delay = max(delay, float(ra))
            clock.sleep(delay)
    try:
        return fn()
    except give_up_on:
        raise
    except Exception as e:
        last = e  # the FINAL attempt's error is what the log must show
        if metrics is not None:
            metrics.api_give_ups.inc(component=component, op=op)
        logger.warning("%s/%s failed after %d attempts (last: %r)",
                       component or "?", op or "?", policy.attempts, last)
        raise
