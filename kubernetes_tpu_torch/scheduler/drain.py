"""A chained batch drain: schedule_launch -> schedule_finish with each
batch launched on its predecessor's post-batch device usage.

The single-threaded form of the chaining that Scheduler.drain_pipelined
(scheduler.py) does with its queue, commit thread and store binds, kept as
the smallest caller of the chained launch. Batch k+1 launches chained on
batch k before k's results are fetched, so the card runs k+1's scan
while the host repairs and commits k. Winners are committed with cache.assume_pod; the only
cache mutations between two launches are the drain's own assumes, which
is what the chain_seq check asks. A BatchScheduler built with a mesh
(workload.build(..., mesh=)) drains sharded: its class-table batches take
the sharded scan, counted in DrainResult.sharded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.serde import shallow_bind_clone

#: how often a pod the repair demoted (retry) is tried again
MAX_RETRIES = 3


@dataclass
class DrainResult:
    #: pod key -> node name, or None when the pod fit nowhere
    binds: Dict[str, Optional[str]] = field(default_factory=dict)
    #: pod key -> the kernel's chosen score of its final placement
    scores: Dict[str, float] = field(default_factory=dict)
    #: wall seconds from each batch's launch to its results committed
    batch_seconds: List[float] = field(default_factory=list)
    batches: int = 0
    chained: int = 0
    #: batches that ran the sharded class scan (PendingBatch.sharded)
    sharded: int = 0
    #: host seconds in schedule_launch, schedule_finish and the commit
    launch_s: float = 0.0
    finish_s: float = 0.0
    commit_s: float = 0.0


def drain(sched, pods: list, batch_size: int, chain: bool = True
          ) -> DrainResult:
    """Schedule `pods` in queue order, `batch_size` at a time, through
    `sched` (a BatchScheduler); commit every winner into its cache."""
    out = DrainResult()
    queue = list(pods)
    retries: Dict[str, int] = {}
    pos = 0
    pending = None
    t_launch = 0.0
    prev_winners: list = []
    phantom = False
    while pos < len(queue) or pending is not None:
        nxt = None
        t_next = time.perf_counter()
        if pos < len(queue) and (pending is None or chain):
            chunk = queue[pos:pos + batch_size]
            t0 = time.perf_counter()
            if pending is None:
                phantom = False
                nxt = sched.schedule_launch(chunk)
            else:
                nxt = sched.schedule_launch(
                    chunk, chain=pending,
                    chain_seq=sched.cache.mutation_seq)
            out.launch_s += time.perf_counter() - t0
            if nxt is not None:
                pos += len(chunk)
                out.batches += 1
                out.chained += int(nxt.chained)
                out.sharded += int(nxt.sharded)
        if pending is not None:
            if pending.chained:
                # the predecessor's winners postdate this batch's
                # snapshot; repair validates against them
                pending.stale_winners = prev_winners or None
                pending.phantom = phantom
                if phantom:
                    sched.mirror.invalidate_usage()
            t0 = time.perf_counter()
            results = sched.schedule_finish(pending)
            t1 = time.perf_counter()
            out.finish_s += t1 - t0
            winners = []
            for r in results:
                key = r.pod.metadata.key()
                if r.node_name is not None:
                    bound = shallow_bind_clone(r.pod)
                    bound.spec.node_name = r.node_name
                    sched.cache.assume_pod(bound)
                    winners.append((r.pod, r.node_name))
                    out.binds[key] = r.node_name
                    out.scores[key] = r.score
                elif r.retry and retries.get(key, 0) < MAX_RETRIES:
                    retries[key] = retries.get(key, 0) + 1
                    queue.append(r.pod)
                else:
                    out.binds[key] = None
            if any(r.retry for r in results):
                # the chained usage counted winners this batch lost
                phantom = True
            prev_winners = winners
            out.commit_s += time.perf_counter() - t1
            out.batch_seconds.append(time.perf_counter() - t_launch)
        if nxt is not None:
            t_launch = t_next
        pending = nxt
    return out
