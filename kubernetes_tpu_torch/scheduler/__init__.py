"""The batch scheduler on the GPU: kubernetes_tpu/scheduler ported to
PyTorch and CUDA.

  scheduler.py  the Scheduler shell: informers -> SchedulingQueue ->
                DRF order (tenancy/) -> batch -> assume -> bind, with
                schedule_pending and the pipelined drain (drain_pipelined)
  core.py       BatchScheduler: the class-scan batch (kernels K1-K3),
                the classic per-pod scan (K7, KTPU_CLASS_SCAN=0), the
                all-or-nothing gang scan (K9) and preemption, single-pod
                (K6) and whole-gang over ICI domains (K11)
  queue.py      SchedulingQueue (copy), gang.py the host-side gang gate
  drain.py      the single-threaded chained drain, the smallest caller
                of the chained launch

KTPU_SPECULATIVE=1 (Scheduler(speculative=True)) routes class-table
batches to the speculative cohort scan (kernels/speculative.py, K12).
topology.py evaluates a large batch's required (anti-)affinity templates
on the device (kernels/affinity.py, K13). A mesh (Scheduler(mesh=D),
KTPU_MESH, sharding.py) splits the node axis into D shards of the
sharded class scan on the card (kernels/batch.py schedule_batch_sharded,
K15: one thread-block cluster, a CTA a shard).
"""

from .cache import Cache, Snapshot
from .core import BatchScheduler, FitError, ScheduleResult
from .gang import GangManager
from .nodeinfo import NodeInfo, Resource
from .queue import SchedulingQueue
from .scheduler import Scheduler

__all__ = ["BatchScheduler", "Cache", "FitError", "GangManager", "NodeInfo",
           "Resource", "ScheduleResult", "Scheduler", "SchedulingQueue",
           "Snapshot"]
