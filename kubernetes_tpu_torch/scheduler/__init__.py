"""The batch scheduler on the GPU: kubernetes_tpu/scheduler ported to
PyTorch and CUDA.

  scheduler.py  the Scheduler shell: informers -> SchedulingQueue ->
                DRF order (tenancy/) -> batch -> assume -> bind, with
                schedule_pending and the pipelined drain (drain_pipelined)
  core.py       BatchScheduler: the class-scan batch (kernels K1-K3)
  queue.py      SchedulingQueue (copy), gang.py the host-side gang gate
  drain.py      the single-threaded chained drain, the smallest caller
                of the chained launch

Not ported yet (ROADMAP): gang and preemption kernels, the in-scan
affinity tables, speculative cohorts and the sharded scan; those routes
raise NotImplementedError.
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
