"""The batch scheduler on the GPU: the class-scan drain of
kubernetes_tpu/scheduler, ported to PyTorch and CUDA.

Trimmed to this slice: the scheduler loop, the scheduling queue, gangs
and preemption are not here yet (ROADMAP)."""

from .cache import Cache, Snapshot
from .core import BatchScheduler, ScheduleResult
from .nodeinfo import NodeInfo, Resource

__all__ = ["BatchScheduler", "Cache", "NodeInfo", "Resource",
           "ScheduleResult", "Snapshot"]
