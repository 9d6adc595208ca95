"""Device kernels of the scheduling hot loop: hand-written CUDA (csrc/)
behind wrappers that take the plain PyTorch version on CPU tensors."""

from .affinity import affinity_masks, affinity_scores
from .batch import (LAUNCHES, apply_dirty, class_ms_init, filter_score,
                    reset_launches, schedule_batch, schedule_batch_packed,
                    schedule_batch_sharded, schedule_batch_sharded_packed)
from .gang import (gang_feasible, gang_schedule_batch,
                   gang_schedule_packed)
from .speculative import (schedule_batch_speculative,
                          schedule_batch_speculative_packed)

__all__ = ["LAUNCHES", "affinity_masks", "affinity_scores", "apply_dirty",
           "class_ms_init", "filter_score",
           "gang_feasible", "gang_schedule_batch", "gang_schedule_packed",
           "reset_launches", "schedule_batch", "schedule_batch_packed",
           "schedule_batch_sharded", "schedule_batch_sharded_packed",
           "schedule_batch_speculative", "schedule_batch_speculative_packed"]
