"""Device kernels of the scheduling hot loop: hand-written CUDA (csrc/)
behind wrappers that take the plain PyTorch version on CPU tensors."""

from .batch import (LAUNCHES, apply_dirty, class_ms_init, reset_launches,
                    schedule_batch, schedule_batch_packed)

__all__ = ["LAUNCHES", "apply_dirty", "class_ms_init", "reset_launches",
           "schedule_batch", "schedule_batch_packed"]
