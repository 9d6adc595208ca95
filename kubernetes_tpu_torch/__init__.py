"""kubernetes_tpu_torch — the batch scheduler's hot path on an NVIDIA GPU.

A port of kubernetes_tpu (the JAX/TPU package beside it, which stays the
reference) to PyTorch, with hand-written CUDA kernels for Hopper
(csrc/*.cu, built with nvcc at first use into build/). It imports torch
and numpy, never jax and never kubernetes_tpu: the device-free modules it
needs are copies under the same relative paths.

This slice carries the class-scan batch drain:
  api/, utils/   copies of the object model, clock and feature gates
  scheduler/     cache, node infos, predicates, priorities, score and
                 term compilers (copies); tensorize and core (ported)
  scheduler/kernels/batch.py  K1 class_ms_init, K2 class_scan,
                              K3 apply_dirty, each with its plain version
  convert.py     numpy state -> the port's tensors (the tests feed both
                 packages identical state through it)

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
