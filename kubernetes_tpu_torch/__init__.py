"""kubernetes_tpu_torch — the batch scheduler's hot path on an NVIDIA GPU.

A port of kubernetes_tpu (the JAX/TPU package beside it, which stays the
reference) to PyTorch, with hand-written CUDA kernels for Hopper
(csrc/*.cu, built with nvcc at first use into build/). It imports torch
and numpy, never jax and never kubernetes_tpu: the device-free modules it
needs are copies under the same relative paths.

Ported so far (slices 1-9; every device kernel of the reference):
  api/, runtime/, utils/, observability/
                 copies of the object model, scheme, clock, feature
                 gates, metrics, backoff, traces and span tracer
  state/         store, client, informers, event recorder (copies; no
                 write-ahead log)
  scheduler/     Scheduler (schedule_pending, drain_pipelined), the
                 SchedulingQueue, cache, predicates, priorities, score and
                 term compilers, gang gate (copies); tensorize and core
                 (ported); drain.py, the single-threaded chained drain
  scheduler/kernels/  K1 class_ms_init, K2 class_scan, K3 apply_dirty,
                 K7 pod_scan, K8 filter_score, K15 shard_scan (batch.py),
                 K6 / K11 pricing (preempt.py), K9 / K10 gangs (gang.py),
                 K12 speculative cohorts, K13 / K14 affinity masks and
                 scores, each with its plain version
  scheduler/sharding.py  the mesh: D node shards on the card (K15's
                 thread-block cluster)
  tenancy/       DRF account with K4 drf_dominant and K5 drf_order
                 (kernels.py), bands and gang quota (copies)
  convert.py     numpy state -> the port's tensors (the tests feed both
                 packages identical state through it)

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
