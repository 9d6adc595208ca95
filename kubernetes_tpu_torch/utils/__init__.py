"""Cross-cutting utilities: copies of kubernetes_tpu/utils' clock and
feature gates."""
