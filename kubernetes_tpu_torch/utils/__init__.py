"""Cross-cutting utilities: copies of kubernetes_tpu/utils' clock, feature
gates, metrics, backoff, error log and step traces."""
