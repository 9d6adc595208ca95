"""Runtime machinery (ref: staging/src/k8s.io/apimachinery/pkg/runtime)."""

from .scheme import SCHEME, Scheme, default_scheme

__all__ = ["SCHEME", "Scheme", "default_scheme"]
