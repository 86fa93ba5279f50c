"""Observability: the span tracer (``tracing.py``).  The metrics
registry, attribution, calibration and accounting of the JAX package's
``observability/`` are not ported (ROADMAP.md Queue A item 9)."""

from .tracing import TRACER, Tracer  # noqa: F401
