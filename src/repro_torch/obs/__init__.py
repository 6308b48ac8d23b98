"""Observability: request tracing, query explain, Prometheus export,
and the slow-query log (DESIGN.md §11).

A copy of ``repro.obs`` (pure Python, no jax), kept in this package so
that ``repro_torch`` imports nothing of ``repro``; its output is
byte-identical to the JAX package's.

Pure host-side instrumentation — nothing in this package imports the
core index machinery or issues device work, so the serving and core
layers can depend on it without cycles, and tracing can never change
what a query computes (the bit-identity + zero-dispatch invariants are
held by ``tests/test_obs.py``).
"""

from .explain import QueryExplain, RungExplain
from .prom import (DEFAULT_LATENCY_BUCKETS_S, Histogram, format_value,
                   parse_exposition)
from .slowlog import SlowQueryLog
from .trace import (Span, Tracer, attach, chrome_trace, current, span,
                    span_to_dict, write_chrome)

__all__ = [
    "Span", "Tracer", "attach", "chrome_trace", "current", "span",
    "span_to_dict", "write_chrome",
    "QueryExplain", "RungExplain",
    "Histogram", "DEFAULT_LATENCY_BUCKETS_S", "format_value",
    "parse_exposition",
    "SlowQueryLog",
]
