"""Observability of the port: the span tracer, the metrics registry and
the Chrome/Perfetto and JSONL exporters.

``repro_torch.obs`` is imported *by* ``repro_torch.core`` and the
kernels, so nothing here may import them back — the registry's default
cache probes defer their planner imports to snapshot time.
"""
from .tracer import (  # noqa: F401
    TRACER,
    Tracer,
    Span,
    disable,
    enable,
    get_tracer,
)
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    snapshot,
)
from .export import (  # noqa: F401
    to_chrome,
    to_jsonl,
    validate_chrome,
    write_chrome,
    write_jsonl,
)
