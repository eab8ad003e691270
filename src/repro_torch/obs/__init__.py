"""Observability for the port: log-bucket histograms, windowed metrics,
stall detection and attribution, and a Chrome ``trace_event`` span tracer
(copies of the JAX package's ``obs`` modules)."""
from .metrics import (BUCKET_EDGES_S, LogBucketHistogram, ObsConfig,
                      WindowedMetrics)
from .stall import attribute_stalls, detect_stalls
from .trace import SPAN_CATEGORIES, Tracer, validate_chrome_trace

__all__ = [
    "BUCKET_EDGES_S",
    "LogBucketHistogram",
    "ObsConfig",
    "WindowedMetrics",
    "Tracer",
    "SPAN_CATEGORIES",
    "detect_stalls",
    "attribute_stalls",
    "validate_chrome_trace",
]
