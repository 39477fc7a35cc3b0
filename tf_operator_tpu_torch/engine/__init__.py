"""Host-side instrumentation the port's serving loop feeds: span tracing
and the Prometheus serving families (copies of the JAX package's
engine/tracing.py and engine/metrics.py pieces it uses)."""
