"""Host-side utilities of the port: its own copies of the JAX package's
metrics registry, request tracing and metric catalog."""
