"""Telemetry (the port's copy of what it has of the JAX package's `obs/`):
`registry.py`, the metric registry behind the serving server's `/metrics`."""
