"""Resilience helpers (the port's copy of the JAX package's `reliability/`:
`retry_call`, atomic writes and the training guard; fault injection is
queued in ROADMAP.md)."""
