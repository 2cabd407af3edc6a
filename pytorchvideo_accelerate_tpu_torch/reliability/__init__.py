"""Resilience helpers (the port's copy of the JAX package's `reliability/`:
`retry_call`, atomic writes, the training guard and the preemption grace
path; fault injection is queued in ROADMAP.md)."""
