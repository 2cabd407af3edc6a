"""Resilience helpers (the port's copy of the JAX package's `reliability/`:
`retry_call`, atomic writes, the training guard, the preemption grace path
and the seeded fault registry `faults.py`; the chaos harness over it is
queued in ROADMAP.md)."""
