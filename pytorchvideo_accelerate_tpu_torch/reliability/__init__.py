"""Resilience helpers (the port's copy of the JAX package's `reliability/`,
`retry_call` only; fault injection, atomic writes and the guard are queued
in ROADMAP.md)."""
