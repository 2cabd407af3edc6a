"""Parallelism across processes (the port's copy of what it has of the
JAX package's `parallel/`: the process group, host collectives, the
(data, model) train mesh and the (data, fsdp, tensor, context) library
mesh, FSDP, tensor parallelism and ring / Ulysses context parallelism; the
pipeline and the hang check are queued in ROADMAP.md)."""
