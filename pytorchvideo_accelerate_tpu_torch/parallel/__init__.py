"""Parallelism across processes (the port's copy of what it has of the
JAX package's `parallel/`: the process group, host collectives, the
(data, model) train mesh, tensor parallelism and ring / Ulysses context
parallelism over its model axis; FSDP, the pipeline and the hang check are
queued in ROADMAP.md)."""
