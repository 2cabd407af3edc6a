"""Data parallelism across processes (the port's copy of what it has of the
JAX package's `parallel/`: the process group, host collectives and the
data axis of the train mesh; the model axis, ring and ulysses attention,
FSDP and the pipeline are queued in ROADMAP.md)."""
