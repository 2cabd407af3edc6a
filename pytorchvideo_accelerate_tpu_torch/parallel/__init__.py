"""Parallelism across processes (the port's copy of what it has of the
JAX package's `parallel/`: the process group and its one rank grid, host
collectives, the (data, model) train mesh and the (data, fsdp, tensor,
context) library mesh, FSDP, tensor parallelism, ring / Ulysses context
parallelism, pipeline stages, and the hang check with its collective
schedule recorder)."""
