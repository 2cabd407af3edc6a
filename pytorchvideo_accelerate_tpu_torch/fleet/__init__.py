"""The serving fleet (the port's copy of what it has of the JAX package's
`fleet/`): the continuous-batching EDF scheduler."""
