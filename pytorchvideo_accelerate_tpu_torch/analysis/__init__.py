"""Analysis tools of the port (the JAX package's `analysis/`, as far as
ported): `perfdiff.diff_rounds`."""
