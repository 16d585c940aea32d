"""The plain references of the configurations (one module each, named
by configs/<name>.json's "reference": pathref, nart's path tracer
written out once more), the glue that works a run's kept answers out
again (ref.py), and the lower-precision control (control.py).  Nothing
here imports jax, the JAX package or the program."""
