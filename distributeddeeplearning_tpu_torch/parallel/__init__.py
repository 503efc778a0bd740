"""Parallel strategies of the port. This slice carries context parallelism
by ring attention (``sp_ring``); the JAX package's other strategies come in
later slices."""
