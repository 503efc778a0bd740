"""Parallel strategies of the port: context parallelism by ring attention
(``sp_ring``), ZeRO-1 over the dp ranks (``zero``) and the MoE routing of
the expert-parallel module (``ep``, at ``mesh.ep = 1``); the JAX package's
other strategies come in later slices."""
