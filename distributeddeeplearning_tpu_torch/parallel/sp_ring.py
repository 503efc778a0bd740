"""Ring attention, context parallelism over the ``cp`` axis: the selection
of a ring implementation (the JAX package's ``parallel/sp_ring.py``).

Each cp rank holds its contiguous block of the sequence; KV blocks rotate
around the ring while each rank folds its queries' attention over the
visiting blocks. Composes with dp (the batch axis) because the ring only
talks within a cp group. Requires mask=None and attention-dropout 0.
"""

from __future__ import annotations


def check_ring_shapes(seq_len: int, cp: int) -> None:
    if seq_len % cp:
        raise ValueError(f"ring: seq_len={seq_len} not divisible by cp={cp}")


def ring_attention_fn(impl: str = "ring"):
    """Select a ring implementation by name.

    ``ring``        the plain per-rank online-softmax loop, differentiated by
                    autograd (the oracle);
    ``ring_pallas`` the same ring with the per-visit block attention in the
                    hand-written kernels of ``csrc/ring_attention.cu``, forward
                    and backward (the name is the reference's).
    Both take ``(q, k, v, mesh, *, causal=...)`` on this rank's
    ``[batch, seq_local, heads, head_dim]`` blocks.
    """
    if impl == "ring":
        from ..ops.ring_attention import ring_attention

        return ring_attention
    if impl == "ring_pallas":
        from ..ops.ring_attention_pallas import ring_attention_pallas

        return ring_attention_pallas
    raise ValueError(f"unknown ring impl {impl!r}")
