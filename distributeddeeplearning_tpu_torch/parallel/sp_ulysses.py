"""Ulysses sequence parallelism: the seq <-> heads all-to-all around the
attention core (the JAX package's ``parallel/sp_ulysses.py``).

Outside attention a cp rank holds its contiguous block of the sequence,
``[batch, seq/cp, heads/tp, head_dim]`` (its tp rank's heads). For the
core every query must see every key, so q, k and v flip to ``[batch, seq,
heads/(tp*cp), head_dim]``: the whole sequence over this rank's share of
its tp rank's heads, one all-to-all over cp each (``comms.all_to_all_dim``);
the output flips back. In JAX the flip is a sharding constraint (the rules
map ``heads_attn -> ('tp', 'cp')`` and ``seq_attn -> None``) that XLA
lowers to the same all-to-alls. A tp rank's heads are its block of the
whole set, and cp member ``c`` takes block ``c`` of those, so rank (t, c)
holds heads block ``t * cp + c`` of ``tp * cp``: JAX's ``('tp', 'cp')``
order.

Requires ``num_heads % (tp * cp) == 0`` and ``seq % cp == 0``. Unlike the
ring (``sp_ring.py``) each rank materializes the whole sequence's scores
for its heads; the core is the plain one or the flash kernels, on which
Ulysses adds nothing but the flips.
"""

from __future__ import annotations

import torch

from .. import comms


def check_ulysses_shapes(num_heads: int, seq_len: int, tp: int,
                         cp: int) -> None:
    """The divisibility Ulysses needs, with the JAX package's messages."""
    if num_heads % (tp * cp):
        raise ValueError(
            f"ulysses: num_heads={num_heads} not divisible by tp*cp={tp * cp}"
        )
    if seq_len % cp:
        raise ValueError(f"ulysses: seq_len={seq_len} not divisible by "
                         f"cp={cp}")


def ulysses_reshard(q, k, v, mesh):
    """This rank's ``[B, L/cp, H/tp, D]`` q, k, v -> ``[B, L, H/(tp*cp),
    D]``: the whole sequence over its share of the heads."""
    return tuple(comms.all_to_all_dim(t, mesh, "cp", 2, 1) for t in (q, k, v))


def ulysses_restore(out, mesh):
    """The inverse flip after the core: ``[B, L, H/(tp*cp), D]`` -> this
    rank's ``[B, L/cp, H/tp, D]``."""
    return comms.all_to_all_dim(out, mesh, "cp", 1, 2)


def gather_mask(mask, mesh):
    """A ``[batch, seq/cp]`` key-padding mask (this rank's block) ->
    ``[batch, seq]``, the keys the core sees after the flip. Not
    differentiated: a mask has no gradient."""
    if mask is None or mesh is None or mesh.shape["cp"] == 1:
        return mask
    # In int32: gloo gathers no bools.
    return comms.all_gather_dim(mask.to(torch.int32), mesh, "cp", 1)


def ulysses_attention(q, k, v, *, flash: bool, causal: bool, dtype, mesh,
                      num_heads: int | None = None, mask=None, dropout=None):
    """The whole Ulysses wrap (shape check, reshard, core, restore), shared
    by ``transformer.SelfAttention`` and ``models/llama.LlamaAttention``.
    q, k, v: this rank's ``[B, L/cp, H/tp, D]`` (Llama's K and V repeated
    to its query heads first). ``flash`` picks the flash core (its kernels
    on the GPU) over the plain one, which alone takes ``mask`` (``[B, L]``,
    the whole sequence's keys: :func:`gather_mask`) and ``dropout``."""
    from ..models.transformer import attention_core

    cp = 1 if mesh is None else mesh.shape["cp"]
    tp = 1 if mesh is None else mesh.shape["tp"]
    if num_heads is not None:
        check_ulysses_shapes(num_heads, q.shape[1] * cp, tp, cp)
    if cp > 1:
        q, k, v = ulysses_reshard(q, k, v, mesh)
    if flash:
        out = attention_core(q, k, v, impl="flash", causal=causal,
                             dtype=dtype)
    else:
        out = attention_core(q, k, v, impl="xla", causal=causal, dtype=dtype,
                             mask=mask, dropout=dropout)
    return out if cp == 1 else ulysses_restore(out, mesh)
