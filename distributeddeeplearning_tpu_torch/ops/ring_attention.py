"""Ring attention, the plain version: context parallelism over the ``cp``
axis (the JAX package's ``ops/ring_attention.py``).

Queries stay on their rank; the KV blocks rotate one neighbour per visit
(:func:`comms.ring_shift`, receive from the +1 neighbour) while each rank
accumulates its queries' attention over the visiting blocks with the
online-softmax recurrence in fp32. Differentiated by autograd: the ring
shift's backward rotates the cotangents the other way.

Causal masking across blocks: rank i's queries own global positions
``[i*L, (i+1)*L)``; at visit t rank i holds the KV block of rank
``(i + t) mod cp``: blocks of lower ranks are fully visible, higher ones
fully hidden, the diagonal block gets the local causal mask. Hidden scores
are masked to -inf BEFORE the exponent, so exp(-inf - m) == 0 exactly and
the where's backward zeroes their cotangents (masking only the exponent's
output would leave an inf in the backward graph: 0 * inf = NaN grads).
"""

from __future__ import annotations

import math

import torch

from ..comms import axis_index, axis_size, ring_shift


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   axis_name: str = "cp"):
    """q, k, v: this rank's ``[batch, seq_local, heads, head_dim]`` blocks
    -> its ``[batch, seq_local, heads, head_dim]`` output, in q's dtype."""
    from ..parallel.sp_ring import check_ring_shapes

    cp, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    b, lq, h, d = q.shape
    check_ring_shapes(lq * cp, cp)
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    dev = q.device
    m = torch.full((b, h, lq), -1e30, device=dev)
    l = torch.zeros((b, h, lq), device=dev)
    acc = torch.zeros((b, h, lq, d), device=dev)
    tril = torch.ones(lq, lq, dtype=torch.bool, device=dev).tril()
    kt, vt = k, v
    for t in range(cp):
        src = (idx + t) % cp
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt.float())
        if not causal or src < idx:
            s_masked = s
        elif src == idx:
            s_masked = torch.where(tril, s, float("-inf"))
        else:  # a later rank's block: hidden, contributes exactly 0
            s_masked = torch.full_like(s, float("-inf"))
        m_new = torch.maximum(m, s_masked.amax(-1))
        p = torch.exp(s_masked - m_new[..., None])
        rescale = torch.exp(m - m_new)
        l = l * rescale + p.sum(-1)
        acc = acc * rescale[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vt.float())
        m = m_new
        if t < cp - 1:  # the last block's rotation would feed nothing
            kt, vt = ring_shift((kt, vt), mesh, axis_name, shift=-1)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
