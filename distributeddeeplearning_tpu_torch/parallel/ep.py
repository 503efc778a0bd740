"""MoE token routing: the JAX package's ``parallel/ep.py`` in torch.

Token-choice top-k routing with a static per-expert capacity (GShard /
Switch): the dispatch one-hot scatters each (token, choice) into a slot of
its expert's buffer, the combine tensor is the dispatch scaled by the
renormalised gate, and overflowing assignments are dropped (an all-zero
row). Routing is deterministic in token order, so a batch row routes the
same whichever rank holds it.

Over ``mesh.ep > 1`` (the JAX package's ``expert`` logical axis on the
``ep`` mesh axis) every ep rank holds the same rows and routes them alike;
a rank runs the experts of :func:`expert_range` over its columns of the
dispatch and sums its share of the combine over ep (``models.moe``).

Over ``mesh.cp > 1`` a rank holds one block of each row, while the
reference routes the row whole. :func:`route_top_k` then carries the
counts of the assignments queued ahead of the block (:func:`carried_counts`,
one all-gather over cp), takes the capacity from the whole row, and means
the aux loss's two factors over cp before their product, so each block's
slots and the aux loss are the whole row's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import comms


def expert_capacity(tokens_per_group: int, num_experts: int,
                    num_selected: int, capacity_factor: float) -> int:
    """Per-expert buffer length (static)."""
    return max(1, int(math.ceil(
        tokens_per_group * num_selected * capacity_factor / num_experts)))


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equals. ``torch.topk`` promises no order among ties;
    a stable descending sort does."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_range(num_experts: int, mesh) -> tuple[int, int]:
    """(first expert, count) of this rank's experts over ep."""
    ep = 1 if mesh is None else mesh.shape["ep"]
    check_moe_shapes(num_experts, ep)
    n = num_experts // ep
    return (0 if ep == 1 else mesh.coords["ep"] * n), n


def carried_counts(onehots: list, mesh=None) -> torch.Tensor:
    """``[k, g, 1, e]``: for choice ``i``, the assignments queued at each
    expert ahead of this rank's block of each row: choices before ``i``
    over the whole row, and choice ``i`` in the blocks of the lower cp
    ranks. ``onehots``: the k choices' ``[g, t, e]`` integer one-hots of
    the block. At cp = 1 (the block is the row) this is the reference's
    running count of the earlier choices; over cp one all-gather of the
    blocks' ``[k, g, e]`` counts gives both terms."""
    local = torch.stack([o.sum(1) for o in onehots])  # [k, g, e]
    cp = 1 if mesh is None else mesh.shape["cp"]
    if cp == 1:
        ahead, whole = torch.zeros_like(local), local
    else:
        every = comms.all_gather(local.reshape(-1), mesh, "cp").view(
            cp, *local.shape)
        ahead = every[:mesh.coords["cp"]].sum(0)
        whole = every.sum(0)
    return (torch.cumsum(whole, 0) - whole + ahead)[:, :, None, :]


def route_top_k(router_probs: torch.Tensor, num_selected: int,
                capacity: int, dtype: torch.dtype | None = None, mesh=None):
    """Token-choice top-k routing with per-group capacity.

    ``router_probs``: [groups, tokens, experts] softmax outputs. Returns
    (dispatch, combine, aux_loss, kept):

    - dispatch: [g, t, e, c] one-hot, token t of group g occupying slot c
      of expert e (an all-zero row: a dropped token);
    - combine: the same shape, the dispatch scaled by the gate (the top-k
      probabilities renormalised over the k, floor 1e-9), differentiable
      in the gates;
    - aux_loss: the Switch load-balancing loss over FIRST choices, the mean
      over groups of ``e * sum_e fraction_e * mean_prob_e``;
    - kept: the count of (token, choice) assignments not dropped.

    A choice's slot is the count of earlier tokens bound for the same
    expert in this choice, plus what the earlier choices of every token
    already queued there: choice 0 of every token is placed before choice
    1 of any. ``dtype`` (default the probs') is that of dispatch and
    combine: each (e, c) slot holds at most one (token, choice) and a
    token's choices go to distinct experts, so every entry is 1.0 or one
    gate, and building them in the compute dtype equals the reference's
    fp32 tensors cast to it. They are built by a scatter into zeros, the
    reference's products of one-hots without their fp32 temporaries.

    On a ``mesh`` with cp > 1, ``router_probs`` is this rank's block of
    each row and ``capacity`` the whole row's: the slots, the aux loss and
    ``kept`` are the whole row's (``kept`` summed over the blocks).
    """
    g, t, e = router_probs.shape
    dtype = router_probs.dtype if dtype is None else dtype
    cp = 1 if mesh is None else mesh.shape["cp"]
    gate_vals, expert_idx = top_k_lower_index_first(router_probs,
                                                    num_selected)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    onehots = [F.one_hot(expert_idx[..., i], e)  # [g, t, e] each
               for i in range(num_selected)]
    counts = carried_counts(onehots, mesh)
    cols, keeps = [], []
    for i, onehot_e in enumerate(onehots):
        pos = torch.cumsum(onehot_e, dim=1) - onehot_e + counts[i]
        slot = (pos * onehot_e).sum(-1)  # [g, t]
        keep = slot < capacity
        # Column of (expert, slot) in the flattened [e * c] axis; a dropped
        # assignment writes 0 to its expert's slot 0 of its own row, which
        # no other choice of the token touches (distinct experts).
        cols.append(expert_idx[..., i] * capacity
                    + torch.where(keep, slot, torch.zeros_like(slot)))
        keeps.append(keep)
    index = torch.stack(cols, -1).reshape(g * t, num_selected)
    keep = torch.stack(keeps, -1)  # [g, t, k]
    ones = keep.to(dtype).reshape(g * t, num_selected)
    gates = (gate_vals * keep).to(dtype).reshape(g * t, num_selected)
    flat = torch.zeros(g * t, e * capacity, dtype=dtype,
                       device=router_probs.device)
    dispatch = flat.scatter(1, index, ones).reshape(g, t, e, capacity)
    combine = flat.scatter(1, index, gates).reshape(g, t, e, capacity)

    first = F.one_hot(expert_idx[..., 0], e).to(router_probs.dtype)
    fraction = first.mean(1)  # [g, e]: tokens whose top-1 is e
    prob_mean = router_probs.mean(1)  # [g, e]
    kept = keep.sum()
    if cp > 1:
        # Each factor's mean over the whole row (equal blocks: the mean of
        # the blocks' means) before the product. prob_mean keeps its own
        # block's gradient: the step's mean over cp of every block's
        # gradient is then the whole row's.
        both = comms.psum(torch.cat([
            fraction, prob_mean.detach(),
            kept.to(fraction.dtype).reshape(1, 1).expand(1, e)]), mesh, "cp")
        fraction = both[:g] / cp
        prob_mean = prob_mean + (both[g:2 * g] / cp - prob_mean).detach()
        kept = both[2 * g, 0].round().to(kept.dtype)
    aux_loss = (e * (fraction * prob_mean).sum(-1)).mean()
    return dispatch, combine, aux_loss, kept


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The identity, whose backward scales the gradient by ``scale``: a
    term every rank of a group computes whole, inside a region whose
    backward sums the group's partial gradients, enters that sum once
    (``scale`` = 1 / the group's size)."""
    if scale == 1:
        return x
    return _ScaleGrad.apply(x, scale)


def check_moe_shapes(num_experts: int, ep: int) -> None:
    if num_experts % ep:
        raise ValueError(
            f"moe: num_experts={num_experts} not divisible by ep={ep}"
        )
