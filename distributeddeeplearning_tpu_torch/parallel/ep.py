"""MoE token routing: the JAX package's ``parallel/ep.py`` in torch.

Token-choice top-k routing with a static per-expert capacity (GShard /
Switch): the dispatch one-hot scatters each (token, choice) into a slot of
its expert's buffer, the combine tensor is the dispatch scaled by the
renormalised gate, and overflowing assignments are dropped (an all-zero
row). Routing is deterministic in token order, so a batch row routes the
same whichever rank holds it.

Expert parallelism over ``mesh.ep > 1`` is not ported yet (ROADMAP queue
A13): the experts run on every rank, as the reference's do at ``ep = 1``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def route_top_k(router_probs: torch.Tensor, num_selected: int,
                capacity: int, dtype: torch.dtype | None = None):
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
    """
    g, t, e = router_probs.shape
    dtype = router_probs.dtype if dtype is None else dtype
    gate_vals, expert_idx = top_k_lower_index_first(router_probs,
                                                    num_selected)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    counts = torch.zeros(g, 1, e, dtype=torch.int64,
                         device=router_probs.device)
    cols, keeps = [], []
    for i in range(num_selected):
        onehot_e = F.one_hot(expert_idx[..., i], e)  # [g, t, e]
        pos = torch.cumsum(onehot_e, dim=1) - onehot_e + counts
        slot = (pos * onehot_e).sum(-1)  # [g, t]
        keep = slot < capacity
        # Column of (expert, slot) in the flattened [e * c] axis; a dropped
        # assignment writes 0 to its expert's slot 0 of its own row, which
        # no other choice of the token touches (distinct experts).
        cols.append(expert_idx[..., i] * capacity
                    + torch.where(keep, slot, torch.zeros_like(slot)))
        keeps.append(keep)
        counts = counts + onehot_e.sum(1, keepdim=True)
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
    aux_loss = (e * (fraction * prob_mean).sum(-1)).mean()
    return dispatch, combine, aux_loss, keep.sum()


def check_moe_shapes(num_experts: int, ep: int) -> None:
    if num_experts % ep:
        raise ValueError(
            f"moe: num_experts={num_experts} not divisible by ep={ep}"
        )
