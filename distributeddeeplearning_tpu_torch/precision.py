"""Mixed-precision dtype policies: fp32 master weights, bf16 compute.

The port of the JAX package's ``precision`` module. A :class:`Policy` splits
the roles of the parameters:

- **master params** (``param_dtype``, fp32): what the optimizer updates;
- **compute copy** (``compute_dtype``): cast from the masters once at the top
  of each step and differentiated directly, so the gradients come back in
  ``compute_dtype`` and are cast up to fp32 before clipping and the update;
- **optimizer moments** (``moment_dtype``): ``bf16_full`` stores Adam's
  moments in bf16, written with stochastic rounding
  (``ops.fused_adamw.stochastic_round``) by ``train.LowPrecisionAdamW``,
  which computes every update in fp32.

The ``fp32`` policy is a no-op: the cast helpers return their input
unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

POLICIES: tuple[str, ...] = ("fp32", "bf16", "bf16_full")


@dataclasses.dataclass(frozen=True)
class Policy:
    """Resolved dtype policy (see the module docstring)."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    moment_dtype: torch.dtype
    stochastic_rounding: bool = False  # of the fp32 -> moment_dtype write

    @property
    def mixed(self) -> bool:
        """True when a distinct compute copy is cast per step."""
        return self.compute_dtype != self.param_dtype


_F32, _BF16 = torch.float32, torch.bfloat16

_POLICY_TABLE = {
    "fp32": Policy("fp32", _F32, _F32, _F32),
    "bf16": Policy("bf16", _F32, _BF16, _F32),
    "bf16_full": Policy("bf16_full", _F32, _BF16, _BF16,
                        stochastic_rounding=True),
}
assert tuple(_POLICY_TABLE) == POLICIES


def get_policy(policy: str | Policy) -> Policy:
    """Resolve a policy name (``train.precision.policy``) to a
    :class:`Policy`; passes an already-resolved Policy through."""
    if isinstance(policy, Policy):
        return policy
    if policy not in _POLICY_TABLE:
        raise ValueError(
            f"train.precision.policy={policy!r} not in {POLICIES} "
            "(fp32 = no-op; bf16 = fp32 masters + bf16 compute; bf16_full "
            "= bf16 compute + bf16 Adam moments with stochastic rounding)"
        )
    return _POLICY_TABLE[policy]


def cast_to_compute(policy: Policy, params: dict) -> dict:
    """Masters -> compute copy for one step: leaf tensors of
    ``compute_dtype`` that the step differentiates. The fp32 policy returns
    the INPUT dict (the masters themselves are differentiated)."""
    if not policy.mixed:
        return params
    return {
        k: (p.detach().to(policy.compute_dtype).requires_grad_()
            if p.is_floating_point() else p)
        for k, p in params.items()
    }


def cast_grads_to_update(policy: Policy, grads: dict) -> dict:
    """Compute-dtype grads -> fp32 for clipping and the update. fp32
    policy: identity."""
    if not policy.mixed:
        return grads
    return {k: g.to(policy.param_dtype) for k, g in grads.items()}


def check_precision_composition(policy: str | Policy, *,
                                optim_name: str | None = None) -> Policy:
    """Config-time fences for the policy x optimizer axis, before anything
    is built: low-precision moments are an ``adamw`` state layout."""
    p = get_policy(policy)
    if p.moment_dtype != p.param_dtype and optim_name is not None:
        if optim_name == "sgd":
            raise ValueError(
                f"precision={p.name!r} x optim.name='sgd' is unsupported: "
                "low-precision moment storage targets Adam's two fp32 "
                "moment trees — use optim.name='adamw' or precision='bf16'"
            )
        if optim_name == "adamw_fused":
            raise ValueError(
                f"precision={p.name!r} x optim.name='adamw_fused' is "
                "unsupported in v1: the fused kernel's moment buffers are "
                "fp32 — use optim.name='adamw' for bf16 moments, or "
                "precision='bf16' to keep the fused kernel"
            )
        if optim_name != "adamw":
            raise ValueError(
                f"precision={p.name!r} requires optim.name='adamw' "
                f"(got {optim_name!r}): low-precision moments are an Adam "
                "state layout"
            )
    return p
