"""Weights between the JAX package and the port.

The port's modules keep the JAX parameter names and layouts, so a JAX
parameter tree maps to a torch ``state_dict`` by flattening its path:
``{"h": {"block_0": {"attn": {"query": {"kernel": ...}}}}}`` becomes
``"h.block_0.attn.query.kernel"``. :func:`opt_state_from_jax` bridges an
Adam optimizer state the same way, and :func:`state_from_jax` a whole
training state, onto any mesh. The trees arrive as numpy arrays — this
module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def from_jax_params(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested dict of numpy arrays (a JAX ``params`` tree, unboxed and
    pulled to the host) -> a flat ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for key, leaf in tree.items():
        name = f"{prefix}{key}"
        if hasattr(leaf, "items"):
            out.update(from_jax_params(leaf, f"{name}."))
            continue
        out[name] = torch.from_numpy(np.array(leaf, copy=True))
    return out


def _find_adam_moments(opt_state):
    """The (count, mu, nu) node of a JAX optimizer state: a
    ``FusedAdamWState`` itself, or optax.adamw's ``ScaleByAdamState`` inside
    the chain (clip, adam, mask, schedule) around it."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_moments(item)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, like):
    """A JAX Adam optimizer state (numpy leaves) -> the port's state of the
    same kind as ``like`` (``tx.init(params)`` of the port's ``AdamW`` or
    ``FusedAdamW``, or a ZeRO-1 rank's ``tx.init_shard(layout)``): its count
    and its mu/nu trees flattened like :func:`from_jax_params` (and cut to
    the rank's shards under ZeRO-1), on the device of ``like``'s
    moments."""
    from .parallel.zero import ZeroState

    node = _find_adam_moments(opt_state)
    if node is None:
        raise ValueError("no (count, mu, nu) Adam state in the JAX "
                         "optimizer state")
    sharded = isinstance(like, ZeroState)
    names = set(like.layout.shapes) if sharded else set(like.mu)

    def moments(tree, ref):
        flat = from_jax_params(tree)
        if set(flat) != names:
            raise KeyError(f"moment names differ: {sorted(set(flat) ^ names)}")
        if sharded:
            flat = like.layout.shard(flat)
        return {k: flat[k].to(device=ref[k].device, dtype=torch.float32)
                for k in ref}

    return like._replace(count=int(np.asarray(node.count)),
                         mu=moments(node.mu, like.mu),
                         nu=moments(node.nu, like.nu))


@torch.no_grad()
def state_from_jax(jax_state, like):
    """A JAX ``TrainState`` pulled to the host (numpy leaves: ``params``,
    ``opt_state``, ``step``) -> the port's ``TrainState`` on any mesh: the
    params copied in place into ``like``'s (a trainer's ``init``, whose
    masters may be views into ZeRO-1 buffers), the Adam moments through
    :func:`opt_state_from_jax`. The root dropout seed stays ``like``'s:
    JAX's key has no torch counterpart."""
    params = from_jax_params(jax_state.params)
    if set(params) != set(like.params):
        raise KeyError(f"param names differ: "
                       f"{sorted(set(params) ^ set(like.params))}")
    for k, p in like.params.items():
        p.copy_(params[k])
    return dataclasses.replace(
        like, step=int(np.asarray(jax_state.step)),
        opt_state=opt_state_from_jax(jax_state.opt_state, like.opt_state))
