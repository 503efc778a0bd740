"""Weights between the JAX package and the port.

The port's modules keep the JAX parameter names and layouts, so a JAX
parameter tree maps to a torch ``state_dict`` by flattening its path:
``{"h": {"block_0": {"attn": {"query": {"kernel": ...}}}}}`` becomes
``"h.block_0.attn.query.kernel"``. :func:`opt_state_from_jax` bridges an
Adam optimizer state the same way. The trees arrive as numpy arrays — this
module imports no JAX.
"""

from __future__ import annotations

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
    ``FusedAdamW``): its count and its mu/nu trees flattened like
    :func:`from_jax_params`, on the device of ``like``'s moments."""
    node = _find_adam_moments(opt_state)
    if node is None:
        raise ValueError("no (count, mu, nu) Adam state in the JAX "
                         "optimizer state")

    def moments(tree, ref):
        flat = from_jax_params(tree)
        if set(flat) != set(ref):
            raise KeyError(f"moment names differ: {sorted(set(flat) ^ set(ref))}")
        return {k: flat[k].to(device=ref[k].device, dtype=torch.float32)
                for k in ref}

    return like._replace(count=int(np.asarray(node.count)),
                         mu=moments(node.mu, like.mu),
                         nu=moments(node.nu, like.nu))
