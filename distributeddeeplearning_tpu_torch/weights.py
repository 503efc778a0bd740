"""Weights between the JAX package and the port.

The port's modules keep the JAX parameter names and layouts, so a JAX
parameter tree maps to a torch ``state_dict`` by flattening its path:
``{"h": {"block_0": {"attn": {"query": {"kernel": ...}}}}}`` becomes
``"h.block_0.attn.query.kernel"``. A module that keeps a weight in
torch's layout names it ``weight`` where flax names it ``kernel``
(:func:`to_torch_layout`: a conv's HWIO kernel becomes OIHW, a Dense's
[in, out] kernel [out, in]). :func:`opt_state_from_jax` bridges an Adam or
SGD optimizer state the same way, and :func:`state_from_jax` a whole
training state (with a model's BatchNorm ``batch_stats``), onto any mesh.
A pipelined model's stage-stacked leaves (``h.stages.block_j...``, leading
``[num_stages]``) keep their names; :func:`rank_rows` gives a rank its
rows of them, ``[s*S/pp, (s+1)*S/pp)``; :func:`rank_shards` a rank's
blocks of the leaves of a model cut over tp or fsdp (``model.shards``), so
JAX's whole params load into any mesh. The trees arrive as numpy arrays —
this module imports no JAX.
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
        out[name] = _to_torch(leaf)
    return out


def _to_torch(leaf) -> torch.Tensor:
    """A numpy leaf as a new tensor; bfloat16 (numpy's ``ml_dtypes``
    extension type, which torch cannot read) by its bits."""
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def rank_rows(flat: dict, rows) -> dict:
    """``flat`` with each stage-stacked leaf cut to the rows this rank of a
    pipeline holds (``rows``: a pipelined model's ``stage_rows``; None
    leaves ``flat`` whole): ``[1, ...]`` on ``pp = num_stages`` ranks, the
    whole ``[S, ...]`` at ``pp = 1``."""
    return flat if rows is None else rows.take(flat)


def rank_shards(flat: dict, shards) -> dict:
    """``flat`` (whole leaves, e.g. JAX's params) with each leaf of a model
    cut over tp or fsdp cut to this rank's block (``shards``: the model's
    ``sharding.ShardLayout``; None leaves ``flat`` whole)."""
    return flat if shards is None else shards.take(flat)


def to_torch_layout(flat: dict, names) -> dict:
    """``flat`` (flattened JAX names) with every ``<m>.kernel`` that
    ``names`` holds as ``<m>.weight`` renamed and transposed to torch's
    layout: HWIO -> OIHW, [in, out] -> [out, in]. Other leaves pass as
    they are."""
    out = {}
    for k, v in flat.items():
        torch_name = k.removesuffix("kernel") + "weight"
        if k.endswith(".kernel") and k not in names and torch_name in names:
            k, v = torch_name, (v.permute(3, 2, 0, 1) if v.dim() == 4
                                else v.t())
        out[k] = v
    return out


def _find_node(opt_state, fields):
    """The first node of a JAX optimizer state that has every field of
    ``fields`` (as data: every tuple has a ``count`` method), searching the
    chain's tuples depth first."""
    if all(not callable(getattr(opt_state, f, len)) for f in fields):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_node(item, fields)
            if found is not None:
                return found
    return None


def _find_adam_moments(opt_state):
    """The (count, mu, nu) node of a JAX optimizer state: a
    ``FusedAdamWState`` itself, or optax.adamw's ``ScaleByAdamState`` inside
    the chain (clip, adam, mask, schedule) around it."""
    return _find_node(opt_state, ("count", "mu", "nu"))


def _sgd_state_from_jax(opt_state, like, rows=None, shards=None):
    """optax.sgd's state inside the chain (clip, masked decay, trace,
    schedule): the ``TraceState``'s momentum trace and the schedule's
    ``count``, onto ``like`` (the port's ``SGD.init``)."""
    trace, count = _find_node(opt_state, ("trace",)), None
    if trace is not None:
        count = _find_node(opt_state, ("count",))
    if trace is None or count is None:
        raise ValueError("no (trace, count) SGD state in the JAX optimizer "
                         "state")
    flat = rank_shards(rank_rows(to_torch_layout(
        from_jax_params(trace.trace), set(like.trace)), rows), shards)
    if set(flat) != set(like.trace):
        raise KeyError(f"trace names differ: "
                       f"{sorted(set(flat) ^ set(like.trace))}")
    return like._replace(count=int(np.asarray(count.count)), trace={
        k: flat[k].to(device=t.device, dtype=t.dtype)
        for k, t in like.trace.items()})


def opt_state_from_jax(opt_state, like, rows=None, shards=None):
    """A JAX Adam or SGD optimizer state (numpy leaves) -> the port's state
    of the same kind as ``like`` (``tx.init(params)`` of the port's
    ``AdamW``, ``FusedAdamW`` or ``SGD``, or a ZeRO-1 rank's
    ``tx.init_shard(layout)``). SGD: its momentum trace and count. Adam:
    its count and its mu/nu trees flattened like :func:`from_jax_params`
    (cut to a pipeline rank's ``rows``, or to its tp/fsdp blocks, then to
    the rank's shards under ZeRO-1), on the device and in the dtype of
    ``like``'s moments."""
    from .parallel.zero import ZeroState

    if hasattr(like, "trace"):
        return _sgd_state_from_jax(opt_state, like, rows, shards)
    node = _find_adam_moments(opt_state)
    if node is None:
        raise ValueError("no (count, mu, nu) Adam state in the JAX "
                         "optimizer state")
    sharded = isinstance(like, ZeroState)
    names = set(like.layout.shapes) if sharded else set(like.mu)

    def moments(tree, ref):
        flat = rank_shards(rank_rows(from_jax_params(tree), rows), shards)
        if set(flat) != names:
            raise KeyError(f"moment names differ: {sorted(set(flat) ^ names)}")
        if sharded:
            flat = like.layout.shard(flat)
        return {k: flat[k].to(device=ref[k].device, dtype=ref[k].dtype)
                for k in ref}

    return like._replace(count=int(np.asarray(node.count)),
                         mu=moments(node.mu, like.mu),
                         nu=moments(node.nu, like.nu))


@torch.no_grad()
def state_from_jax(jax_state, like):
    """A JAX ``TrainState`` pulled to the host (numpy leaves: ``params``,
    ``opt_state``, ``model_state``, ``step``) -> the port's ``TrainState``
    on any mesh: the params copied in place into ``like``'s (a trainer's
    ``init``, whose masters may be views into ZeRO-1 buffers) in torch's
    layout (:func:`to_torch_layout`; a pipeline rank's rows of the stage
    leaves, ``like.stage_rows``; a tp/fsdp rank's blocks, ``like.shards``),
    the BatchNorm ``batch_stats`` into
    ``like.model_state``, the optimizer state through
    :func:`opt_state_from_jax`. The root dropout seed stays ``like``'s:
    JAX's key has no torch counterpart."""
    rows = getattr(like, "stage_rows", None)
    shards = getattr(like, "shards", None)
    for name, tree, into in (
            ("param", jax_state.params, like.params),
            ("model_state",
             dict(getattr(jax_state, "model_state", None) or {}).get(
                 "batch_stats", {}), like.model_state)):
        flat = rank_shards(rank_rows(to_torch_layout(
            from_jax_params(tree), set(into)), rows), shards)
        if set(flat) != set(into):
            raise KeyError(f"{name} names differ: "
                           f"{sorted(set(flat) ^ set(into))}")
        for k, t in into.items():
            t.copy_(flat[k])
    return dataclasses.replace(
        like, step=int(np.asarray(jax_state.step)),
        opt_state=opt_state_from_jax(jax_state.opt_state, like.opt_state,
                                     rows, shards))
