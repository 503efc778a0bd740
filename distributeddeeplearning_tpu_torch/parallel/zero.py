"""ZeRO-1: the optimizer state sharded over the data-parallel ranks, as one
flat fp32 buffer per weight-decay group.

The JAX package (``parallel/zero.py``, ``shard_opt_state_shardings``) places
each moment leaf over dp on its first evenly divisible dimension and lets
XLA turn the gradient all-reduce into a reduce-scatter, a shard-local update
and an all-gather of the parameters. Here each rank makes those three calls
itself, over flat buffers:

- :class:`ZeroLayout` fixes the leaf order and the two groups (``decay``:
  the leaves ``fused_adamw.decay_leaf`` decays, ndim >= 2; ``no_decay``:
  the rest), and pads each group's buffer to a multiple of dp x 4 elements,
  so every rank's shard is a whole number of float4s and starts 16-byte
  aligned (the fused AdamW kernel's vector path needs both);
- :meth:`ZeroLayout.bind` makes the model's fp32 master parameters views
  into the group buffers, so the update writes this rank's shard in place
  and one all-gather per group (:meth:`ZeroLayout.gather_params`) gives
  every rank the replicated parameters again;
- :class:`ZeroState` holds this rank's shard of each moment and nothing
  more (fp32, or bf16 under the ``bf16_full`` policy); :meth:`ZeroLayout.shard` cuts a full (params-shaped) tree into this
  rank's shards and :meth:`ZeroLayout.gather` gathers one back onto rank 0
  (checkpoints).

A shard is 1-D, so its weight decay comes from its group, never from its
own ndim.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..comms import all_gather, gather, pmean, psum, reduce_scatter_mean
from ..ops.fused_adamw import decay_leaf

GROUPS = ("decay", "no_decay")
_ALIGN = 4  # fp32 elements in 16 bytes


def group_of(p) -> str:
    """The weight-decay group of a params-shaped leaf."""
    return "decay" if decay_leaf(p) else "no_decay"


class ZeroState(NamedTuple):
    """Adam state of one ZeRO-1 rank: the (count, mu, nu) of
    ``FusedAdamWState`` with mu and nu mapping each group to this rank's
    shard of it (fp32, or ``LowPrecisionAdamW``'s moment dtype), and the
    ``layout`` that cut them."""

    count: int
    mu: dict
    nu: dict
    layout: ZeroLayout


class ZeroLayout:
    """Where every parameter sits in its group's flat buffer, and which
    contiguous shard of each buffer this rank owns over ``axis`` of
    ``mesh``. ``params``: name -> leaf, in the order the buffers follow."""

    def __init__(self, params: dict, mesh, axis: str = "dp",
                 stage_rows=None, shards=None):
        self.mesh, self.axis = mesh, axis
        # A pipeline stage's layout (``parallel.pp.StageRows``): its norm
        # counts every stage, and the shared leaves once.
        self.stage_rows = stage_rows
        self._shared_masks = None
        # A model cut over tp, fsdp or ep (``sharding.ShardLayout``): the
        # leaves here are the rank's blocks; the norm counts each block
        # once, and each leaf replicated over tp, fsdp or ep once.
        self.shards = shards
        self._class_ids = None
        self.n, self.index = mesh.shape[axis], mesh.coords[axis]
        self.shapes = {k: p.shape for k, p in params.items()}
        names = {g: [] for g in GROUPS}
        self.offsets, sizes = {}, dict.fromkeys(GROUPS, 0)
        for k, p in params.items():
            g = group_of(p)
            names[g].append(k)
            self.offsets[k] = sizes[g]
            sizes[g] += p.numel()
        self.names = {g: ks for g, ks in names.items() if ks}
        quantum = self.n * _ALIGN
        self.padded = {g: -(-sizes[g] // quantum) * quantum
                       for g in self.names}
        self.shard_size = {g: n // self.n for g, n in self.padded.items()}
        self.flats = None  # group -> the bound fp32 master buffer

    def shard_slice(self, group: str) -> slice:
        start = self.index * self.shard_size[group]
        return slice(start, start + self.shard_size[group])

    def flatten(self, tree: dict) -> dict:
        """Each group's leaves of a params-shaped ``tree``, in fp32, one
        after another, then zeros up to the padded length (new buffers)."""
        out = {}
        for g, names in self.names.items():
            parts = [tree[k].detach().reshape(-1).float() for k in names]
            used = sum(x.numel() for x in parts)
            parts.append(parts[0].new_zeros(self.padded[g] - used))
            out[g] = torch.cat(parts)
        return out

    def views(self, flats: dict) -> dict:
        """name -> its leaf's view into ``flats`` (a buffer per group)."""
        out = {}
        for g, names in self.names.items():
            for k in names:
                o, shape = self.offsets[k], self.shapes[k]
                out[k] = flats[g][o:o + shape.numel()].view(shape)
        return out

    @torch.no_grad()
    def bind(self, params: dict) -> None:
        """Move ``params`` (fp32 ``nn.Parameter``s) into new flat group
        buffers and make each one a view into its buffer: in-place writes
        to either side show on the other."""
        for k, p in params.items():
            if p.dtype != torch.float32:
                raise TypeError(f"ZeRO-1 keeps fp32 masters: {k} is "
                                f"{p.dtype}")
        self.flats = self.flatten(params)
        for k, v in self.views(self.flats).items():
            params[k].data = v

    def shard(self, tree: dict) -> dict:
        """This rank's shard of each group of a full params-shaped tree
        (new fp32 buffers)."""
        return {g: flat[self.shard_slice(g)].clone()
                for g, flat in self.flatten(tree).items()}

    def gather(self, shards: dict) -> dict | None:
        """The full params-shaped tree of every rank's ``shards`` on member 0
        of the axis, None on every other rank: a collective of the axis
        group, whose members call it. The ranks of the other groups (cp >
        1) hold the same shards and return at once; under pp every stage's
        group gathers its own leaves."""
        if any(c for a, c in self.mesh.coords.items()
               if a not in (self.axis, "pp", "tp", "fsdp", "ep")):
            return None
        # Moved in fp32 (a bf16 shard casts there and back exactly): gloo
        # has no bf16 gather.
        full = {g: gather(s.float(), self.mesh, self.axis)
                for g, s in shards.items()}
        if self.index:
            return None
        dtype = next(iter(shards.values())).dtype
        return {k: v.to(dtype) for k, v in self.views(full).items()}

    def param_shards(self) -> dict:
        """This rank's shard of each bound master buffer, as views."""
        return {g: f[self.shard_slice(g)] for g, f in self.flats.items()}

    def gather_params(self) -> None:
        """Every rank's updated shard into every rank's master buffers."""
        for g, flat in self.flats.items():
            all_gather(flat[self.shard_slice(g)], self.mesh, self.axis,
                       out=flat)

    def reduce_scatter_grads(self, grads: dict) -> dict:
        """This rank's shard of each group of the world-mean gradient:
        the mean over cp first (each cp rank holds the gradient of its own
        block of the sequence), then the reduce-scatter-mean over the
        axis."""
        return {g: reduce_scatter_mean(pmean(flat, self.mesh, "cp"),
                                       self.mesh, self.axis)
                for g, flat in self.flatten(grads).items()}

    def global_norm(self, shards: dict) -> torch.Tensor:
        """The global gradient norm from every rank's shards: sqrt of the
        sum over the axis of each shard's sum of squares (the padding is
        zero and adds nothing); a pipeline stage's over every stage, the
        shared leaves once."""
        if self.shards is not None:
            from .fsdp import CLASSES, whole_sq

            ids = self._classes(next(iter(shards.values())).device)
            sq = torch.stack([torch.stack([
                (s * s)[ids[g] == c].sum() for g, s in shards.items()]).sum()
                for c in range(len(CLASSES))])
            return torch.sqrt(whole_sq(psum(sq, self.mesh, self.axis),
                                       self.mesh))
        if self.stage_rows is None:
            sq = torch.stack([(s * s).sum() for s in shards.values()]).sum()
            return torch.sqrt(psum(sq, self.mesh, self.axis))
        from .pp import whole_sq

        masks = self._shared(next(iter(shards.values())).device)
        sq = [torch.stack([(s * s)[m].sum() for s, m in (
            (shards[g], ~masks[g] if stage else masks[g]) for g in shards)
        ]).sum() for stage in (True, False)]
        stage, shared = psum(torch.stack(sq), self.mesh, self.axis)
        return torch.sqrt(whole_sq(stage, shared, self.mesh))

    def _classes(self, device) -> dict:
        """Per group, the ``parallel.fsdp.CLASSES`` index of the leaf each
        element of this rank's shard belongs to (the padding: 0)."""
        if self._class_ids is None:
            from .fsdp import leaf_class

            out = {}
            for g, names in self.names.items():
                sl = self.shard_slice(g)
                ids = torch.zeros(self.shard_size[g], dtype=torch.int8)
                for k in names:
                    o = self.offsets[k]
                    a = max(o, sl.start)
                    b = min(o + self.shapes[k].numel(), sl.stop)
                    if a < b:
                        ids[a - sl.start:b - sl.start] = leaf_class(
                            self.shards, k)
                out[g] = ids.to(device)
            self._class_ids = out
        return self._class_ids

    def _shared(self, device) -> dict:
        """Per group, True on the elements of this rank's shard that belong
        to a shared (not stage-stacked) leaf."""
        if self._shared_masks is None:
            out = {}
            for g, names in self.names.items():
                sl = self.shard_slice(g)
                m = torch.zeros(self.shard_size[g], dtype=torch.bool)
                for k in names:
                    if k in self.stage_rows.names:
                        continue
                    o = self.offsets[k]
                    a = max(o, sl.start)
                    b = min(o + self.shapes[k].numel(), sl.stop)
                    if a < b:
                        m[a - sl.start:b - sl.start] = True
                out[g] = m.to(device)
            self._shared_masks = out
        return self._shared_masks


class ZeroSGDState(NamedTuple):
    """SGD state of one ZeRO-1 rank: the count and this rank's shard of
    each group's fp32 momentum trace (``train.SGDState``'s layout over the
    groups), and the ``layout`` that cut it."""

    count: int
    trace: dict
    layout: ZeroLayout
