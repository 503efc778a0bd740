"""FSDP: each leaf stored as 1/fsdp of itself, gathered whole just before
use, its gradient reduce-scattered back: the counterpart of the JAX
package's ``parallel/fsdp.py``, where the same schedule is XLA's from the
placement rules alone.

Layout: a leaf is cut along the dimension its ``embed`` logical axis names
(``sharding.LOGICAL_AXES``), as JAX shards it, into blocks of ``ceil(E /
fsdp)`` rows (the last padded with zeros where fsdp does not divide);
leaves without an ``embed`` dimension (the query/key/value biases, the
fc_in bias, GPT-2's LayerNorms) stay whole on every fsdp rank, as in JAX.
The batch is split over dp x fsdp (``data.sharded_batches``), so fsdp is
data parallelism whose parameters are sharded.

- :func:`full_param`: a module's leaf gathered whole over fsdp in the
  compute dtype (half the traffic of fp32 under bf16), differentiable: the
  backward reduce-scatters the whole leaf's gradient in fp32 into the
  rank's block, so that block's gradient is the SUM over the fsdp ranks;
- :func:`reshard_after_forward`: around a block's forward, the gathered
  leaves that autograd saves for the backward are saved as a note, not as
  the tensor: they are freed when the block's forward ends and gathered
  again when the block's backward first reads them (ZeRO-3's schedule).
  Under remat the block's checkpoint saves none of them anyway, and its
  recompute gathers them again;
- :func:`reduce_grads`: the rest of the batch-axis mean that the fsdp and tp
  ranks owe before the dp sync (the gradient of a leaf that sequence
  parallelism ran on a seq shard, or that a routed MLP used inside its tp
  region, summed over tp; an fsdp block's summed gradient divided by fsdp;
  the mean over fsdp of a leaf fsdp keeps whole);
- :func:`global_norm` / :func:`whole_sq`: the whole model's gradient norm,
  each tp, fsdp and ep block counted once and each replicated leaf once;
- :func:`sharded_fraction` / :func:`per_device_bytes`: the JAX package's
  inspection helpers, which say that the sharding is real.

The model's leaves that are not under a block (the embeddings, the final
norm, the head) are gathered once a forward and kept through the backward.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch

from .. import comms
from ..sharding import SHARD_AXES, tp_partial

_ACTIVE: list = []  # the open reshard_after_forward scopes, innermost last
# Leaves gathered over fsdp: in a forward, and again in a backward (a
# block's leaves freed after its forward).
GATHERS = {"forward": 0, "backward": 0}


def reset_gathers() -> None:
    GATHERS.update(forward=0, backward=0)


class _Gather(torch.autograd.Function):
    """A leaf's fsdp block -> the whole leaf in ``dtype``; backward: the
    whole gradient reduce-scattered (summed in fp32) into the block."""

    @staticmethod
    def forward(ctx, local, mesh, dim, size, dtype):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.block, ctx.in_dtype = local.shape[dim], local.dtype
        return comms.all_gather_dim(local.detach().to(dtype), mesh, "fsdp",
                                    dim, size)

    @staticmethod
    def backward(ctx, grad):
        g = comms.reduce_scatter_dim(grad.float(), ctx.mesh, "fsdp", ctx.dim,
                                     ctx.block)
        return g.to(ctx.in_dtype), None, None, None, None


def fsdp_gather(local: torch.Tensor, mesh, dim: int, size: int,
                dtype=None) -> torch.Tensor:
    """The whole leaf (``size`` rows on ``dim``) of this rank's fsdp block,
    in ``dtype`` (default the block's), differentiable."""
    dtype = local.dtype if dtype is None else dtype
    full = _Gather.apply(local, mesh, dim, size, dtype)
    GATHERS["forward"] += 1
    if _ACTIVE and torch.is_grad_enabled():
        _ACTIVE[-1].register(full, (local, mesh, dim, size, dtype))
    return full


def full_param(module, name: str, dtype=None, value=None) -> torch.Tensor:
    """``module``'s leaf ``name`` whole: gathered over fsdp when
    ``sharding.shard_model`` cut it (in ``dtype``, the compute dtype), as
    it is otherwise. ``value``: the block to use in place of the module's
    own (a copy the caller differentiates against)."""
    t = getattr(module, name) if value is None else value
    spec = getattr(module, "fsdp_dims", None)
    if not spec or name not in spec:
        return t
    dim, size = spec[name]
    return fsdp_gather(t, module.fsdp_mesh, dim, size,
                       t.dtype if dtype is None else dtype)


class _Regather:
    """What a block's backward reads in place of a gathered leaf: the
    recipe of the gather, and the view of its buffer to take."""

    __slots__ = ("entry", "size", "stride", "offset")

    def __init__(self, entry, t):
        self.entry = entry
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()

    def tensor(self):
        return torch.as_strided(self.entry.base(), self.size, self.stride,
                                self.offset)


class _Entry:
    """One gathered leaf of a block: its gather's arguments, and the buffer
    gathered again for the backward (kept while a saved view needs it)."""

    __slots__ = ("args", "_base")

    def __init__(self, args):
        self.args, self._base = args, None

    def base(self):
        if self._base is None:
            local, mesh, dim, size, dtype = self.args
            with torch.no_grad():
                full = comms.all_gather_dim(local.detach().to(dtype), mesh,
                                            "fsdp", dim, size)
            GATHERS["backward"] += 1
            # The flat buffer the views of the forward's gather were cut
            # from: the same layout, gathered the same way.
            self._base = torch.as_strided(
                full, (full.untyped_storage().nbytes()
                       // full.element_size(),), (1,), 0)
        return self._base


class _Scope:
    def __init__(self):
        self.entries = {}  # storage address -> (_Entry, the gathered leaf)

    def register(self, full, args):
        # The leaf is held until the scope ends: no other tensor can take
        # its storage's address while a saved tensor is matched on it.
        self.entries[full.untyped_storage().data_ptr()] = (_Entry(args), full)

    def pack(self, t):
        hit = self.entries.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        return _Regather(hit[0], t)


def _unpack(x):
    return x.tensor() if isinstance(x, _Regather) else x


@contextlib.contextmanager
def reshard_after_forward(mesh):
    """Around one block's forward: the leaves it gathers over fsdp are
    released when the forward ends, and gathered again in its backward
    (a no-op without fsdp, or without a gradient to take)."""
    if mesh is None or mesh.shape["fsdp"] == 1 or not torch.is_grad_enabled():
        yield
        return
    scope = _Scope()
    _ACTIVE.append(scope)
    try:
        with torch.autograd.graph.saved_tensors_hooks(scope.pack, _unpack):
            yield
    finally:
        _ACTIVE.pop()
        scope.entries.clear()


# ---------------------------------------------------------------------------
# Gradients and norms
# ---------------------------------------------------------------------------


def reduce_grads(grads: dict, layout) -> dict:
    """The tp and fsdp part of the batch-axis mean, before the dp sync
    (``comms.pmean_tensors`` or ZeRO-1's reduce-scatter over dp):

    - under sequence parallelism, each leaf not cut over tp ran on the
      rank's seq shard: its gradient is summed over tp; without it, the
      leaves a routed MLP uses inside its tp region
      (``sharding.TP_PARTIAL``) are;
    - a leaf cut over fsdp has the sum over fsdp from its gather's
      backward: divided by fsdp; a leaf fsdp keeps whole: the mean over
      fsdp.

    A leaf cut over tp needs nothing: its block's gradient is whole. So
    does every leaf over ep: its ranks hold the same rows, and the routed
    MLP's markers make each rank's gradient whole (its experts' blocks)."""
    mesh = layout.mesh
    grads = dict(grads)
    if mesh.shape["tp"] > 1:
        if layout.sequence_parallel:
            names = [k for k in grads if "tp" not in layout.axes_of(k)]
        else:
            names = [k for k in grads if tp_partial(k)]
        grads.update(zip(names, comms.psum_tensors(
            [grads[k] for k in names], mesh, "tp")))
    n = mesh.shape["fsdp"]
    if n > 1:
        whole = [k for k in grads if "fsdp" not in layout.axes_of(k)]
        grads.update(zip(whole, comms.pmean_tensors(
            [grads[k] for k in whole], mesh, "fsdp")))
        for k in grads:
            if "fsdp" in layout.axes_of(k):
                grads[k] = grads[k] / n
    return grads


# The axes a norm's sums of squares meet over: the sharded ones, and pp
# for a pipeline stage's rows.
NORM_AXES = SHARD_AXES + ("pp",)
# The classes of a leaf by the live axes that cut it: a norm's sums of
# squares are kept apart by class until they meet over those axes.
CLASSES = tuple(c for n in range(len(NORM_AXES) + 1)
                for c in itertools.combinations(NORM_AXES, n))


def leaf_class(layout, name: str) -> int:
    axes = set(layout.norm_axes(name)) if layout is not None else set()
    return next(i for i, c in enumerate(CLASSES) if set(c) == axes)


def whole_sq(sq: torch.Tensor, mesh) -> torch.Tensor:
    """The whole model's squared norm from one rank's sums of squares by
    class (``[len(CLASSES)]``): a class cut over an axis sums over it, a
    class whole on an axis counts member 0's copy. Every rank gets the same
    value, so every rank takes the same clip and health decision."""
    for axis in NORM_AXES:
        if mesh.shape[axis] == 1:
            continue
        keep = torch.tensor([axis in c or mesh.coords[axis] == 0
                             for c in CLASSES], device=sq.device)
        sq = comms.psum(torch.where(keep, sq, torch.zeros_like(sq)), mesh,
                        axis)
    return sq.sum()


def global_norm(grads: dict, layout) -> torch.Tensor:
    """The whole model's gradient norm from one rank's blocks."""
    device = next(iter(grads.values())).device
    sq = torch.zeros(len(CLASSES), dtype=torch.float32, device=device)
    for k, g in grads.items():
        sq[leaf_class(layout, k)] += torch.linalg.vector_norm(g.float()) ** 2
    return torch.sqrt(whole_sq(sq, layout.mesh))


# ---------------------------------------------------------------------------
# Inspection
# ---------------------------------------------------------------------------


def sharded_fraction(model, axis: str) -> float:
    """The fraction of the model's (whole) elements in leaves cut over
    ``axis``: the JAX package's load-bearing check that tp or fsdp is on
    (parity alone passes with replicated leaves). A leaf counts only where
    the axis is larger than 1. ``model``: a model, or its layout."""
    from ..sharding import ShardLayout

    layout = (model if isinstance(model, ShardLayout)
              else getattr(model, "shards", None))
    if layout is None:
        return 0.0
    total = sum(math.prod(s) for s in layout.whole.values())
    cut = sum(math.prod(s) for k, s in layout.whole.items()
              if axis in layout.axes_of(k))
    return cut / max(total, 1)


def per_device_bytes(model) -> int:
    """The bytes of the parameters this rank holds (its blocks, padding
    included): the JAX package's per-device footprint of the params."""
    return sum(p.numel() * p.element_size() for p in model.parameters())
