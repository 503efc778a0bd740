"""Collectives over a :class:`mesh.Mesh` axis: the counterpart of the JAX
package's ``comms.py``.

JAX's collectives exist inside a compiled program, where XLA schedules them.
Here they are calls on ``torch.distributed`` groups, made by each rank:

- :func:`psum` / :func:`pmean`: all-reduce over an axis group (or the
  world), the gradient sync and the metric average;
- :func:`pmean_tensors`: the same over many tensors in a few flat buckets;
- :func:`ring_shift`: rotate tensors around an axis ring, the KV rotation of
  ring attention (``lax.ppermute`` in JAX), differentiable: its backward
  shifts the other way, as the transpose of a ``ppermute`` does;
- :func:`axis_index` / :func:`axis_size`.

The transport is the mesh's ``comm``. :class:`DistComm` runs on
``torch.distributed``; under gloo, whose point-to-point copies take CPU
tensors only, CUDA tensors are staged through host memory, and under NCCL
they travel as they are.
"""

from __future__ import annotations

import torch

# Elements of one flat all-reduce bucket (128 MiB of fp32): GPT-2 124M's
# gradients sync in 4 calls, not one per leaf.
BUCKET_ELEMENTS = 1 << 25


class DistComm:
    """The transport of a mesh over ``torch.distributed``: ``groups`` maps
    'world' and every axis larger than 1 to this rank's process group.
    ``stage_on_host``: copy CUDA tensors through host memory (gloo)."""

    def __init__(self, groups: dict, stage_on_host: bool):
        self.groups = groups
        self.stage_on_host = stage_on_host

    def _out(self, t):
        """The tensor handed to the library: a host copy under gloo. The
        copy is synchronous, so every kernel that wrote ``t`` has ended."""
        if self.stage_on_host and t.device.type == "cuda":
            return t.to("cpu")
        return t.contiguous()

    def _buffer(self, t):
        if self.stage_on_host and t.device.type == "cuda":
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        import torch.distributed as dist

        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, group=self.groups[axis])
        return buf.to(t.device, non_blocking=True)

    def shift(self, tensors, axis: str, ranks: list[int], index: int,
              shift: int):
        """Member ``index`` of the ``axis`` ring ``ranks`` (global ranks, in
        ring order) receives each tensor from member ``index - shift`` and
        sends its own to ``index + shift``."""
        import torch.distributed as dist

        n, group = len(ranks), self.groups[axis]
        dst, src = ranks[(index + shift) % n], ranks[(index - shift) % n]
        outs = [self._out(t) for t in tensors]
        bufs = [self._buffer(t) for t in tensors]
        ops = []
        for i, (o, b) in enumerate(zip(outs, bufs)):
            ops.append(dist.P2POp(dist.isend, o, dst, group, tag=i))
            ops.append(dist.P2POp(dist.irecv, b, src, group, tag=i))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [b.to(t.device, non_blocking=True)
                for b, t in zip(bufs, tensors)]

    def gather_objects(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.coords[axis]


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` ('world': every rank)."""
    return mesh.size if axis == "world" else mesh.shape[axis]


def _comm(mesh, what: str):
    if mesh.comm is None:
        raise ValueError(f"{what}: {mesh!r} has no transport for its "
                         f"{mesh.size} ranks")
    return mesh.comm


def psum(x: torch.Tensor, mesh, axis: str = "world") -> torch.Tensor:
    """All-reduce sum over ``axis`` (not differentiated through)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _comm(mesh, "psum").all_reduce_sum(x.detach(), axis)


def pmean(x: torch.Tensor, mesh, axis: str = "world") -> torch.Tensor:
    """All-reduce mean over ``axis``."""
    n = axis_size(mesh, axis)
    return x if n == 1 else psum(x, mesh, axis) / n


def pmean_tensors(tensors: list, mesh, axis: str = "world") -> list:
    """:func:`pmean` of every tensor, through flat fp32 buckets of at most
    :data:`BUCKET_ELEMENTS` (tensors are grouped in order; one larger than
    a bucket gets its own)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    out, start = [], 0
    while start < len(tensors):
        end, count = start, 0
        while end < len(tensors) and (
                end == start or count + tensors[end].numel() <= BUCKET_ELEMENTS):
            count += tensors[end].numel()
            end += 1
        group = tensors[start:end]
        flat = torch.cat([t.reshape(-1).float() for t in group])
        flat = psum(flat, mesh, axis) / n
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            out.append(piece.view(t.shape).to(t.dtype))
        start = end
    return out


def _shift(tensors, mesh, axis: str, shift: int):
    n = axis_size(mesh, axis)
    if n == 1 or shift % n == 0:
        return list(tensors)
    return _comm(mesh, "ring_shift").shift(
        [t.detach() for t in tensors], axis, mesh.axis_ranks(axis),
        axis_index(mesh, axis), shift)


class RingShift(torch.autograd.Function):
    """:func:`ring_shift` under autograd: the backward sends each
    cotangent back the way its tensor came (shift by ``-shift``)."""

    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return tuple(_shift(tensors, mesh, axis, shift))

    @staticmethod
    def backward(ctx, *grads):
        # Unused outputs arrive as zeros (materialized grads), so every
        # member sends the same tensors.
        back = _shift(grads, ctx.mesh, ctx.axis, -ctx.shift)
        return (None, None, None, *back)


def ring_shift(tensors, mesh, axis: str = "cp", *, shift: int = 1) -> list:
    """Rotate ``tensors`` around the ``axis`` ring: member i receives the
    tensors member ``i - shift`` held (mod the axis size), as the JAX
    package's ``ring_shift``. Ring attention passes ``shift=-1``: receive
    from the +1 neighbour, send to the -1. Differentiable."""
    tensors = list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(RingShift.apply(mesh, axis, shift, *tensors))
    return _shift(tensors, mesh, axis, shift)
