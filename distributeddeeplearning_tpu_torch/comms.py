"""Collectives over a :class:`mesh.Mesh` axis: the counterpart of the JAX
package's ``comms.py``.

JAX's collectives exist inside a compiled program, where XLA schedules them.
Here they are calls on ``torch.distributed`` groups, made by each rank:

- :func:`psum` / :func:`pmean`: all-reduce over an axis group (or the
  world), the gradient sync and the metric average;
  :func:`psum_differentiable` the same under autograd (its backward
  all-reduces the gradient), for synced BatchNorm statistics;
- :func:`pmean_tensors`: the same over many tensors in a few flat buckets;
- :func:`reduce_scatter_mean` / :func:`all_gather`: a flat buffer's mean
  over an axis, each member keeping only its chunk, and the chunks gathered
  back into one buffer: ZeRO-1's gradient sync and parameter gather
  (``parallel/zero.py``), which XLA emits around the sharded update in JAX;
  :func:`gather` the same onto one member (a checkpoint's moments);
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

import warnings

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

    def reduce_scatter_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk ``i`` of the sum over ``axis`` of the flat ``t`` (whose
        length the axis size divides), on member ``i``."""
        import torch.distributed as dist

        group = self.groups[axis]
        buf = self._out(t)
        out = torch.empty(buf.numel() // dist.get_world_size(group),
                          dtype=buf.dtype, device=buf.device)
        with warnings.catch_warnings():  # renamed, not removed, in torch 2.13
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, buf, group=group)
        return out.to(t.device, non_blocking=True)

    def all_gather(self, t: torch.Tensor, axis: str,
                   out: torch.Tensor) -> torch.Tensor:
        """Every member's flat ``t``, in member order, into ``out``. Under
        NCCL ``t`` may be ``out``'s own chunk (NCCL gathers in place); under
        gloo the chunks meet in a host buffer, copied into ``out``."""
        import torch.distributed as dist

        buf = self._out(t)
        dst = self._buffer(out) if self.stage_on_host else out
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(dst, buf, group=self.groups[axis])
        if dst is not out:
            out.copy_(dst, non_blocking=True)
        return out

    def gather(self, t: torch.Tensor, axis: str) -> torch.Tensor | None:
        """Every member's flat ``t``, in member order, on member 0 of
        ``axis`` (in host memory under gloo); None on the others."""
        import torch.distributed as dist

        group = self.groups[axis]
        root = dist.get_global_rank(group, 0)
        buf = self._out(t)
        out = chunks = None
        if dist.get_rank() == root:
            out = torch.empty(buf.numel() * dist.get_world_size(group),
                              dtype=buf.dtype, device=buf.device)
            chunks = list(out.chunk(dist.get_world_size(group)))
        dist.gather(buf, chunks, dst=root, group=group)
        return out

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


class _PsumGrad(torch.autograd.Function):
    """:func:`psum` under autograd: every member's output depends on every
    member's input, so the backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _comm(mesh, "psum").all_reduce_sum(x.detach(), axis)

    @staticmethod
    def backward(ctx, grad):
        return (_comm(ctx.mesh, "psum").all_reduce_sum(grad.contiguous(),
                                                       ctx.axis),
                None, None)


def psum_differentiable(x: torch.Tensor, mesh,
                        axis: str = "world") -> torch.Tensor:
    """All-reduce sum over ``axis`` that autograd differentiates through:
    the backward is the all-reduce sum of the gradient, so a loss that
    reads the sum on every member gets the cross-member terms (synced
    BatchNorm's statistics)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PsumGrad.apply(x, mesh, axis)


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


def reduce_scatter_mean(flat: torch.Tensor, mesh,
                        axis: str = "dp") -> torch.Tensor:
    """This member's chunk of the mean over ``axis`` (of more than one
    member) of the 1-D ``flat``: member ``i`` of ``n`` keeps elements
    ``[i*len/n, (i+1)*len/n)``. The axis size must divide the length."""
    n = axis_size(mesh, axis)
    if flat.dim() != 1 or flat.numel() % n:
        raise ValueError(f"reduce_scatter_mean: {tuple(flat.shape)} is no "
                         f"flat buffer that {axis}={n} divides")
    return _comm(mesh, "reduce_scatter_mean").reduce_scatter_sum(
        flat.detach(), axis) / n


def all_gather(chunk: torch.Tensor, mesh, axis: str = "dp",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The 1-D chunks of every member of ``axis`` (more than one),
    concatenated in member order (the inverse of
    :func:`reduce_scatter_mean`'s split), into ``out`` (a new buffer when
    None)."""
    n = axis_size(mesh, axis)
    if out is None:
        out = torch.empty(chunk.numel() * n, dtype=chunk.dtype,
                          device=chunk.device)
    if out.numel() != chunk.numel() * n:
        raise ValueError(f"all_gather: {n} chunks of {chunk.numel()} do not "
                         f"fill {out.numel()} elements")
    return _comm(mesh, "all_gather").all_gather(chunk.detach(), axis, out)


def gather(chunk: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor | None:
    """:func:`all_gather` onto member 0 of ``axis`` alone: there the chunks
    of every member concatenated in member order (on the chunk's device),
    None on the others."""
    out = _comm(mesh, "gather").gather(chunk.detach(), axis)
    return None if out is None else out.to(chunk.device)


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
