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
- :func:`chain_exchange`: one tick of a pipeline's traffic on the open
  chain of an axis (``lax.ppermute`` over ``[(i, i + 1)]`` and its
  reverse in JAX): a tensor to each neighbour and one from each, posted
  together;
- :func:`psum_tensors`: :func:`psum` of many tensors in a few flat buckets;
- the Megatron markers of tensor parallelism, under the JAX package's
  names: :func:`identity_fwd_psum_bwd` (f, the entry of a tp region: the
  identity, whose backward sums the rank's partial input gradients over
  tp) and :func:`psum_identity_bwd` (g, after a row-parallel product: the
  sum over tp, whose backward is the identity), over any axis (a routed
  MLP's ep region, ``models.moe``); and their sequence-parallel
  forms, :func:`all_gather_fwd_reduce_scatter_bwd` (the seq shards
  gathered at a block's entry) and :func:`reduce_scatter_fwd_all_gather_bwd`
  (the partial sums scattered into seq shards at its exit), with
  :func:`all_gather_dim` / :func:`reduce_scatter_dim` beneath them (also
  the fsdp gather of a leaf and the scatter of its gradient);
- :func:`all_to_all_dim`: one dimension cut over an axis's members and
  another gathered, differentiable (its backward is the inverse): Ulysses'
  seq <-> heads flip, which XLA emits from a sharding constraint in JAX;
- :func:`pmax`: all-reduce max (the vocab-parallel softmax's shift);
- :func:`axis_index` / :func:`axis_size`.

The transport is the mesh's ``comm``. :class:`DistComm` runs on
``torch.distributed``; under gloo, whose point-to-point copies take CPU
tensors only, CUDA tensors are staged through host memory, and under NCCL
they travel as they are. Under gloo, bf16 tensors cross in fp32 (exact
both ways; the sum of a bf16 reduction is rounded once, at the end).
:data:`TRANSPORT` counts the calls and the seconds spent inside them (the
rank's wait for the others included; under NCCL, the launch only).
"""

from __future__ import annotations

import time
import warnings

import torch

# Elements of one flat all-reduce bucket (128 MiB of fp32): GPT-2 124M's
# gradients sync in 4 calls, not one per leaf.
BUCKET_ELEMENTS = 1 << 25

# Calls through :class:`DistComm`'s collectives and the seconds inside them
# (``cli train --sync-steps`` reports them a step), and the seconds by
# collective (``by_call``: method name -> seconds).
TRANSPORT = {"calls": 0, "seconds": 0.0, "by_call": {}}


def reset_transport() -> None:
    TRANSPORT.update(calls=0, seconds=0.0, by_call={})


_DEPTH = [0]


def _timed(fn):
    def wrapper(*args, **kwargs):
        if _DEPTH[0]:  # a bf16 call's fp32 crossing: counted once
            return fn(*args, **kwargs)
        _DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1
            dt = time.perf_counter() - t0
            TRANSPORT["calls"] += 1
            TRANSPORT["seconds"] += dt
            by = TRANSPORT["by_call"]
            by[fn.__name__] = by.get(fn.__name__, 0.0) + dt

    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


class DistComm:
    """The transport of a mesh over ``torch.distributed``: ``groups`` maps
    'world' and every axis larger than 1 to this rank's process group.
    ``stage_on_host``: copy CUDA tensors through host memory (gloo)."""

    def __init__(self, groups: dict, stage_on_host: bool):
        self.groups = groups
        self.stage_on_host = stage_on_host
        self._p2p_ready: set = set()

    def _out(self, t):
        """The tensor handed to the library: under gloo a copy in pinned
        host memory (the caching host allocator reuses its blocks, and the
        copy back to the device does not block). The copy is synchronous,
        so every kernel that wrote ``t`` has ended."""
        if self.stage_on_host and t.device.type == "cuda":
            return self._buffer(t).copy_(t)
        return t.contiguous()

    def _buffer(self, t, shape=None):
        """An empty tensor like ``t`` (of ``shape``) for the library to
        write: pinned host memory under gloo."""
        shape = t.shape if shape is None else shape
        if self.stage_on_host and (t.device.type == "cuda" or t.is_pinned()):
            return torch.empty(shape, dtype=t.dtype, pin_memory=True)
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    def _wide(self, t) -> bool:
        """A bf16 tensor under gloo crosses in fp32."""
        return self.stage_on_host and t.dtype == torch.bfloat16

    @_timed
    def all_reduce_sum(self, t: torch.Tensor, axis: str,
                       op: str = "sum") -> torch.Tensor:
        """The sum (``op='max'``: the max) over ``axis`` of ``t``."""
        import torch.distributed as dist

        if self._wide(t):
            return self.all_reduce_sum(t.float(), axis, op).to(t.dtype)
        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, group=self.groups[axis],
                        op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return buf.to(t.device, non_blocking=True)

    @_timed
    def all_reduce_async(self, t: torch.Tensor, axis: str):
        """Post the sum over ``axis`` of the fp32 ``t`` and return at once:
        a callable that waits for it and returns the sum on ``t``'s device
        (its wait counted in :data:`TRANSPORT` as ``all_reduce_wait``)."""
        import torch.distributed as dist

        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        work = dist.all_reduce(buf, group=self.groups[axis], async_op=True)

        def wait() -> torch.Tensor:
            t0 = time.perf_counter()
            work.wait()
            dt = time.perf_counter() - t0
            TRANSPORT["seconds"] += dt
            by = TRANSPORT["by_call"]
            by["all_reduce_wait"] = by.get("all_reduce_wait", 0.0) + dt
            return buf.to(t.device, non_blocking=True)

        return wait

    @_timed
    def reduce_scatter_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk ``i`` of the sum over ``axis`` of the flat ``t`` (whose
        length the axis size divides), on member ``i``."""
        import torch.distributed as dist

        if self._wide(t):
            return self.reduce_scatter_sum(t.float(), axis).to(t.dtype)
        group = self.groups[axis]
        buf = self._out(t)
        out = self._buffer(buf, (buf.numel() // dist.get_world_size(group),))
        with warnings.catch_warnings():  # renamed, not removed, in torch 2.13
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, buf, group=group)
        return out.to(t.device, non_blocking=True)

    @_timed
    def all_gather(self, t: torch.Tensor, axis: str,
                   out: torch.Tensor) -> torch.Tensor:
        """Every member's flat ``t``, in member order, into ``out``. Under
        NCCL ``t`` may be ``out``'s own chunk (NCCL gathers in place); under
        gloo the chunks meet in a host buffer, copied into ``out``."""
        import torch.distributed as dist

        if self._wide(t):
            wide = self.all_gather(t.float(), axis, torch.empty(
                out.shape, dtype=torch.float32, device=out.device))
            return out.copy_(wide)
        buf = self._out(t)
        dst = self._buffer(out) if self.stage_on_host else out
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(dst, buf, group=self.groups[axis])
        if dst is not out:
            out.copy_(dst, non_blocking=True)
        return out

    @_timed
    def all_to_all(self, t: torch.Tensor, axis: str, ranks: list[int],
                   index: int) -> torch.Tensor:
        """``t`` is ``[n, ...]`` over the ``n`` members of ``axis``: member
        ``i`` gets this member's ``t[i]``, and the result's row ``j`` is
        member ``j``'s row for this one (``ranks``, ``index``: the group
        in member order and this member's place, which the group itself
        knows here)."""
        import torch.distributed as dist

        del ranks, index
        if self._wide(t):
            return self.all_to_all(t.float(), axis, None, None).to(t.dtype)
        buf = self._out(t)
        out = self._buffer(buf)
        dist.all_to_all_single(out, buf, group=self.groups[axis])
        return out.to(t.device, non_blocking=True)

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

    def exchange(self, axis: str, ranks: list[int], index: int, sends: dict,
                 recvs: dict, device) -> dict:
        """Member ``index`` of the ``axis`` chain ``ranks`` sends
        ``sends[d]`` to member ``index + d`` and receives a tensor of
        ``recvs[d] = (shape, dtype)`` from member ``index + d`` (d = +1 or
        -1), every transfer posted in one ``batch_isend_irecv`` (blocking
        sends in a fixed order would deadlock two neighbours that both send
        first). Returns ``{d: tensor on device}``."""
        import torch.distributed as dist

        group = self.groups[axis]
        if not self.stage_on_host and axis not in self._p2p_ready:
            # NCCL: the first batched point-to-point call of a group must
            # be joined by all its members, and a tick may have none.
            dist.all_reduce(torch.zeros(1, device=device), group=group)
            self._p2p_ready.add(axis)
        ops, bufs = [], {}
        for d, t in sends.items():
            # tag 0: a message going up the chain, 1: going down
            ops.append(dist.P2POp(dist.isend, self._out(t), ranks[index + d],
                                  group, tag=int(d < 0)))
        for d, (shape, dtype) in recvs.items():
            if self.stage_on_host and torch.device(device).type == "cuda":
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            else:
                buf = torch.empty(shape, dtype=dtype, device=device)
            bufs[d] = buf
            ops.append(dist.P2POp(dist.irecv, buf, ranks[index + d], group,
                                  tag=int(d > 0)))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {d: b.to(device, non_blocking=True) for d, b in bufs.items()}

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
    return _bucketed(tensors, mesh, axis, mean=True)


def psum_tensors(tensors: list, mesh, axis: str = "world") -> list:
    """:func:`psum` of every tensor, in the buckets of
    :func:`pmean_tensors`."""
    return _bucketed(tensors, mesh, axis, mean=False)


def _bucketed(tensors: list, mesh, axis: str, mean: bool) -> list:
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
        flat = psum(torch.cat([t.reshape(-1).float() for t in group]),
                    mesh, axis)
        if mean:
            flat = flat / n
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


def chain_exchange(mesh, axis: str, *, up=None, down=None, from_below=None,
                   from_above=None, device=None) -> tuple:
    """One tick of pipeline traffic on the open chain of ``axis`` (member i
    next to i - 1 and i + 1; no wrap): send ``up`` to member i + 1 and
    ``down`` to i - 1, receive a tensor of ``from_below = (shape, dtype)``
    from i - 1 and one of ``from_above`` from i + 1. None means no
    traffic that way; the ends of the chain have no neighbour past them,
    and nothing is staged for them. Returns (from below, from above), None
    where nothing was received. Not differentiated through."""
    i, n = axis_index(mesh, axis), axis_size(mesh, axis)
    sends, recvs = {}, {}
    if up is not None and i < n - 1:
        sends[1] = up.detach()
    if down is not None and i > 0:
        sends[-1] = down.detach()
    if from_below is not None and i > 0:
        recvs[-1] = from_below
    if from_above is not None and i < n - 1:
        recvs[1] = from_above
    if not sends and not recvs and _comm(mesh, "chain_exchange").stage_on_host:
        return None, None
    got = _comm(mesh, "chain_exchange").exchange(
        axis, mesh.axis_ranks(axis), i, sends, recvs, device)
    return got.get(-1), got.get(1)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce max over ``axis`` (not differentiated through)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _comm(mesh, "pmax").all_reduce_sum(x.detach(), axis, op="max")


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int,
                   size: int | None = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in member order, cut
    to ``size`` along it (a padded last block; default: no cut). Not
    differentiated through. The result is a view of the flat buffer the
    chunks were gathered into (``parallel.fsdp`` reads its storage)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x if size is None else x.narrow(dim, 0, size)
    moved = x.detach().movedim(dim, 0).contiguous()
    flat = all_gather(moved.reshape(-1), mesh, axis)
    out = flat.view(n * moved.shape[0], *moved.shape[1:])
    if size is not None:
        out = out.narrow(0, 0, size)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axis: str, dim: int,
                       block: int | None = None) -> torch.Tensor:
    """This member's block along ``dim`` of the sum over ``axis`` of ``x``
    (member ``i`` keeps rows ``[i*block, (i+1)*block)``; ``x`` is padded
    with zeros up to ``n * block`` rows, default ``block`` = the rows / n).
    Not differentiated through."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    moved = x.detach().movedim(dim, 0)
    rows = moved.shape[0]
    if block is None and rows % n:
        raise ValueError(f"reduce_scatter_dim: {rows} rows over {axis}={n}")
    block = rows // n if block is None else block
    if block * n < rows:
        raise ValueError(f"reduce_scatter_dim: {rows} rows exceed {n} "
                         f"blocks of {block}")
    if block * n != rows:
        pad = moved.new_zeros((block * n - rows, *moved.shape[1:]))
        moved = torch.cat([moved, pad])
    flat = _comm(mesh, "reduce_scatter_dim").reduce_scatter_sum(
        moved.contiguous().reshape(-1), axis)
    return flat.view(block, *moved.shape[1:]).movedim(0, dim)


class _IdentityPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous(), ctx.mesh, ctx.axis), None, None


class _PsumIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def identity_fwd_psum_bwd(x: torch.Tensor, mesh,
                          axis: str = "tp") -> torch.Tensor:
    """Megatron's f, at the entry of a tensor-parallel region where a
    replicated activation fans out into the rank's slices: the identity,
    whose backward sums the slices' shares of the input gradient over
    ``axis``, so every rank gets the whole gradient."""
    if axis_size(mesh, axis) == 1:
        return x
    return _IdentityPsumBwd.apply(x, mesh, axis)


def psum_identity_bwd(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron's g, after a row-parallel product: the sum over ``axis`` of
    the ranks' partial outputs, whose backward is the identity (each rank's
    partial output gets the whole output's gradient, once)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PsumIdentityBwd.apply(x, mesh, axis)


class _GatherScatterBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter_dim(grad, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _ScatterGatherBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return (all_gather_dim(grad, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _GatherSliceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.block = mesh, axis, dim, x.shape[dim]
        return all_gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        lo = axis_index(ctx.mesh, ctx.axis) * ctx.block
        return (grad.narrow(ctx.dim, lo, ctx.block).contiguous(), None,
                None, None)


def all_gather_fwd_slice_bwd(x: torch.Tensor, mesh, axis: str = "tp",
                             dim: int = -1) -> torch.Tensor:
    """The ranks' column slices gathered along ``dim`` into a tensor every
    rank then uses whole and alike (a class-parallel head's logits before
    the loss, a column-parallel product before a LayerNorm): the backward
    keeps this rank's slice of the gradient, which every rank holds whole."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherSliceBwd.apply(x, mesh, axis, dim % x.dim())


def all_gather_fwd_reduce_scatter_bwd(x: torch.Tensor, mesh, axis: str = "tp",
                                      dim: int = 1) -> torch.Tensor:
    """f of sequence parallelism: the ranks' sequence shards gathered along
    ``dim`` at a block's entry; the backward reduce-scatters the gradient
    (each rank's slices contributed to every position) back into shards."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherScatterBwd.apply(x, mesh, axis, dim)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} is not divisible by {axis}={n}")
    # [n, ...]: chunk i of the split dimension goes to member i.
    chunks = x.detach().unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    got = _comm(mesh, "all_to_all").all_to_all(
        chunks.contiguous(), axis, mesh.axis_ranks(axis),
        axis_index(mesh, axis))
    # Row j came from member j: the members in order along concat_dim.
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad, ctx.mesh, ctx.axis, ctx.concat_dim,
                            ctx.split_dim), None, None, None, None)


def all_to_all_dim(x: torch.Tensor, mesh, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """The all-to-all over ``axis``: ``x``'s ``split_dim`` cut into one
    chunk per member, chunk ``i`` sent to member ``i``, and the chunks
    received concatenated along ``concat_dim`` in member order (Ulysses'
    seq <-> heads flip, ``parallel/sp_ulysses.py``). Differentiable: the
    backward is the inverse all-to-all (``concat_dim`` split back to the
    members, their chunks concatenated along ``split_dim``)."""
    if axis_size(mesh, axis) == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def reduce_scatter_fwd_all_gather_bwd(x: torch.Tensor, mesh, axis: str = "tp",
                                      dim: int = 1) -> torch.Tensor:
    """g of sequence parallelism: the ranks' partial sums (a row-parallel
    product, a vocab-parallel lookup) summed over ``axis`` and scattered
    into shards along ``dim``; the backward gathers the shards' gradients."""
    if axis_size(mesh, axis) == 1:
        return x
    if x.shape[dim] % axis_size(mesh, axis):
        raise ValueError(f"sequence parallelism: dimension {dim} of "
                         f"{tuple(x.shape)} is not divisible by {axis}="
                         f"{axis_size(mesh, axis)}")
    return _ScatterGatherBwd.apply(x, mesh, axis, dim)
