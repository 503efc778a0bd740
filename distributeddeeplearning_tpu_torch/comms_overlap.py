"""Bucketed gradient collectives and the sharded weight update: the
counterpart of the JAX package's ``comms_overlap.py``.

**Bucketing** (``train.grad_bucket_mb``): the gradient tree is partitioned
into size-targeted flat buckets in REVERSE flatten order (the backward
produces the last layers' gradients first), and each bucket gets its own
collective. On the flat fp32 replicated sync a bucket's all-reduce is
posted from the backward as soon as its last gradient is ready
(:class:`PostedBuckets`, ``async_op=True``), so it runs while the backward
computes the buckets before it; the other syncs run after the backward.

**Weight-update sharding** (``train.update_sharding='sharded'``): each
bucket's sync is a reduce-scatter, each dp rank advances the optimizer
state of its 1/n flat shard of every bucket (the state lives in that
layout for the life of the run), and an all-gather per bucket rebuilds the
replicated params.

Wire formats compose: fp32 buckets use the plain collectives; bf16/int8
buckets ride the ``comms_quant`` codec's ring with a per-bucket
error-feedback residual (``TrainState.grad_residual`` is then a tuple of
this rank's flat ``[padded]`` buffers).

The layout follows the JAX package's flatten order and layout
(``comms_quant.ravel_tree``): bucket ``b``'s flat buffer holds the same
elements in the same places as JAX's, so its padding, its chunks and its
int8 blocks are the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .comms_quant import (
    DEFAULT_BLOCK_SIZE,
    _compress,
    _compression_error,
    _decompress,
    compression_ratio,
    from_jax_layout,
    jax_order,
    jax_shape,
    quantized_all_reduce_flat,
    quantized_reduce_scatter_flat,
    to_jax_layout,
)

UPDATE_SHARDING_MODES: tuple[str, ...] = ("replicated", "sharded")


# ---------------------------------------------------------------------------
# Bucket layout: static partition of a param/grad tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static partition of a tree's leaves into flat, padded buckets.

    ``names`` lists the tree's leaves in JAX's flatten order; ``buckets[b]``
    lists indices into it in REVERSE order (bucket 0 holds the last
    layers). Every bucket's flat f32 buffer is zero-padded to
    ``padded_sizes[b]``, a multiple of ``n_members * block_size``.
    ``shapes`` and ``dtypes`` are the port's leaves' (torch layout)."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple
    buckets: tuple[tuple[int, ...], ...]
    padded_sizes: tuple[int, ...]
    n_members: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def shard_sizes(self) -> tuple[int, ...]:
        """Per-member flat-shard length of each bucket."""
        return tuple(p // self.n_members for p in self.padded_sizes)

    def bucket_flat(self, tree: dict) -> list[torch.Tensor]:
        """Tree -> one flat padded f32 buffer per bucket."""
        out = []
        for b, idxs in enumerate(self.buckets):
            parts = [to_jax_layout(self.names[i], tree[self.names[i]])
                     .reshape(-1).float() for i in idxs]
            pad = self.padded_sizes[b] - sum(p.numel() for p in parts)
            if pad:
                parts.append(parts[0].new_zeros(pad))
            out.append(torch.cat(parts))
        return out

    def unbucket(self, flats) -> dict:
        """Inverse of :meth:`bucket_flat` — the port's names, shapes AND
        dtypes (the padding tail is dropped)."""
        sizes = self.sizes
        leaves = {}
        for b, idxs in enumerate(self.buckets):
            off = 0
            for i in idxs:
                name = self.names[i]
                seg = flats[b][off:off + sizes[i]].reshape(
                    jax_shape(name, self.shapes[i]))
                leaves[name] = from_jax_layout(name, seg).to(self.dtypes[i])
                off += sizes[i]
        return {k: leaves[k] for k in self.names}

    def local_shards(self, tree: dict, member_index: int) -> tuple:
        """Member ``member_index``'s 1/n flat slice of each bucket — the
        chunk the reduce-scatter assigns it."""
        shard = self.shard_sizes
        return tuple(f[member_index * shard[b]:(member_index + 1) * shard[b]]
                     for b, f in enumerate(self.bucket_flat(tree)))

    def stacked_shards(self, tree: dict) -> tuple:
        """``[n_members, shard]`` view of every member's flat shard per
        bucket (row ``i`` is member ``i``'s shard)."""
        return tuple(f.reshape(self.n_members, -1)
                     for f in self.bucket_flat(tree))

    def wire_bytes(self, mode: str, block_size: int = DEFAULT_BLOCK_SIZE):
        """Per-bucket wire payload bytes of one sync under ``mode`` (the f32
        padded size scaled by the codec's compression ratio)."""
        r = compression_ratio(mode, block_size)
        return tuple(int(p * 4 * r) for p in self.padded_sizes)

    def signature(self) -> dict:
        """What a checkpoint's per-bucket residuals are tied to."""
        return {"n_members": self.n_members,
                "padded_sizes": list(self.padded_sizes),
                "buckets": [list(b) for b in self.buckets]}


def build_bucket_layout(tree: dict, bucket_mb: float, *, n_members: int,
                        block_size: int = DEFAULT_BLOCK_SIZE) -> BucketLayout:
    """Greedy reverse-order packing: walk leaves from the LAST flatten index
    down, close a bucket as soon as its accumulated f32 bytes reach
    ``bucket_mb`` MiB. ``bucket_mb <= 0`` means one bucket holding
    everything (still reverse order). Reads only shapes and dtypes."""
    names = tuple(jax_order(tree))
    if not names:
        raise ValueError("cannot bucket an empty pytree")
    shapes = tuple(tuple(tree[k].shape) for k in names)
    dtypes = tuple(tree[k].dtype for k in names)
    target = float("inf") if bucket_mb <= 0 else bucket_mb * 2**20
    buckets: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_bytes = 0.0
    for i in reversed(range(len(names))):
        cur.append(i)
        cur_bytes += math.prod(shapes[i]) * 4
        if cur_bytes >= target:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0.0
    if cur:
        buckets.append(tuple(cur))
    multiple = n_members * block_size
    padded = tuple(
        max(multiple,
            -(-sum(math.prod(shapes[i]) for i in b) // multiple) * multiple)
        for b in buckets)
    return BucketLayout(names=names, shapes=shapes, dtypes=dtypes,
                        buckets=tuple(buckets), padded_sizes=padded,
                        n_members=n_members)


# ---------------------------------------------------------------------------
# Per-bucket error feedback
# ---------------------------------------------------------------------------


def _ef_flat(flat: torch.Tensor, res, mode: str, block_size: int):
    """EF-SGD on one padded flat bucket: compress ``flat + res``, return
    ``(decompressed, new_res)``; ``res=None`` / fp32 wire: EF off."""
    if res is None or mode == "fp32":
        return flat, res
    total = flat + res
    payload = _compress(total, mode, block_size)
    return (_decompress(payload, mode),
            _compression_error(total, payload, mode))


def zeros_bucket_residuals(layout: BucketLayout, device=None) -> tuple:
    """This rank's per-bucket EF residual buffers, zeros: one ``[padded]``
    f32 vector per bucket (the JAX package stacks every member's into
    ``[n_devices, padded]``; here each rank holds its own row)."""
    return tuple(torch.zeros(p, dtype=torch.float32, device=device)
                 for p in layout.padded_sizes)


# ---------------------------------------------------------------------------
# Bucketed collectives
# ---------------------------------------------------------------------------


def bucketed_all_reduce(grads: dict, layout: BucketLayout, mesh,
                        axis: str = "dp", *, mode: str = "fp32",
                        block_size: int = DEFAULT_BLOCK_SIZE,
                        residuals=None):
    """All-reduce-sum a gradient tree as one collective per bucket. Returns
    ``(summed_tree, new_residuals)`` — divide by the axis size for the
    mean. Lossy wire: the compressed ring per bucket, with per-bucket EF
    via ``residuals`` (None: no EF)."""
    out, new_res = [], []
    for b, flat in enumerate(layout.bucket_flat(grads)):
        res = residuals[b] if residuals is not None else None
        sent, r = _ef_flat(flat, res, mode, block_size)
        out.append(quantized_all_reduce_flat(sent, mesh, axis, mode=mode,
                                             block_size=block_size))
        new_res.append(r)
    return layout.unbucket(out), (
        tuple(new_res) if residuals is not None else None)


class PostedBuckets:
    """The fp32 :func:`bucketed_all_reduce` posted from the backward: hooks
    on the tensors whose gradients are the leaves' (:meth:`attach`) collect
    each gradient as autograd produces it, and the moment a bucket's last
    leaf arrives its flat buffer's all-reduce is posted (``async_op``), so
    it runs while the backward computes the buckets before it (the
    reference's intent: bucket 0 holds the last layers, whose gradients
    come first). :meth:`finish` posts the buckets whose leaves had no
    gradient, waits for every bucket and returns the summed tree."""

    def __init__(self, layout: BucketLayout, mesh, axis: str = "dp"):
        self.layout, self.mesh, self.axis = layout, mesh, axis
        self._bucket = {layout.names[i]: b
                        for b, idxs in enumerate(layout.buckets)
                        for i in idxs}
        self._grads: dict = {}
        self._left: list = []
        self._waits: dict = {}
        self.order: list = []  # the buckets in the order they were posted

    def attach(self, tensors: dict) -> list:
        """Hook ``tensors`` (name -> the tensor differentiated for that
        leaf); returns the hooks' handles (remove them after the
        backward)."""
        self._grads, self._waits, self.order = {}, {}, []
        self._left = [len(idxs) for idxs in self.layout.buckets]
        return [t.register_hook(self._hook(k)) for k, t in tensors.items()
                if t.requires_grad]

    def _hook(self, name: str):
        def hook(g):
            self._grads[name] = g.detach()
            b = self._bucket[name]
            self._left[b] -= 1
            if self._left[b] == 0:
                self._post(b)

        return hook

    def _post(self, b: int) -> None:
        from .comms import _comm, axis_size

        idxs = self.layout.buckets[b]
        parts = [to_jax_layout(self.layout.names[i],
                               self._grads[self.layout.names[i]])
                 .reshape(-1).float() for i in idxs]
        pad = self.layout.padded_sizes[b] - sum(p.numel() for p in parts)
        if pad:
            parts.append(parts[0].new_zeros(pad))
        flat = torch.cat(parts)
        self.order.append(b)
        if axis_size(self.mesh, self.axis) == 1:
            self._waits[b] = lambda: flat
        else:
            self._waits[b] = _comm(self.mesh, "posted all-reduce") \
                .all_reduce_async(flat, self.axis)

    def finish(self, grads: dict) -> dict:
        """The summed gradient tree: ``grads`` (the backward's, zeros where
        a leaf had none) fills the leaves no hook saw."""
        for b, idxs in enumerate(self.layout.buckets):
            if b not in self._waits:
                for i in idxs:
                    name = self.layout.names[i]
                    self._grads.setdefault(name, grads[name])
                self._post(b)
        flats = [self._waits[b]() for b in range(self.layout.num_buckets)]
        self._grads, self._waits = {}, {}
        return self.layout.unbucket(flats)


def bucketed_reduce_scatter(grads: dict, layout: BucketLayout, mesh,
                            axis: str = "dp", *, mode: str = "fp32",
                            block_size: int = DEFAULT_BLOCK_SIZE,
                            residuals=None):
    """Reduce-scatter a gradient tree per bucket: member ``i`` gets flat
    chunk ``i`` of each bucket's sum. Returns ``(shards, new_residuals)``
    with ``shards`` a tuple of per-bucket ``[padded / n]`` vectors."""
    shards, new_res = [], []
    for b, flat in enumerate(layout.bucket_flat(grads)):
        res = residuals[b] if residuals is not None else None
        sent, r = _ef_flat(flat, res, mode, block_size)
        shards.append(quantized_reduce_scatter_flat(
            sent, mesh, axis, mode=mode, block_size=block_size))
        new_res.append(r)
    return tuple(shards), (tuple(new_res) if residuals is not None else None)


def all_gather_buckets(shards, layout: BucketLayout, mesh,
                       axis: str = "dp") -> dict:
    """The full (replicated) param tree from every member's fresh flat
    shards: one all-gather per bucket, then unbucket. Always full
    precision (params have no error-feedback channel)."""
    from .comms import all_gather, axis_size

    if axis_size(mesh, axis) == 1:
        return layout.unbucket(list(shards))
    return layout.unbucket([all_gather(s, mesh, axis) for s in shards])


# ---------------------------------------------------------------------------
# Config-time fences
# ---------------------------------------------------------------------------


def check_update_sharding_config(*, update_sharding: str,
                                 grad_bucket_mb: float = 0.0,
                                 optim_name: str | None = None,
                                 weight_decay: float = 0.0,
                                 grad_clip: float = 0.0) -> None:
    """The reference's optimizer-level fences for the overlap knobs
    (``cli.build_all`` calls this before building anything). The sharded
    update runs on flat 1-D per-bucket shards, where a shape-based decay
    mask, a global-norm clip and the fused kernel's per-leaf dispatch are
    lost."""
    if update_sharding not in UPDATE_SHARDING_MODES:
        raise ValueError(
            f"train.update_sharding={update_sharding!r} not in "
            f"{UPDATE_SHARDING_MODES}"
        )
    if grad_bucket_mb < 0:
        raise ValueError(
            f"train.grad_bucket_mb={grad_bucket_mb} must be >= 0 "
            "(0 = single bucket / feature off)"
        )
    if update_sharding != "sharded":
        return
    if optim_name == "adamw_fused":
        raise NotImplementedError(
            "update_sharding='sharded' x optim.name='adamw_fused' is "
            "unsupported in v1: the fused kernel dispatches through its own "
            "per-leaf shard_map (Trainer._tx_update), which the flat-shard "
            "update replaces — use optim.name='adamw' or "
            "update_sharding='replicated'"
        )
    if weight_decay:
        raise NotImplementedError(
            f"update_sharding='sharded' x optim.weight_decay={weight_decay} "
            "is unsupported in v1: the decay mask is per-leaf-shape "
            "(fused_adamw.decay_leaf) and flat 1-D gradient shards would "
            "silently skip decay — use weight_decay=0.0 or "
            "update_sharding='replicated'"
        )
    if grad_clip:
        raise NotImplementedError(
            f"update_sharding='sharded' x optim.grad_clip={grad_clip} is "
            "unsupported in v1: clip_by_global_norm inside the optimizer "
            "chain would clip by the LOCAL shard norm — use grad_clip=0.0 "
            "or update_sharding='replicated'"
        )


# ---------------------------------------------------------------------------
# The explicit sync's placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DpSync:
    """What a training state under the explicit dp sync is tied to: the dp
    group (``mesh``'s ``axis``), the bucket ``layout`` (None: the one
    unbucketed ring of ``comms_quant``), and under the sharded update
    ``chunks``: member ``i`` holds global chunk ``chunks[i]`` of every
    bucket (``i`` itself on a flat sync, ``HierTopology.chunk_index(i)``
    under the hierarchy), its optimizer state keyed ``bucket_<b>``."""

    mesh: object
    layout: BucketLayout | None = None
    chunks: tuple[int, ...] | None = None
    axis: str = "dp"

    @property
    def sharded(self) -> bool:
        return self.chunks is not None

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        return self.mesh.coords[self.axis]

    def signature(self) -> dict:
        """What a checkpoint's residuals and flat shards are tied to."""
        return {"dp": self.size, "chunks": list(self.chunks or ()),
                "buckets": None if self.layout is None
                else self.layout.signature()}

    def keys(self) -> list[str]:
        return [f"bucket_{b}" for b in range(self.layout.num_buckets)]

    def local(self, tree: dict) -> dict:
        """This rank's flat shard of every bucket of a whole params-shaped
        ``tree`` (new fp32 buffers)."""
        chunk = self.chunks[self.index]
        return dict(zip(self.keys(), (
            s.clone() for s in self.layout.local_shards(tree, chunk))))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor | None:
        """Every member's ``t`` stacked ``[n, ...]`` in member order on
        member 0 of the axis (moved in fp32: gloo has no bf16 gather),
        None elsewhere: a collective of the axis group."""
        from .comms import gather

        flat = t.reshape(-1).float()
        rows = flat if self.size == 1 else gather(flat, self.mesh, self.axis)
        return None if rows is None else rows.view(self.size, *t.shape)

    def gather(self, shards: dict) -> dict | None:
        """The whole params-shaped tree of every member's flat ``shards``
        on member 0 of the axis (in ``shards``' dtype), None elsewhere."""
        gathered = [self.gather_rows(shards[k]) for k in self.keys()]
        if gathered[0] is None:
            return None
        flats = [torch.empty_like(rows).index_copy_(
            0, torch.tensor(self.chunks, device=rows.device),
            rows).reshape(-1) for rows in gathered]
        dtype = next(iter(shards.values())).dtype
        return {k: v.to(dtype) for k, v in self.layout.unbucket(flats).items()}
