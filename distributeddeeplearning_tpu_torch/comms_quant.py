"""Compressed gradient collectives: the counterpart of the JAX package's
``comms_quant.py`` (EQuARX-style block-quantized all-reduce and
reduce-scatter).

Every hop of the ring ships int8 values plus one f32 scale per
``block_size`` elements (``int8``), or a bf16 cast (``bf16``), instead of
f32, while the partial sums are accumulated in f32 on each rank. JAX runs
the ring under ``shard_map`` with ``lax.ppermute``; here each rank posts its
hop as a ``torch.distributed`` send to its successor and a receive from its
predecessor (``comms.DistComm.shift``, one ``batch_isend_irecv``, so a ring
of any size cannot deadlock). A payload travels as its codec's raw bytes
(``view(torch.uint8)``): gloo carries no bf16, and the bytes are the same on
gloo and NCCL. Under gloo a CUDA payload is staged through host memory.

The hops, the chunk each rank reduces at each hop and the order of
compress, add and decompress are the reference's, so the int8 and bf16
results equal JAX's bit for bit:

- **Block scales**: each block quantizes against its own max-abs.
- **Error feedback** (:func:`ef_compress`): each rank compresses ``grad +
  residual`` and carries the compression error into the next step
  (``TrainState.grad_residual``).
- **Hop-wise requantization** of the partial sums inside the ring is not
  error-compensated, as in the reference.

A tree here is a flat dict ``name -> tensor`` (a model's
``named_parameters``). :func:`ravel_tree` ravels it as ``jax.flatten_util.
ravel_pytree`` ravels the JAX package's params: leaves in JAX's flatten
order (the names' dotted paths sorted level by level) and each leaf in
JAX's layout (a leaf the port keeps in torch's layout, ``weight``, is
transposed back to the ``kernel`` it stands for). Buckets and int8 blocks
cross leaf boundaries, so any other order would move every code.
"""

from __future__ import annotations

import dataclasses
import math

import torch

GRAD_COMM_MODES: tuple[str, ...] = ("fp32", "bf16", "int8")

DEFAULT_BLOCK_SIZE = 256
_INV127 = float(torch.tensor(1.0) / torch.tensor(127.0))  # fp32 1/127


# ---------------------------------------------------------------------------
# Block-wise quantization
# ---------------------------------------------------------------------------


def block_quantize(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE, *,
                   compiled: bool = False):
    """Quantize a flat f32 vector to (int8 values [n, block_size], one f32
    scale per block [n, 1]).

    ``x.shape[0]`` must be a multiple of ``block_size``. The max-abs element
    of every block maps to exactly ±127, so ``scale = amax / 127`` and
    all-zero blocks keep scale 0. ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the codes agree bit for bit with the reference.
    ``compiled``: the scale as the reference's compiled programs compute it
    (XLA turns ``amax / 127.0`` into a product with the fp32 reciprocal,
    one ulp apart on some blocks); the gradient rings use it, eager JAX
    divides.
    """
    blocks = x.reshape(-1, block_size)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = (amax * _INV127 if compiled else amax / 127.0).to(torch.float32)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def block_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_quantize` — flat f32 vector."""
    return (q.to(torch.float32) * scale).reshape(-1)


def _compress(x: torch.Tensor, mode: str, block_size: int) -> tuple:
    """Flat f32 -> compressed payload tuple (what actually rides the ring)."""
    if mode == "bf16":
        return (x.to(torch.bfloat16),)
    return block_quantize(x, block_size, compiled=True)


def _decompress(payload: tuple, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return payload[0].to(torch.float32)
    return block_dequantize(*payload)


def _decompress_add(payload: tuple, mode: str,
                    local: torch.Tensor) -> torch.Tensor:
    """``_decompress(payload) + local`` as the reference's compiled program
    computes it: for int8 the product and the sum are one fused
    multiply-add (XLA contracts them), computed here in float64 (the
    product is exact there) and rounded to f32 once."""
    if mode == "bf16":
        return payload[0].to(torch.float32) + local
    q, scale = payload
    return (q.double() * scale.double()).reshape(-1).add_(
        local.double()).to(torch.float32)


def _compression_error(total: torch.Tensor, payload: tuple,
                       mode: str) -> torch.Tensor:
    """``total - _decompress(payload)``, contracted as :func:`_decompress_add`
    (one rounding for int8): the error-feedback residual."""
    if mode == "bf16":
        return total - payload[0].to(torch.float32)
    q, scale = payload
    return (total.double() - (q.double() * scale.double()).reshape(-1)).to(
        torch.float32)


def compression_ratio(mode: str, block_size: int = DEFAULT_BLOCK_SIZE) -> float:
    """Payload bytes per f32 element (scales included)."""
    if mode == "fp32":
        return 1.0
    if mode == "bf16":
        return 0.5
    return (1.0 + 4.0 / block_size) / 4.0  # int8 + f32 scale per block


def _pad_to(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


# ---------------------------------------------------------------------------
# The JAX package's flatten order and layout
# ---------------------------------------------------------------------------


def _torch_layout(name: str) -> bool:
    """A leaf the port keeps in torch's layout (``weight``) where the JAX
    package has a ``kernel``."""
    return name.endswith(".weight") or name == "weight"


def jax_path(name: str) -> tuple[str, ...]:
    """The JAX params-tree path of the port's leaf ``name``."""
    path = name.split(".")
    if _torch_layout(name):
        path[-1] = "kernel"
    return tuple(path)


def jax_order(names) -> list[str]:
    """``names`` in ``jax.tree.flatten``'s order of the JAX package's
    params: the dict keys sorted at every level (``block_10`` before
    ``block_2``)."""
    return sorted(names, key=jax_path)


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """Leaf ``name`` in JAX's layout: a torch-layout conv weight (OIHW)
    as HWIO, a Dense weight ([out, in]) as [in, out]; others as they are."""
    if not _torch_layout(name):
        return t
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout`."""
    if not _torch_layout(name):
        return t
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()


def jax_shape(name: str, shape) -> tuple[int, ...]:
    shape = tuple(shape)
    if not _torch_layout(name):
        return shape
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape[::-1]


def ravel_tree(tree: dict):
    """``jax.flatten_util.ravel_pytree`` of the JAX package's tree that
    ``tree`` stands for: ``(flat f32 vector, unravel)``, the leaves in JAX's
    order and layout. ``unravel(flat)`` gives a dict of ``tree``'s names,
    shapes and dtypes back."""
    names = jax_order(tree)
    meta = [(k, tree[k].shape, tree[k].dtype) for k in names]
    flat = torch.cat([to_jax_layout(k, tree[k]).reshape(-1).float()
                      for k in names]) if names else torch.zeros(0)

    def unravel(vec: torch.Tensor) -> dict:
        out, off = {}, 0
        for k, shape, dtype in meta:
            n = math.prod(shape)
            seg = vec[off:off + n].reshape(jax_shape(k, shape))
            out[k] = from_jax_layout(k, seg).contiguous().to(dtype)
            off += n
        return {k: out[k] for k in tree}

    return flat, unravel


# ---------------------------------------------------------------------------
# Ring collectives on the compressed payload
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ring:
    """A ring of ranks: ``ranks`` (global ranks, in ring order) of the
    transport group ``group`` of ``mesh`` (an axis, or one of the
    hierarchy's sub-groups), this rank at ``index``. A hop sends to
    ``index + 1`` and receives from ``index - 1``: JAX's ``ppermute`` with
    ``perm = [(i, i + 1 mod n)]``."""

    mesh: object
    group: str
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_ring(mesh, axis: str = "dp") -> Ring:
    """The ring over ``axis`` of ``mesh``, in coordinate order."""
    return Ring(mesh, axis, tuple(mesh.axis_ranks(axis)), mesh.coords[axis])


def _pack(payload: tuple) -> torch.Tensor:
    """A payload's tensors as one flat byte buffer (the scales first, so
    each piece starts aligned for its dtype)."""
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1)
                      for p in reversed(payload)])


def _unpack(buf: torch.Tensor, like: tuple) -> tuple:
    out, off = [], 0
    for p in reversed(like):
        n = p.numel() * p.element_size()
        out.append(buf[off:off + n].view(p.dtype).reshape(p.shape))
        off += n
    return tuple(reversed(out))


def _ring_hop(payload: tuple, ring: Ring) -> tuple:
    """One neighbour hop: member i receives member i-1's payload tuple."""
    from .comms import _comm

    buf = _comm(ring.mesh, "ring hop").shift(
        [_pack(payload)], ring.group, list(ring.ranks), ring.index, 1)[0]
    return _unpack(buf, payload)


def _ring_reduce_phase(flat: torch.Tensor, ring: Ring, mode: str,
                       block_size: int):
    """Ring reduce-scatter pass over ``n`` equal chunks of ``flat``.

    Returns ``(partial, chunks, n, i)`` where ``partial`` is the fully
    reduced chunk with index ``(i + 1) % n`` held by member ``i``: at hop
    ``s`` member ``i`` ships its running partial compressed, receives the
    partial for chunk ``(i - 1 - s) % n``, decompresses, and adds its own
    slice of that chunk in f32."""
    n, i = ring.size, ring.index
    chunks = flat.reshape(n, -1)
    partial = chunks[i]
    for s in range(n - 1):
        payload = _ring_hop(_compress(partial, mode, block_size), ring)
        partial = _decompress_add(payload, mode, chunks[(i - 1 - s) % n])
    return partial, chunks, n, i


def _ring_all_reduce(flat: torch.Tensor, ring: Ring, mode: str,
                     block_size: int) -> torch.Tensor:
    """The compressed ring all-reduce over ``ring``: the reduce phase, then
    the reduced chunks circulated compressed. Every member decompresses its
    own chunk too (not the f32 partial), so all members hold the same
    values."""
    partial, _, n, i = _ring_reduce_phase(flat, ring, mode, block_size)
    payload = _compress(partial, mode, block_size)
    out = partial.new_zeros((n, partial.shape[0]))
    out[(i + 1) % n] = _decompress(payload, mode)
    for s in range(n - 1):
        payload = _ring_hop(payload, ring)
        # The payload received at hop s originated at member (i - 1 - s),
        # which holds reduced chunk (i - s) % n.
        out[(i - s) % n] = _decompress(payload, mode)
    return out.reshape(-1)


def _ring_reduce_scatter(flat: torch.Tensor, ring: Ring, mode: str,
                         block_size: int) -> torch.Tensor:
    """The compressed ring reduce-scatter: member ``i`` gets chunk ``i`` of
    the sum; one extra compressed hop moves the ring-final chunk ``(i + 1)
    % n`` from its reducer to its owner."""
    partial, _, _, _ = _ring_reduce_phase(flat, ring, mode, block_size)
    return _decompress(_ring_hop(_compress(partial, mode, block_size), ring),
                       mode)


def quantized_all_reduce_flat(flat: torch.Tensor, mesh, axis: str = "dp", *,
                              mode: str = "int8",
                              block_size: int = DEFAULT_BLOCK_SIZE):
    """All-reduce-sum a flat f32 vector over ``axis``, shipping only
    compressed payloads (ring reduce-scatter + ring all-gather).
    ``flat.shape[0]`` must divide evenly into ``axis_size * block_size``
    chunks — use :func:`_pad_to`. The result is bit-identical on every
    member. fp32 (or one member): the plain all-reduce."""
    from .comms import axis_size, psum

    if axis_size(mesh, axis) == 1 or mode == "fp32":
        return psum(flat, mesh, axis)
    return _ring_all_reduce(flat, axis_ring(mesh, axis), mode, block_size)


def quantized_reduce_scatter_flat(flat: torch.Tensor, mesh, axis: str = "dp",
                                  *, mode: str = "int8",
                                  block_size: int = DEFAULT_BLOCK_SIZE):
    """``lax.psum_scatter(tiled=True)`` semantics (member ``i`` gets chunk
    ``i`` of the sum) on compressed payloads."""
    from .comms import _comm, axis_size

    if axis_size(mesh, axis) == 1:
        return flat
    if mode == "fp32":
        return _comm(mesh, "reduce-scatter").reduce_scatter_sum(
            flat.detach(), axis)
    return _ring_reduce_scatter(flat, axis_ring(mesh, axis), mode,
                                block_size)


# ---------------------------------------------------------------------------
# Error feedback + tree gradient sync (what the Trainer calls)
# ---------------------------------------------------------------------------


def ef_compress(grads: dict, residual, *, mode: str, block_size: int):
    """EF-SGD compression step on a gradient tree: compresses ``grads +
    residual`` once and returns ``(decompressed, new_residual)`` —
    ``new_residual`` is exactly the compression error, carried into the
    next step. ``residual=None`` (or fp32) means EF off."""
    if residual is None or mode == "fp32":
        return grads, residual
    flat, unravel = ravel_tree(grads)
    res_flat, _ = ravel_tree(residual)
    total = flat + res_flat
    m = flat.shape[0]
    padded = _pad_to(total, block_size)
    payload = _compress(padded, mode, block_size)
    sent = _decompress(payload, mode)[:m]
    return (unravel(sent),
            unravel(_compression_error(padded, payload, mode)[:m]))


def quantized_tree_all_reduce(grads: dict, mesh, axis: str = "dp", *,
                              mode: str = "int8",
                              block_size: int = DEFAULT_BLOCK_SIZE,
                              residual=None):
    """Gradient-sync entry point: all-reduce-sum a gradient tree over
    ``axis`` on compressed payloads, with optional error feedback. The tree
    is raveled into ONE flat f32 buffer (one fused ring), then unraveled.
    Returns ``(summed_grads, new_residual)``; divide by the axis size for
    the mean."""
    from .comms import axis_size

    if mode not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm mode {mode!r} not in {GRAD_COMM_MODES}")
    grads, new_residual = ef_compress(grads, residual, mode=mode,
                                      block_size=block_size)
    flat, unravel = ravel_tree(grads)
    m = flat.shape[0]
    padded = _pad_to(flat, axis_size(mesh, axis) * block_size)
    summed = quantized_all_reduce_flat(padded, mesh, axis, mode=mode,
                                       block_size=block_size)
    return unravel(summed[:m]), new_residual


def zeros_residual(params: dict, dtype=torch.float32) -> dict:
    """Per-parameter EF residual tree of zeros, shaped like ``params``:
    this rank's own (its local compression error)."""
    return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for k, p in params.items()}
