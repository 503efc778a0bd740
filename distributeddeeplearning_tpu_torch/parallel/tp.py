"""Tensor parallelism (Megatron), with its sequence parallelism: the
counterpart of the JAX package's ``parallel/tp.py``.

In JAX, tensor parallelism is a rules change: ``heads``, ``mlp`` and
``vocab`` map onto the ``tp`` mesh axis and XLA places the collectives.
Here each rank holds its slice of those dimensions (``sharding.py`` says
which leaves and which dimensions, the one table the port reads) and runs
the collectives itself:

- a block's entry is Megatron's f (``comms.identity_fwd_psum_bwd``): the
  replicated activation goes to the column-parallel products (query, key,
  value; fc_in; gate and up), each a ``transformer.Dense`` built with its
  ``heads`` or ``mlp`` slice as its output;
- its exit is a :class:`RowParallelDense` (out; fc_out; down): the rank's
  input slice times its kernel rows, summed over tp by g
  (``comms.psum_identity_bwd``), and the bias added once, after the sum;
- under sequence parallelism the activations between the blocks are the
  rank's shard of the sequence: the entry all-gathers it
  (``comms.all_gather_fwd_reduce_scatter_bwd``) and the exit
  reduce-scatters the partial sums into shards
  (``comms.reduce_scatter_fwd_all_gather_bwd``), in place of f and g;
- :func:`vocab_parallel_embed`: the lookup in the rank's slice of the
  vocabulary, zero for the others' tokens, summed (or scattered into seq
  shards) over tp; the tied or untied head multiplies by the same slice,
  and ``ops.chunked_xent`` takes the softmax over the slices together
  (:class:`VocabShard`);
- under context parallelism (``mesh.cp``) a rank's activations are its
  cp block of the sequence, cut again over tp under sequence parallelism
  (JAX's ``seq -> ('cp', 'tp')``), and every attention core runs on the
  rank's heads: the ring's shift stays within the cp group of fixed (dp,
  fsdp, tp) coordinates, Ulysses' all-to-alls cut them over cp;
- :func:`check_tp_fsdp` holds every model's shape checks under tp or fsdp
  (a dropout mask is the rank's block of the one-rank mask,
  ``models.transformer.dropout``), and
  :func:`draw_block` draws a leaf whole and keeps the rank's block, so
  every mesh starts from the one-rank model's weights.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import comms
from ..models.transformer import Dense
from ..sharding import make_rules


def tp_rules(sequence_parallel: bool = False) -> dict:
    """The rules of tensor parallelism: ``sharding.DEFAULT_LOGICAL_RULES``
    (``heads``, ``mlp``, ``vocab`` over tp), with Megatron sequence
    parallelism the activations' ``seq`` over (cp, tp) between the blocks:
    a rank's cp block, cut over tp (JAX's rule)."""
    if sequence_parallel:
        return make_rules(seq=("cp", "tp"))
    return make_rules()


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape["tp"]


def enter(x, mesh, sequence_parallel: bool, length: int | None = None):
    """A tensor-parallel region's entry: f, or the all-gather of the seq
    shards, cut to the sequence's ``length`` where tp does not divide it
    (the last shard's padding rows dropped)."""
    if tp_size(mesh) == 1:
        return x
    if sequence_parallel:
        x = comms.all_gather_fwd_reduce_scatter_bwd(x, mesh, "tp", 1)
        return x if length is None else x[:, :length]
    return comms.identity_fwd_psum_bwd(x, mesh, "tp")


def leave(x, mesh, sequence_parallel: bool):
    """A tensor-parallel region's exit: g, or the reduce-scatter of the
    partial sums into seq shards (a sequence that tp does not divide padded
    with zero rows at its end first, as :func:`seq_shard` pads it)."""
    tp = tp_size(mesh)
    if tp == 1:
        return x
    if sequence_parallel:
        pad = -x.shape[1] % tp
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        return comms.reduce_scatter_fwd_all_gather_bwd(x, mesh, "tp", 1)
    return comms.psum_identity_bwd(x, mesh, "tp")


def seq_shard(x, mesh, dim: int = 1):
    """This tp rank's shard of ``x`` along the sequence dimension ``dim``:
    ``ceil(L / tp)`` positions, the last rank's padded with zeros where tp
    does not divide ``L`` (ViT's 197 tokens), as :func:`leave` scatters
    them."""
    tp = tp_size(mesh)
    if tp == 1:
        return x
    n = -(-x.shape[dim] // tp)
    pad = n * tp - x.shape[dim]
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 1 - dim) + (0, pad))
    return x.narrow(dim, mesh.coords["tp"] * n, n)


def gather_columns(y, mesh, size: int):
    """The whole last dimension (``size`` columns) of a column-parallel
    output ``y`` (this rank's slice, the last rank's padded): gathered over
    tp, each rank's slice of the gradient kept (the whole is used alike on
    every rank)."""
    if tp_size(mesh) == 1:
        return y
    return comms.all_gather_fwd_slice_bwd(y, mesh, "tp", -1)[..., :size]


def class_parallel_logits(x, head, mesh, num_classes: int):
    """An image head over tp: ``head`` (a linear map onto this rank's
    slice of the classes, padded on the last rank) on the replicated ``x``
    [B, E] behind f, the slices' logits gathered into the whole ``[B,
    num_classes]``, which the classification task takes as it is."""
    if tp_size(mesh) == 1:
        return head(x)
    x = comms.identity_fwd_psum_bwd(x, mesh, "tp")
    return gather_columns(head(x), mesh, num_classes)


def check_tp_fsdp(name: str, mesh, *, num_heads: int | None = None,
                  num_kv_heads: int | None = None) -> int:
    """The shape checks of a model cut over tp or fsdp, by name; returns
    the tp size."""
    if mesh is None:
        return 1
    tp, fsdp = mesh.shape["tp"], mesh.shape["fsdp"]
    if tp == 1 and fsdp == 1:
        return 1
    what = f"{name} at mesh tp={tp}, fsdp={fsdp}"
    if num_heads is not None and num_heads % tp:
        raise ValueError(f"{what}: num_heads {num_heads} not divisible by "
                         f"tp={tp}")
    if num_kv_heads is not None and num_kv_heads % tp:
        raise ValueError(f"{what}: num_kv_heads {num_kv_heads} not "
                         f"divisible by tp={tp} (each rank holds whole KV "
                         "heads of its query heads' groups)")
    return tp


def draw_block(shards, name: str, p, std: float, generator):
    """This rank's block of a normal(0, std) draw of leaf ``name`` at its
    whole shape, so every mesh holds the one-rank model's weights."""
    shape = p.shape if shards is None else shards.whole_shape(name, p.shape)
    full = torch.empty(shape).normal_(std=std, generator=generator)
    return full if shards is None else shards.take_leaf(name, full)


class RowParallelDense(Dense):
    """A :class:`transformer.Dense` holding the rank's slice of its input
    rows: the partial product is summed over tp (or scattered into seq
    shards) by :func:`leave`, and the bias is added once, after it."""

    def __init__(self, *args, mesh=None, sequence_parallel: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh, self.sequence_parallel = mesh, sequence_parallel

    def forward(self, x):
        y = self.product(x)
        y = leave(y, self.mesh, self.sequence_parallel)
        b = self.full_bias()
        return y if b is None else y + b.reshape(self.out_shape)


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's slice of a vocabulary over tp: rows ``[lo, lo +
    valid)``; the slice's rows past ``valid`` are padding (the last rank's,
    where tp does not divide the vocabulary)."""

    mesh: object
    lo: int
    valid: int

    @classmethod
    def of(cls, mesh, size: int) -> VocabShard:
        """The slice of a vocabulary of ``size`` words."""
        rows = -(-size // tp_size(mesh))
        lo = mesh.coords["tp"] * rows
        return cls(mesh, lo, max(0, min(rows, size - lo)))


def vocab_parallel_embed(ids, table, shard: VocabShard, dtype,
                         sequence_parallel: bool):
    """The embeddings of ``ids`` [B, L] from this rank's vocabulary slice
    ``table`` [rows, E]: the rows of the tokens it holds, zeros for the
    others', then summed over tp (each token's row lives on one rank), or
    under sequence parallelism scattered into seq shards [B, L / tp, E]."""
    local = ids - shard.lo
    own = (local >= 0) & (local < shard.valid)
    out = F.embedding(torch.where(own, local, torch.zeros_like(local)), table)
    out = torch.where(own[..., None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
    return leave(out.to(dtype), shard.mesh, sequence_parallel)
