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
  (:class:`VocabShard`).
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
    parallelism the activations' ``seq`` over tp between the blocks."""
    if sequence_parallel:
        return make_rules(seq="tp")
    return make_rules()


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape["tp"]


def enter(x, mesh, sequence_parallel: bool):
    """A tensor-parallel region's entry: f, or the all-gather of the seq
    shards."""
    if tp_size(mesh) == 1:
        return x
    if sequence_parallel:
        return comms.all_gather_fwd_reduce_scatter_bwd(x, mesh, "tp", 1)
    return comms.identity_fwd_psum_bwd(x, mesh, "tp")


def leave(x, mesh, sequence_parallel: bool):
    """A tensor-parallel region's exit: g, or the reduce-scatter of the
    partial sums into seq shards."""
    if tp_size(mesh) == 1:
        return x
    if sequence_parallel:
        return comms.reduce_scatter_fwd_all_gather_bwd(x, mesh, "tp", 1)
    return comms.psum_identity_bwd(x, mesh, "tp")


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
