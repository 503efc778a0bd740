"""BERT masked LM, the reference's workload 3 (``BASELINE.json:9``:
"BERT-base MLM (Wikipedia), DP + gradient accumulation"): the JAX
package's ``models/bert.py`` in torch.

Word, position and token-type embeddings, their LayerNorm, the post-LN
encoder (exact GELU, LayerNorm eps 1e-12, non-causal, the
``attention_mask`` as its key-padding mask), then the MLM head: a dense
transform, exact GELU, LayerNorm, and the decoder tied to the word
embeddings plus a free ``mlm_bias``. ``chunked_head=True`` returns the
``ops.chunked_xent.head_output`` of the transformed states instead of the
[B, L, V] logits. Names are the flax tree's (``word_embeddings``,
``position_embeddings``, ``token_type_embeddings``, ``embeddings_ln``,
``encoder.block_{i}``, ``mlm_transform``, ``mlm_ln``, ``mlm_bias``).

With ``attn_impl='flash'`` the mask must be a contiguous prefix a row: it
becomes the kernels' per-row key limit, and a row whose mask is no prefix
comes out NaN (``transformer.SelfAttention``), as in the reference.

On a ``mesh`` with cp > 1 (``attn_impl='ulysses'``, the plain core behind
the all-to-alls) a rank holds its block of each row: its positions start at
``cp_index * L``, and its block of the mask is gathered over cp into the
whole row's, the keys the core sees. The ring cores and ``ulysses_flash``
take no mask, and raise the reference's ``NotImplementedError`` when given
one.

On a ``mesh`` with tp or fsdp above 1 the model holds this rank's blocks
(``sharding.shard_model``): the encoder's heads and MLP units over tp,
``word_embeddings`` and ``mlm_bias`` vocab-parallel (30522 rows in blocks
of ``ceil(30522 / tp)``, the last padded), ``mlm_transform``'s output
units over tp (gathered back before ``mlm_ln``), every ``embed`` dimension
over fsdp. The MLM head is then the vocab-parallel chunked head
(``ops.chunked_xent``) whatever ``chunked_head`` says: its softmax needs
every slice. ``sequence_parallel``: between the blocks a rank holds its
shard of the positions; the key-padding mask stays whole (the attention
core sees the whole sequence).
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from .. import comms
from ..parallel.fsdp import full_param
from ..parallel.sp_ulysses import gather_mask
from ..parallel.tp import (
    check_tp_fsdp,
    draw_block,
    gather_columns,
    seq_shard,
    tp_rules,
)
from ..sharding import shard_model
from . import register
from .gpt2 import Embed, as_torch_dtype
from .transformer import (
    Dense,
    check_attn,
    LayerNorm,
    TransformerStack,
    act_cuts,
    dropout,
    gelu_exact,
)


class BertMLM(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 type_vocab_size: int = 2, num_layers: int = 12,
                 num_heads: int = 12, embed_dim: int = 768,
                 dropout_rate: float = 0.0, remat: str = "none",
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, sequence_parallel: bool = False,
                 mesh=None, device=None):
        super().__init__()
        check_attn(attn_impl, mesh)
        tp = check_tp_fsdp("bert", mesh, num_heads=num_heads)
        if embed_dim % tp:
            raise ValueError(f"bert at mesh tp={tp}: mlm_transform's "
                             f"{embed_dim} units not divisible by tp={tp}")
        self.sequence_parallel = sequence_parallel and tp > 1
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.dropout_rate, self.remat = dropout_rate, remat
        self.attn_impl, self.mesh = attn_impl, mesh
        self.chunked_head = chunked_head
        self.dtype = as_torch_dtype(dtype)
        self.word_embeddings = Embed(-(-vocab_size // tp), embed_dim,
                                     self.dtype, device)
        self.position_embeddings = Embed(max_len, embed_dim, self.dtype,
                                         device)
        self.token_type_embeddings = Embed(type_vocab_size, embed_dim,
                                           self.dtype, device)
        self.embeddings_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.encoder = TransformerStack(
            num_layers, embed_dim, num_heads, self.head_dim, 4 * embed_dim,
            1e-12, self.dtype, device, pre_ln=False, causal=False,
            activation="gelu_exact", remat=remat, attn_impl=attn_impl,
            dropout_rate=dropout_rate, mesh=mesh,
            sequence_parallel=self.sequence_parallel)
        self.mlm_transform = Dense((embed_dim,), (embed_dim // tp,),
                                   self.dtype, device)
        self.mlm_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.mlm_bias = nn.Parameter(torch.empty(-(-vocab_size // tp),
                                                 device=device))
        # This rank's blocks of the leaves over tp and fsdp (None: whole).
        self.shards = shard_model(self, mesh, tp_rules(sequence_parallel),
                                  vocab_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: embeddings and kernels normal(0.02), biases (and
        ``mlm_bias``) zero, LayerNorm scales one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("embedding", "kernel"):
                p.copy_(draw_block(self.shards, name, p, 0.02, generator))
            elif leaf == "scale":
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def forward(self, tokens: torch.Tensor, attention_mask=None,
                token_type_ids=None, *, train: bool = False, generator=None):
        """``tokens`` [B, L], ``attention_mask`` [B, L] (1 = a real token)
        -> fp32 logits [B, L, V], or with ``chunked_head`` the
        ``head_output`` dict. ``train=True`` applies dropout from
        ``generator``."""
        B, L = tokens.shape
        cp = 1 if self.mesh is None else self.mesh.shape["cp"]
        if L * cp > self.max_len:
            raise ValueError(f"seq_len {L * cp} exceeds max_len "
                             f"{self.max_len}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        # A cp rank holds its block of the sequence: its positions start at
        # cp_index * L, and the core sees every block's keys.
        offset = 0 if cp == 1 else self.mesh.coords["cp"] * L
        positions = torch.arange(L, device=tokens.device)[None, :] + offset
        attention_mask = gather_mask(attention_mask, self.mesh)
        if self.shards is not None:
            return self._sharded_forward(tokens, attention_mask,
                                         token_type_ids, positions, gen)
        x = (self.word_embeddings(tokens) + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        x = self.embeddings_ln(x)
        x = dropout(x, self.dropout_rate, gen, self.mesh, act_cuts(self.mesh))
        x = self.encoder(x, mask=attention_mask, generator=gen)
        x = self.mlm_ln(gelu_exact(self.mlm_transform(x)))
        emb = self.word_embeddings.embedding.to(self.dtype)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, emb, self.mlm_bias)
        return (x @ emb.t() + self.mlm_bias).float()

    def _sharded_forward(self, tokens, attention_mask, token_type_ids,
                         positions, gen):
        """The forward of a model cut over tp or fsdp: the vocab-parallel
        embedding, the blocks on the rank's heads (and seq shard under
        sequence parallelism), ``mlm_transform`` column-parallel and its
        units gathered, and the vocab-parallel tied head with the rank's
        slice of ``mlm_bias``, returned as a chunked head."""
        from ..ops.chunked_xent import head_output
        from ..parallel.tp import VocabShard, enter, vocab_parallel_embed

        mesh, sp, L = self.mesh, self.sequence_parallel, tokens.shape[1]
        table = full_param(self.word_embeddings, "embedding")
        if mesh.shape["tp"] > 1:
            shard = VocabShard.of(mesh, self.vocab_size)
            x = vocab_parallel_embed(tokens, table, shard, self.dtype, sp)
        else:
            shard = None
            x = F.embedding(tokens, table).to(self.dtype)
        if sp:
            positions = seq_shard(positions, mesh)
            token_type_ids = seq_shard(token_type_ids, mesh)
        x = (x + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        x = dropout(self.embeddings_ln(x), self.dropout_rate, gen, mesh,
                    act_cuts(mesh, sp, L))
        x = self.encoder(x, mask=attention_mask, generator=gen,
                         seq_len=L if sp else None)
        # The transform's units are a column-parallel slice, gathered
        # whole before the LayerNorm; the vocab-parallel head's slices then
        # give each rank its share of the gradient, summed by f. Under
        # sequence parallelism the LayerNorm runs on the rank's seq shard,
        # as every leaf tp does not cut does (``fsdp.reduce_grads`` sums
        # their gradients over tp), and the shards are gathered after it.
        y = gelu_exact(self.mlm_transform(enter(x, mesh, sp, L)))
        if sp:
            y = comms.all_gather_fwd_reduce_scatter_bwd(y, mesh, "tp", 2)
            y = enter(self.mlm_ln(seq_shard(y, mesh)), mesh, sp, L)
        else:
            y = self.mlm_ln(gather_columns(y, mesh, self.embed_dim))
            y = comms.identity_fwd_psum_bwd(y, mesh, "tp")
        return head_output(y, table.to(self.dtype), self.mlm_bias,
                           vocab=shard)


@register("bert")
def bert(size: str = "base", **kwargs) -> BertMLM:
    sizes = {"tiny": (2, 4, 64), "base": (12, 12, 768),
             "large": (24, 16, 1024)}
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    defaults.update(kwargs)
    return BertMLM(**defaults)
