"""GPT-2 causal LM: pre-LN, gelu_new (tanh), learned positions, tied LM head,
LN eps 1e-5. Default size is the reference workload's 124M config (12L, 12H,
768d, vocab 50257). Parameter names follow the JAX package's ``models/gpt2``
(``wte.embedding``, ``h.block_{i}...``, ``ln_f``), so
``weights.from_jax_params`` loads a JAX init one to one.

On a ``mesh`` with tp or fsdp above 1 the model holds this rank's blocks of
its leaves (``sharding.shard_model``): the heads and MLP units over tp
(``parallel.tp``), ``wte`` vocab-parallel with the tied head on the same
slice (the last rank's padded where tp does not divide the vocabulary),
``wpe`` and the LayerNorms replicated over tp, every ``embed`` dimension
over fsdp (``parallel.fsdp``). ``sequence_parallel``: between the blocks
the activations are the rank's shard of the sequence (``L / tp``
positions); positions stay global, ``ln_f`` runs on the shard, and the head
gathers the shards back."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.fsdp import full_param
from ..parallel.tp import (
    VocabShard,
    check_tp_fsdp,
    draw_block,
    enter,
    seq_shard,
    tp_rules,
    vocab_parallel_embed,
)
from ..sharding import shard_model
from . import register
from .transformer import (
    KVCache,
    LayerNorm,
    SHARDED_DECODE,
    PagedKVCache,
    TransformerStack,
    act_cuts,
    check_attn,
    dropout,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[dtype]


class Embed(nn.Module):
    def __init__(self, num, features, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features,
                                                  device=device))

    def forward(self, ids):
        return F.embedding(ids, full_param(self, "embedding")).to(self.dtype)


class GPT2(nn.Module):
    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, num_heads: int = 12,
                 embed_dim: int = 768, dropout_rate: float = 0.0,
                 remat: str = "none", dtype="float32",
                 attn_impl: str = "xla", chunked_head: bool = False,
                 sequence_parallel: bool = False, mesh=None, device=None):
        super().__init__()
        # The serving engine fences everything but 'xla' itself.
        check_attn(attn_impl, mesh)
        tp = check_tp_fsdp("gpt2", mesh, num_heads=num_heads)
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.num_kv_heads = num_heads
        # Dropout applies in training only (``forward(train=True)``); remat
        # checkpoints each block (``models/remat.py``).
        self.dropout_rate, self.remat = dropout_rate, remat
        self.attn_impl, self.mesh = attn_impl, mesh
        self.chunked_head = chunked_head
        self.dtype = as_torch_dtype(dtype)
        rules = tp_rules(sequence_parallel)
        self.sequence_parallel = sequence_parallel and tp > 1
        self.wte = Embed(-(-vocab_size // tp), embed_dim, self.dtype, device)
        self.wpe = Embed(max_len, embed_dim, self.dtype, device)
        self.h = TransformerStack(
            num_layers, embed_dim, num_heads, self.head_dim, 4 * embed_dim,
            1e-5, self.dtype, device, remat=remat, attn_impl=attn_impl,
            dropout_rate=dropout_rate, mesh=mesh,
            sequence_parallel=self.sequence_parallel,
        )
        self.ln_f = LayerNorm(embed_dim, 1e-5, self.dtype, device)
        # This rank's blocks of the leaves over tp and fsdp (None: whole).
        self.shards = shard_model(self, mesh, rules, vocab_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions from ``generator`` (a CPU
        generator; the draws are made on the CPU and copied in, so a seed
        gives the same weights on every device): embeddings and projection
        kernels normal (wte and kernels std 0.02, wpe 0.01), biases zero,
        LayerNorm scales one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "wpe.embedding" or leaf in ("embedding", "kernel"):
                std = 0.01 if name == "wpe.embedding" else 0.02
                p.copy_(draw_block(self.shards, name, p, std, generator))
            elif leaf == "scale":
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def forward(self, tokens: torch.Tensor,
                cache: KVCache | PagedKVCache | None = None, *,
                train: bool = False, generator=None):
        """``tokens`` [B, L] -> fp32 logits [B, L, V], or with
        ``chunked_head`` the ``ops.chunked_xent.head_output`` dict. With a
        paged ``cache`` positions are per row: ``seq_lens[b] + i``, clamped
        to ``max_len - 1`` (pad positions of a bucketed prefill may pass it;
        their outputs are discarded). With a contiguous ``KVCache`` they are
        ``max(cache_index + i - start[b], 0)`` (a left-padded row's first
        real token at position 0), unclamped: the cursor may not pass
        ``max_len``. ``train=True`` applies dropout from
        ``generator`` (a ``torch.Generator`` on the tokens' device), at the
        embeddings, the attention probs (xla core), and each block's
        attention and MLP outputs.

        On a ``mesh`` with cp > 1, ``tokens`` is this rank's contiguous block
        of the sequence: its positions start at ``cp_index * L``."""
        B, L = tokens.shape
        cp = 1 if self.mesh is None else self.mesh.shape["cp"]
        if L * cp > self.max_len:
            raise ValueError(f"seq_len {L * cp} exceeds max_len "
                             f"{self.max_len}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        steps = torch.arange(L, device=tokens.device)[None, :]
        if cache is None:
            # JAX sees the global sequence; a cp rank holds its block of it.
            offset = 0 if cp == 1 else self.mesh.coords["cp"] * L
            positions = steps + offset
        elif isinstance(cache, KVCache):
            if cache.cache_index + L > self.max_len:
                raise ValueError(f"decode position {cache.cache_index + L} "
                                 f"exceeds max_len {self.max_len}")
            positions = cache.positions(L)
        else:
            positions = torch.clamp(
                cache.seq_lens.long()[:, None] + steps, max=self.max_len - 1
            )
        if self.shards is not None:
            if cache is not None:
                raise NotImplementedError(SHARDED_DECODE)
            return self._sharded_forward(tokens, positions, gen)
        x = self.wte(tokens) + self.wpe(positions)
        x = dropout(x, self.dropout_rate, gen, self.mesh,
                    act_cuts(self.mesh))
        x = self.h(x, cache, generator=gen)
        x = self.ln_f(x)
        emb = full_param(self.wte, "embedding").to(self.dtype)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, emb)
        # Tied LM head.
        return (x @ emb.t()).float()

    def _sharded_forward(self, tokens, positions, gen):
        """The forward of a model cut over tp or fsdp: the vocab-parallel
        embedding, the blocks on the rank's heads (and seq shard under
        sequence parallelism), and the head on the rank's vocabulary
        slice, returned as a chunked head (``ops.chunked_xent``) whatever
        ``chunked_head`` says: the softmax needs every slice."""
        from ..ops.chunked_xent import head_output

        sp = self.sequence_parallel
        table = full_param(self.wte, "embedding")
        if self.mesh.shape["tp"] > 1:
            shard = VocabShard.of(self.mesh, self.vocab_size)
            x = vocab_parallel_embed(tokens, table, shard, self.dtype, sp)
        else:
            shard = None
            x = F.embedding(tokens, table).to(self.dtype)
        if sp:
            positions = seq_shard(positions, self.mesh)
        x = x + self.wpe(positions)
        x = dropout(x, self.dropout_rate, gen, self.mesh,
                    act_cuts(self.mesh, sp))
        x = self.h(x, None, generator=gen)
        x = enter(self.ln_f(x), self.mesh, sp, tokens.shape[1])
        return head_output(x, table.to(self.dtype), vocab=shard)


@register("gpt2")
def gpt2(size: str = "124m", **kwargs) -> GPT2:
    sizes = {
        # (layers, heads, embed) — 124m is the reference workload's config.
        "tiny": (2, 4, 64),
        "124m": (12, 12, 768),
        "350m": (24, 16, 1024),
    }
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    defaults.update(kwargs)
    return GPT2(**defaults)
