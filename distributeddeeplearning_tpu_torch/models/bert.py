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
"""

from __future__ import annotations

import torch
from torch import nn

from . import register
from .gpt2 import Embed, as_torch_dtype
from .transformer import (
    Dense,
    LayerNorm,
    TransformerStack,
    dropout,
    gelu_exact,
)


class BertMLM(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 type_vocab_size: int = 2, num_layers: int = 12,
                 num_heads: int = 12, embed_dim: int = 768,
                 dropout_rate: float = 0.0, remat: str = "none",
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, mesh=None, device=None):
        super().__init__()
        if attn_impl not in ("xla", "flash"):
            raise NotImplementedError(
                f"bert attn_impl={attn_impl!r} not yet ported to "
                "distributeddeeplearning_tpu_torch (ROADMAP queue A13); "
                "'xla' and 'flash' are")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.dropout_rate, self.remat = dropout_rate, remat
        self.attn_impl, self.mesh = attn_impl, mesh
        self.chunked_head = chunked_head
        self.dtype = as_torch_dtype(dtype)
        self.word_embeddings = Embed(vocab_size, embed_dim, self.dtype,
                                     device)
        self.position_embeddings = Embed(max_len, embed_dim, self.dtype,
                                         device)
        self.token_type_embeddings = Embed(type_vocab_size, embed_dim,
                                           self.dtype, device)
        self.embeddings_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.encoder = TransformerStack(
            num_layers, embed_dim, num_heads, self.head_dim, 4 * embed_dim,
            1e-12, self.dtype, device, pre_ln=False, causal=False,
            activation="gelu_exact", remat=remat, attn_impl=attn_impl,
            dropout_rate=dropout_rate, mesh=mesh)
        self.mlm_transform = Dense((embed_dim,), (embed_dim,), self.dtype,
                                   device)
        self.mlm_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.mlm_bias = nn.Parameter(torch.empty(vocab_size, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: embeddings and kernels normal(0.02), biases (and
        ``mlm_bias``) zero, LayerNorm scales one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("embedding", "kernel"):
                p.copy_(torch.empty(p.shape).normal_(std=0.02,
                                                     generator=generator))
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
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        positions = torch.arange(L, device=tokens.device)[None, :]
        x = (self.word_embeddings(tokens) + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        x = self.embeddings_ln(x)
        x = dropout(x, self.dropout_rate, gen, self.mesh)
        x = self.encoder(x, mask=attention_mask, generator=gen)
        x = self.mlm_ln(gelu_exact(self.mlm_transform(x)))
        emb = self.word_embeddings.embedding.to(self.dtype)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, emb, self.mlm_bias)
        return (x @ emb.t() + self.mlm_bias).float()


@register("bert")
def bert(size: str = "base", **kwargs) -> BertMLM:
    sizes = {"tiny": (2, 4, 64), "base": (12, 12, 768),
             "large": (24, 16, 1024)}
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    defaults.update(kwargs)
    return BertMLM(**defaults)
