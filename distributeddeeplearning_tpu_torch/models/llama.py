"""Llama-family decoder: RoPE, RMSNorm, SwiGLU, grouped-query attention. The
JAX package's ``models/llama.py`` in torch.

- RMSNorm reduces and scales in fp32 and casts to the compute dtype.
- RoPE tables are fp32 (HF's ``inv_freq``), computed once a forward from
  the positions and applied to q and k before the GQA repeat, rotate-half
  in fp32, cast back to the input dtype.
- GQA repeats K and V group-major (query head ``g * rep + i`` reads kv
  head ``g``: ``repeat_interleave`` on the heads axis, ``jnp.repeat`` in
  the reference) and runs any MHA core of ``transformer.attention_core``:
  ``xla``, ``flash`` (the hand kernels on the GPU), ``ring`` and
  ``ring_pallas``. The decode caches hold the PRE-repeat k and v and read
  them with ``num_rep``: the contiguous ``KVCache`` of ``generate``
  through ``transformer.decode_attention``, the paged serving cache through
  ``transformer.paged_decode_attention`` (the paged decode kernel folds the
  query groups itself).
- Every projection is bias-free (no ``bias`` parameter), the LM head is the
  tied embedding or a bare ``lm_head`` [E, V] parameter, and names follow
  the flax tree (``embed.embedding``, ``block_{i}.attn.query.kernel``,
  ``block_{i}.mlp_norm.scale``, ``norm.scale``, ``lm_head``), so
  ``weights.from_jax_params`` loads a JAX init one to one.
- ``remat`` is 'none' or 'full' (``models/remat.py``); the reference's Llama
  has no selective policy, and 'dots' raises its error.
- On a ``mesh`` with tp or fsdp above 1 the model holds this rank's blocks
  of its leaves (``sharding.shard_model``): ``H / tp`` query heads and
  ``Hkv / tp`` KV heads (rank r's query heads read rank r's KV heads under
  the group-major repeat, since ``H / tp = rep * Hkv / tp``), SwiGLU's
  gate and up column-parallel and down row-parallel, the embedding and the
  untied ``lm_head`` vocab-parallel, every ``embed`` dimension over fsdp
  (the RMSNorm scales too). ``sequence_parallel``: between the blocks the
  activations are the rank's seq shard, the RMSNorms run on it, and RoPE
  rotates the gathered sequence at its global positions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.fsdp import full_param
from ..parallel.tp import tp_rules
from ..sharding import shard_model
from . import register
from .gpt2 import Embed, as_torch_dtype, check_tp_fsdp, draw_block
from .remat import checkpoint_block
from .transformer import (
    ATTN_IMPLS,
    Dense,
    KVCache,
    PagedKVCache,
    attention_core,
    block_scope,
    decode_attention,
    paged_decode_attention,
)

REMAT_MODES = ("none", "full")


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                   + self.eps)
        return (normed * full_param(self, "scale").float()).to(self.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """HF Llama's ``inv_freq = theta ** -(arange(0, d, 2) / d)``, computed in
    float32 by numpy as the reference computes it, copied to ``device``
    once: a copy from host memory at every forward would wait for the
    device's queue to drain."""
    half = head_dim // 2
    inv = theta ** -(np.arange(0, half, dtype=np.float32) * 2 / head_dim)
    return torch.from_numpy(inv).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """fp32 (cos, sin), [..., L, head_dim // 2]: HF Llama's layout.
    ``positions`` is [L] (shared) or [B, L] (per row, the paged cache's
    cursors)."""
    freqs = (positions.float()[..., None]
             * _inv_freq(head_dim, float(theta), positions.device))
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin):
    """Rotate-half RoPE on [B, L, H, D] in fp32 (the two halves of the head
    dim rotate against each other), cast back to ``x``'s dtype. Tables are
    [L, half] (shared positions) or [B, L, half] (per row)."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    if cos.ndim == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    """GQA self-attention, always causal: ``query`` [E, H, D], ``key`` and
    ``value`` [E, Hkv, D], ``out`` [H, D, E], no biases."""

    def __init__(self, embed_dim, num_heads, num_kv_heads, head_dim, dtype,
                 device=None, *, attn_impl: str = "xla", mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.rep = num_heads // num_kv_heads
        self.dtype, self.attn_impl, self.mesh = dtype, attn_impl, mesh
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self.sequence_parallel = sequence_parallel and self.tp > 1
        heads, kv_heads = num_heads // self.tp, num_kv_heads // self.tp
        for name, h in (("query", heads), ("key", kv_heads),
                        ("value", kv_heads)):
            self.add_module(name, Dense((embed_dim,), (h, head_dim),
                                        dtype, device, use_bias=False))
        if self.tp > 1:
            from ..parallel.tp import RowParallelDense

            self.out = RowParallelDense(
                (heads, head_dim), (embed_dim,), dtype, device,
                use_bias=False, mesh=mesh,
                sequence_parallel=self.sequence_parallel)
        else:
            self.out = Dense((heads, head_dim), (embed_dim,), dtype, device,
                             use_bias=False)

    def forward(self, x, rope, cache: KVCache | PagedKVCache | None = None,
                layer: int = 0):
        if self.tp > 1:
            if cache is not None:
                raise NotImplementedError(
                    "decode under tensor parallelism not yet ported to "
                    "distributeddeeplearning_tpu_torch (ROADMAP queue A13): "
                    "restore the checkpoint on one rank")
            from ..parallel.tp import enter

            x = enter(x, self.mesh, self.sequence_parallel)
        cos, sin = rope
        q = apply_rope(self.query(x), cos, sin)
        k = apply_rope(self.key(x), cos, sin)
        v = self.value(x)
        if isinstance(cache, KVCache):
            out = decode_attention(q, k, v, dtype=self.dtype, cache=cache,
                                   layer=layer, num_rep=self.rep)
        elif cache is not None:
            out = paged_decode_attention(
                q, k, v, dtype=self.dtype, pools=cache.pools[layer],
                page_table=cache.page_table, seq_lens=cache.seq_lens,
                num_rep=self.rep, kernel=cache.kernel,
            )
        else:
            if self.rep > 1:
                k = k.repeat_interleave(self.rep, dim=2)
                v = v.repeat_interleave(self.rep, dim=2)
            out = attention_core(q, k, v, impl=self.attn_impl, causal=True,
                                 dtype=self.dtype, mesh=self.mesh)
        return self.out(out)


class LlamaMlp(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))`` in the compute dtype."""

    def __init__(self, embed_dim, hidden_dim, dtype, device=None, *,
                 mesh=None, sequence_parallel: bool = False):
        super().__init__()
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self.sequence_parallel = sequence_parallel and self.tp > 1
        hidden = hidden_dim // self.tp
        self.gate = Dense((embed_dim,), (hidden,), dtype, device,
                          use_bias=False)
        self.up = Dense((embed_dim,), (hidden,), dtype, device,
                        use_bias=False)
        if self.tp > 1:
            from ..parallel.tp import RowParallelDense

            self.down = RowParallelDense(
                (hidden,), (embed_dim,), dtype, device, use_bias=False,
                mesh=mesh, sequence_parallel=self.sequence_parallel)
        else:
            self.down = Dense((hidden,), (embed_dim,), dtype, device,
                              use_bias=False)

    def forward(self, x):
        if self.tp > 1:
            from ..parallel.tp import enter

            x = enter(x, self.mesh, self.sequence_parallel)
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    """Pre-norm: x + attn(attn_norm(x)), then x + mlp(mlp_norm(x))."""

    def __init__(self, embed_dim, num_heads, num_kv_heads, head_dim, mlp_dim,
                 rms_eps, dtype, device=None, *, attn_impl: str = "xla",
                 mesh=None, sequence_parallel: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.attn = LlamaAttention(embed_dim, num_heads, num_kv_heads,
                                   head_dim, dtype, device,
                                   attn_impl=attn_impl, mesh=mesh,
                                   sequence_parallel=sequence_parallel)
        self.mlp_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.mlp = LlamaMlp(embed_dim, mlp_dim, dtype, device, mesh=mesh,
                            sequence_parallel=sequence_parallel)

    def forward(self, x, rope, cache=None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), rope, cache, layer)
        return x + self.mlp(self.mlp_norm(x))


def cache_positions(cache, length: int) -> torch.Tensor:
    """[B, length] RoPE positions of a cached forward: ``max(cache_index + t
    - start[b], 0)`` on the contiguous ``KVCache`` (a left-padded row's
    first real token rotates at position 0), ``seq_lens[b] + t`` on the
    paged cache (no clamp: RoPE has no table to overrun)."""
    if isinstance(cache, KVCache):
        return cache.positions(length)
    steps = torch.arange(length, device=cache.seq_lens.device)
    return cache.seq_lens.long()[:, None] + steps[None, :]


def decoder_matrix(model) -> torch.Tensor:
    """The LM head's decoder [V, E] in the compute dtype: the tied embedding
    table, or the untied ``lm_head`` [E, V] transposed."""
    if model.tie_embeddings:
        return full_param(model.embed, "embedding").to(model.dtype)
    return full_param(model, "lm_head", model.dtype).to(model.dtype).t()


class Llama(nn.Module):
    # The name the fences give (``LlamaMoe`` shares this body).
    NAME = "llama"

    def __init__(self, vocab_size: int = 32000, max_len: int = 4096,
                 num_layers: int = 8, num_heads: int = 8,
                 num_kv_heads: int = 4, embed_dim: int = 512,
                 mlp_dim: int = 1408, rope_theta: float = 10000.0,
                 rms_eps: float = 1e-6, remat: str = "none",
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, tie_embeddings: bool = False,
                 sequence_parallel: bool = False, mesh=None, device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            # The serving engine fences everything but 'xla' itself.
            raise NotImplementedError(
                f"{self.NAME} attn_impl={attn_impl!r} not yet ported to "
                "distributeddeeplearning_tpu_torch (the ulysses cores: "
                f"ROADMAP queue A13); {', '.join(map(repr, ATTN_IMPLS))} are"
            )
        if attn_impl in ("ring", "ring_pallas") and mesh is None:
            raise ValueError(f"attn_impl={attn_impl!r} requires mesh")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {remat!r}")
        tp = check_tp_fsdp(self.NAME, mesh, num_heads=num_heads,
                           attn_impl=attn_impl, num_kv_heads=num_kv_heads,
                           remat=remat)
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.mlp_dim, self.rope_theta = mlp_dim, rope_theta
        self.remat, self.attn_impl, self.mesh = remat, attn_impl, mesh
        self.chunked_head, self.tie_embeddings = chunked_head, tie_embeddings
        self.dtype = as_torch_dtype(dtype)
        self.sequence_parallel = sequence_parallel and tp > 1
        rows = -(-vocab_size // tp)  # this rank's vocabulary slice
        self.embed = Embed(rows, embed_dim, self.dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", self.make_block(
                embed_dim, num_heads, num_kv_heads, self.head_dim, mlp_dim,
                rms_eps, self.dtype, device, attn_impl=attn_impl, mesh=mesh,
                sequence_parallel=self.sequence_parallel))
        self.norm = RMSNorm(embed_dim, rms_eps, self.dtype, device)
        if not tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(embed_dim, rows,
                                                    device=device))
        # This rank's blocks of the leaves over tp and fsdp (None: whole).
        self.shards = shard_model(self, mesh, tp_rules(sequence_parallel),
                                  vocab_size)

    def make_block(self, *args, **kwargs) -> nn.Module:
        """One block (``LlamaMoe`` routes its MLP)."""
        return LlamaBlock(*args, **kwargs)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: the embedding, every kernel and ``lm_head``
        normal(0.02), RMSNorm scales one."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] == "scale":
                nn.init.ones_(p)
            else:
                p.copy_(draw_block(self.shards, name, p, 0.02, generator))

    def forward(self, tokens: torch.Tensor,
                cache: KVCache | PagedKVCache | None = None, *,
                train: bool = False, generator=None):
        """``tokens`` [B, L] -> fp32 logits [B, L, V], or with
        ``chunked_head`` the ``ops.chunked_xent.head_output`` dict. With a
        ``cache`` the RoPE positions are per row (:func:`cache_positions`).
        On a ``mesh`` with cp > 1
        ``tokens`` is this rank's contiguous block of the sequence, its
        positions starting at ``cp_index * L``. Llama has no dropout:
        ``train`` and ``generator`` change nothing."""
        del train, generator
        B, L = tokens.shape
        cp = 1 if self.mesh is None else self.mesh.shape["cp"]
        if L * cp > self.max_len:
            raise ValueError(f"seq_len {L * cp} exceeds max_len "
                             f"{self.max_len}")
        if cache is None:
            offset = 0 if cp == 1 else self.mesh.coords["cp"] * L
            positions = torch.arange(L, device=tokens.device) + offset
        elif self.shards is not None:
            raise NotImplementedError(
                "decode of a model cut over tp, fsdp or ep not yet ported to "
                "distributeddeeplearning_tpu_torch (ROADMAP queue A13): "
                "restore its checkpoint on one rank")
        else:
            positions = cache_positions(cache, L)
        rope = rope_tables(positions, self.head_dim, self.rope_theta)
        sharded = self.shards is not None
        if sharded:
            x, shard = self._sharded_embed(tokens)
        else:
            x = self.embed(tokens)
        remat = self.remat if cache is None else "none"
        for i in range(self.num_layers):
            block = functools.partial(getattr(self, f"block_{i}"), rope=rope,
                                      cache=cache, layer=i)
            with block_scope(self.mesh, remat):
                x = checkpoint_block(block, x, remat=remat)
        x = self.norm(x)
        dec = decoder_matrix(self)
        if sharded:
            from ..ops.chunked_xent import head_output
            from ..parallel.tp import enter

            # The head reads every slice's logits: a chunked head always.
            x = enter(x, self.mesh, self.sequence_parallel)
            return head_output(x, dec, vocab=shard)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, dec)
        return torch.einsum("ble,ve->blv", x, dec).float()

    def _sharded_embed(self, tokens):
        """The embeddings of a model cut over tp or fsdp (the rank's seq
        shard under sequence parallelism) and its vocabulary slice (None
        at tp = 1)."""
        from ..parallel.tp import VocabShard, vocab_parallel_embed

        table = full_param(self.embed, "embedding")
        if self.mesh.shape["tp"] == 1:
            return F.embedding(tokens, table).to(self.dtype), None
        shard = VocabShard.of(self.mesh, self.vocab_size)
        return vocab_parallel_embed(tokens, table, shard, self.dtype,
                                    self.sequence_parallel), shard


@register("llama", tp=True)
def llama(size: str = "tiny", **kwargs) -> Llama:
    sizes = {
        # (layers, heads, kv_heads, embed, mlp)
        "tiny": (2, 4, 2, 64, 128),
        "300m": (12, 16, 8, 1024, 2816),
        "1b": (16, 32, 8, 2048, 5632),
        "7b": (32, 32, 32, 4096, 11008),
    }
    n_l, n_h, n_kv, d, m = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, num_kv_heads=n_kv,
                    embed_dim=d, mlp_dim=m)
    defaults.update(kwargs)
    return Llama(**defaults)
