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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import register
from .gpt2 import Embed, as_torch_dtype
from .remat import checkpoint_block
from .transformer import (
    ATTN_IMPLS,
    Dense,
    KVCache,
    PagedKVCache,
    attention_core,
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
        return (normed * self.scale.float()).to(self.dtype)


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
                 device=None, *, attn_impl: str = "xla", mesh=None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {num_kv_heads}")
        self.rep = num_heads // num_kv_heads
        self.dtype, self.attn_impl, self.mesh = dtype, attn_impl, mesh
        for name, heads in (("query", num_heads), ("key", num_kv_heads),
                            ("value", num_kv_heads)):
            self.add_module(name, Dense((embed_dim,), (heads, head_dim),
                                        dtype, device, use_bias=False))
        self.out = Dense((num_heads, head_dim), (embed_dim,), dtype, device,
                         use_bias=False)

    def forward(self, x, rope, cache: KVCache | PagedKVCache | None = None,
                layer: int = 0):
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

    def __init__(self, embed_dim, hidden_dim, dtype, device=None):
        super().__init__()
        self.gate = Dense((embed_dim,), (hidden_dim,), dtype, device,
                          use_bias=False)
        self.up = Dense((embed_dim,), (hidden_dim,), dtype, device,
                        use_bias=False)
        self.down = Dense((hidden_dim,), (embed_dim,), dtype, device,
                          use_bias=False)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    """Pre-norm: x + attn(attn_norm(x)), then x + mlp(mlp_norm(x))."""

    def __init__(self, embed_dim, num_heads, num_kv_heads, head_dim, mlp_dim,
                 rms_eps, dtype, device=None, *, attn_impl: str = "xla",
                 mesh=None):
        super().__init__()
        self.attn_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.attn = LlamaAttention(embed_dim, num_heads, num_kv_heads,
                                   head_dim, dtype, device,
                                   attn_impl=attn_impl, mesh=mesh)
        self.mlp_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.mlp = LlamaMlp(embed_dim, mlp_dim, dtype, device)

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
        return model.embed.embedding.to(model.dtype)
    return model.lm_head.to(model.dtype).t()


class Llama(nn.Module):
    def __init__(self, vocab_size: int = 32000, max_len: int = 4096,
                 num_layers: int = 8, num_heads: int = 8,
                 num_kv_heads: int = 4, embed_dim: int = 512,
                 mlp_dim: int = 1408, rope_theta: float = 10000.0,
                 rms_eps: float = 1e-6, remat: str = "none",
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, tie_embeddings: bool = False,
                 mesh=None, device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            # The serving engine fences everything but 'xla' itself.
            raise NotImplementedError(
                f"llama attn_impl={attn_impl!r} not yet ported to "
                "distributeddeeplearning_tpu_torch (the ulysses cores: "
                f"ROADMAP queue A13); {', '.join(map(repr, ATTN_IMPLS))} are"
            )
        if attn_impl in ("ring", "ring_pallas") and mesh is None:
            raise ValueError(f"attn_impl={attn_impl!r} requires mesh")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {remat!r}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.mlp_dim, self.rope_theta = mlp_dim, rope_theta
        self.remat, self.attn_impl, self.mesh = remat, attn_impl, mesh
        self.chunked_head, self.tie_embeddings = chunked_head, tie_embeddings
        self.dtype = as_torch_dtype(dtype)
        self.embed = Embed(vocab_size, embed_dim, self.dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", LlamaBlock(
                embed_dim, num_heads, num_kv_heads, self.head_dim, mlp_dim,
                rms_eps, self.dtype, device, attn_impl=attn_impl, mesh=mesh))
        self.norm = RMSNorm(embed_dim, rms_eps, self.dtype, device)
        if not tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(embed_dim, vocab_size,
                                                    device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: the embedding, every kernel and ``lm_head``
        normal(0.02), RMSNorm scales one."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] == "scale":
                nn.init.ones_(p)
            else:
                p.copy_(torch.empty(p.shape).normal_(std=0.02,
                                                     generator=generator))

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
        else:
            positions = cache_positions(cache, L)
        rope = rope_tables(positions, self.head_dim, self.rope_theta)
        x = self.embed(tokens)
        remat = self.remat if cache is None else "none"
        for i in range(self.num_layers):
            block = functools.partial(getattr(self, f"block_{i}"), rope=rope,
                                      cache=cache, layer=i)
            x = checkpoint_block(block, x, remat=remat)
        x = self.norm(x)
        dec = decoder_matrix(self)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, dec)
        return torch.einsum("ble,ve->blv", x, dec).float()


@register("llama")
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
