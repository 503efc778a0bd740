"""Mixture-of-Experts decoders: the JAX package's ``models/moe.py`` in torch.

- :class:`MoeMlp` is a routed expert MLP: an fp32 router (the compute copy
  of its kernel promoted to fp32, as flax's ``Dense(dtype=float32)``
  promotes it), top-k routing with a static capacity
  (``parallel.ep.route_top_k``), then JAX's dense einsums: dispatch into
  per-expert buffers ``[e, g, c, d]``, the experts as products batched over
  the expert dim, and combine back to token order. ``mlp_style='gelu'`` is
  two biased matrices and an activation (GPT-2-shaped); ``'swiglu'`` is
  ``silu(x @ w_gate) * (x @ w1) @ w2`` without biases (Mixtral-shaped).
  Each call sows ``aux_loss_weight * aux`` into the Trainer's losses and
  ``moe_dropped_frac`` into its metrics (``models/sow.py``).
- :class:`MoeGPT2` is GPT-2 whose every ``moe_every``-th block routes its
  MLP (:class:`MoeTransformerBlock`); the others are the port's
  ``TransformerBlock``. The reference's ``MoeGPT2`` has no ``remat``, and
  neither has this one: ``cli train`` refuses ``train.remat`` for it.
- :class:`LlamaMoe` is the Llama backbone (``models/llama.py``'s attention,
  RMSNorm and head) with every MLP a routed SwiGLU layer
  (:class:`LlamaMoeBlock`); ``remat`` is 'none' or 'full'.

Parameter names follow the flax tree (``block_1.moe_mlp.router.kernel``,
``block_1.moe_mlp.w1`` ``[e, d, h]``, ``…w_gate``, ``…b1``), so
``weights.from_jax_params`` loads a JAX init one to one. :class:`LlamaMoe`
decodes against ``generate``'s contiguous ``KVCache``; a decode step routes
one token a row, so it never meets the capacity limit (a model whose batched
forward drops tokens decodes slightly differently, the standard
capacity-MoE asymmetry). :class:`MoeGPT2` has no decode, as in the
reference, and the serving engine refuses both, as the reference's does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from . import register
from ..parallel.ep import expert_capacity, route_top_k
from .gpt2 import Embed, as_torch_dtype
from .llama import (
    LlamaAttention,
    RMSNorm,
    cache_positions,
    decoder_matrix,
    rope_tables,
)
from .remat import checkpoint_block
from .sow import sow_loss, sow_metric
from .transformer import (
    ACTIVATIONS,
    ATTN_IMPLS,
    Dense,
    LayerNorm,
    SelfAttention,
    TransformerBlock,
    dropout,
)

MLP_STYLES = ("gelu", "swiglu")


class MoeMlp(nn.Module):
    """Routed expert MLP over ``x`` [groups, tokens, embed]: each batch row
    is a routing group, so a row routes the same whichever rank holds
    it."""

    def __init__(self, embed_dim, num_experts, hidden_dim, dtype, device=None,
                 *, num_selected: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu_exact", mlp_style: str = "gelu",
                 aux_loss_weight: float = 1e-2, dropout_rate: float = 0.0,
                 mesh=None):
        super().__init__()
        if mlp_style not in MLP_STYLES:
            raise ValueError(f"unknown mlp_style {mlp_style!r}")
        self.num_experts, self.num_selected = num_experts, num_selected
        self.capacity_factor, self.mlp_style = capacity_factor, mlp_style
        self.aux_loss_weight, self.dtype = aux_loss_weight, dtype
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.embed_dim = embed_dim
        e, d, h = num_experts, embed_dim, hidden_dim
        self.router = Dense((d,), (e,), torch.float32, device,
                            use_bias=False)
        self.w1 = nn.Parameter(torch.empty(e, d, h, device=device))
        self.w2 = nn.Parameter(torch.empty(e, h, d, device=device))
        if mlp_style == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(e, d, h, device=device))
        else:
            # The activation applies to this style only (swiglu is gated
            # silu).
            self.act = ACTIVATIONS[activation]
            self.b1 = nn.Parameter(torch.empty(e, h, device=device))
            self.b2 = nn.Parameter(torch.empty(e, d, device=device))

    def capacity(self, tokens: int) -> int:
        return expert_capacity(tokens, self.num_experts, self.num_selected,
                               self.capacity_factor)

    def forward(self, x, generator=None):
        g, t, _ = x.shape
        dt = x.dtype
        # The router runs in fp32 whatever the compute dtype.
        probs = torch.softmax(self.router(x.float()), dim=-1)
        dispatch, combine, aux, kept = route_top_k(
            probs, self.num_selected, self.capacity(t), dtype=dt)
        sow_loss("moe_aux", self.aux_loss_weight * aux)
        # Each kept (token, choice) assignment fills one slot.
        sow_metric("moe_dropped_frac",
                   1.0 - kept.float() / (g * t * self.num_selected))
        expert_in = torch.einsum("gtec,gtd->egcd", dispatch, x)
        if self.mlp_style == "swiglu":
            h = F.silu(torch.einsum("egcd,edh->egch", expert_in,
                                    self.w_gate.to(dt))) * torch.einsum(
                "egcd,edh->egch", expert_in, self.w1.to(dt))
            out = torch.einsum("egch,ehd->egcd", h, self.w2.to(dt))
        else:
            h = self.act(torch.einsum("egcd,edh->egch", expert_in,
                                      self.w1.to(dt))
                         + self.b1.to(dt)[:, None, None, :])
            out = (torch.einsum("egch,ehd->egcd", h, self.w2.to(dt))
                   + self.b2.to(dt)[:, None, None, :])
        # Back to token order; a dropped assignment contributes zero (the
        # residual around the block carries the token through).
        out = torch.einsum("gtec,egcd->gtd", combine, out)
        return dropout(out, self.dropout_rate, generator, self.mesh)


def moe_mlps(model) -> list[MoeMlp]:
    """The routed MLPs of ``model``, in block order."""
    return [m for m in model.modules() if isinstance(m, MoeMlp)]


def onehot_flops(mlp: MoeMlp, rows: int, tokens: int,
                 forwards: int = 1) -> int:
    """The matrix FLOPs of one training step's products with the dispatch
    and combine one-hots in ``mlp`` over ``rows`` x ``tokens``: each
    einsum is 2·g·t·e·c·d a forward (``forwards`` 2 under remat: the
    recompute), then the dispatch's backward takes one product (the input's
    gradient) and the combine's two (its own and the experts')."""
    one = (2 * rows * tokens * mlp.num_experts * mlp.capacity(tokens)
           * mlp.embed_dim)
    return one * (2 * forwards + 3)


class MoeTransformerBlock(nn.Module):
    """Pre-LN GPT-2 block with a routed MLP: x + drop(attn(ln1(x))), then
    x + moe_mlp(ln2(x)) (the routed MLP applies its own dropout)."""

    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, num_experts,
                 dtype, device=None, *, num_selected: int = 2,
                 capacity_factor: float = 1.25, attn_impl: str = "xla",
                 dropout_rate: float = 0.0, mesh=None):
        super().__init__()
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.attn = SelfAttention(embed_dim, num_heads, head_dim, dtype,
                                  device, causal=True, attn_impl=attn_impl,
                                  dropout_rate=dropout_rate, mesh=mesh)
        self.ln1 = LayerNorm(embed_dim, 1e-5, dtype, device)
        self.ln2 = LayerNorm(embed_dim, 1e-5, dtype, device)
        self.moe_mlp = MoeMlp(
            embed_dim, num_experts, mlp_dim, dtype, device,
            num_selected=num_selected, capacity_factor=capacity_factor,
            activation="gelu_tanh", mlp_style="gelu",
            dropout_rate=dropout_rate, mesh=mesh)

    def forward(self, x, generator=None):
        x = x + dropout(self.attn(self.ln1(x), generator=generator),
                        self.dropout_rate, generator, self.mesh)
        return x + self.moe_mlp(self.ln2(x), generator)


def _check_attn(name: str, attn_impl: str, mesh) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"{name} attn_impl={attn_impl!r} not yet ported to "
            "distributeddeeplearning_tpu_torch (the ulysses cores: ROADMAP "
            f"queue A13); {', '.join(map(repr, ATTN_IMPLS))} are"
        )
    if attn_impl in ("ring", "ring_pallas") and mesh is None:
        raise ValueError(f"attn_impl={attn_impl!r} requires mesh")


class MoeGPT2(nn.Module):
    """GPT-2 with every ``moe_every``-th block routed (1 = all MoE): the
    blocks ``i`` with ``(i + 1) % moe_every == 0``, GShard's interleave."""

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, num_heads: int = 12,
                 embed_dim: int = 768, num_experts: int = 8,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 moe_every: int = 2, dropout_rate: float = 0.0,
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, mesh=None, device=None):
        super().__init__()
        _check_attn("gpt2_moe", attn_impl, mesh)
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.num_experts = num_experts
        self.dropout_rate, self.attn_impl, self.mesh = (dropout_rate,
                                                        attn_impl, mesh)
        self.chunked_head = chunked_head
        self.dtype = as_torch_dtype(dtype)
        self.wte = Embed(vocab_size, embed_dim, self.dtype, device)
        self.wpe = Embed(max_len, embed_dim, self.dtype, device)
        hd, mlp = self.head_dim, 4 * embed_dim
        for i in range(num_layers):
            if (i + 1) % moe_every == 0:
                block = MoeTransformerBlock(
                    embed_dim, num_heads, hd, mlp, num_experts, self.dtype,
                    device, num_selected=num_selected,
                    capacity_factor=capacity_factor, attn_impl=attn_impl,
                    dropout_rate=dropout_rate, mesh=mesh)
            else:
                block = TransformerBlock(
                    embed_dim, num_heads, hd, mlp, 1e-5, self.dtype, device,
                    pre_ln=True, causal=True, activation="gelu_tanh",
                    attn_impl=attn_impl, dropout_rate=dropout_rate,
                    mesh=mesh)
            self.add_module(f"block_{i}", block)
        self.ln_f = LayerNorm(embed_dim, 1e-5, self.dtype, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: ``wpe`` normal(0.01); ``wte``, every kernel and the
        expert matrices normal(0.02); biases (the experts' ``b1``/``b2``
        too) zero; LayerNorm scales one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                nn.init.ones_(p)
            elif leaf in ("bias", "b1", "b2"):
                nn.init.zeros_(p)
            else:
                std = 0.01 if name == "wpe.embedding" else 0.02
                p.copy_(torch.empty(p.shape).normal_(std=std,
                                                     generator=generator))

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                generator=None):
        """``tokens`` [B, L] -> fp32 logits [B, L, V], or with
        ``chunked_head`` the ``ops.chunked_xent.head_output`` dict.
        ``train=True`` applies dropout from ``generator``."""
        B, L = tokens.shape
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        positions = torch.arange(L, device=tokens.device)[None, :]
        x = self.wte(tokens) + self.wpe(positions)
        x = dropout(x, self.dropout_rate, gen, self.mesh)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, generator=gen)
        x = self.ln_f(x)
        emb = self.wte.embedding.to(self.dtype)
        if self.chunked_head:
            from ..ops.chunked_xent import head_output

            return head_output(x, emb)
        return (x @ emb.t()).float()


@register("gpt2_moe", remat=False)
def gpt2_moe(size: str = "tiny", **kwargs) -> MoeGPT2:
    sizes = {
        "tiny": (2, 4, 64),
        "124m": (12, 12, 768),
    }
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    defaults.update(kwargs)
    return MoeGPT2(**defaults)


class LlamaMoeBlock(nn.Module):
    """Mixtral-shaped block: x + attn(attn_norm(x)), then x +
    moe_mlp(mlp_norm(x)) over routed SwiGLU experts."""

    def __init__(self, embed_dim, num_heads, num_kv_heads, head_dim, mlp_dim,
                 num_experts, rms_eps, dtype, device=None, *,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 attn_impl: str = "xla", mesh=None):
        super().__init__()
        self.attn_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.attn = LlamaAttention(embed_dim, num_heads, num_kv_heads,
                                   head_dim, dtype, device,
                                   attn_impl=attn_impl, mesh=mesh)
        self.mlp_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.moe_mlp = MoeMlp(
            embed_dim, num_experts, mlp_dim, dtype, device,
            num_selected=num_selected, capacity_factor=capacity_factor,
            mlp_style="swiglu")

    def forward(self, x, rope, cache=None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), rope, cache, layer)
        return x + self.moe_mlp(self.mlp_norm(x))


class LlamaMoe(nn.Module):
    """Mixtral-class decoder: the Llama backbone (RoPE, RMSNorm, GQA) with
    every MLP a top-k routed SwiGLU expert layer."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 4096,
                 num_layers: int = 8, num_heads: int = 8,
                 num_kv_heads: int = 4, embed_dim: int = 512,
                 mlp_dim: int = 1408, num_experts: int = 8,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 rope_theta: float = 10000.0, rms_eps: float = 1e-6,
                 remat: str = "none", dtype="float32",
                 attn_impl: str = "xla", chunked_head: bool = False,
                 tie_embeddings: bool = False, mesh=None, device=None):
        super().__init__()
        _check_attn("llama_moe", attn_impl, mesh)
        if remat not in ("none", "full"):
            raise ValueError(f"unknown remat {remat!r}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.num_experts, self.rope_theta = num_experts, rope_theta
        self.remat, self.attn_impl, self.mesh = remat, attn_impl, mesh
        self.chunked_head, self.tie_embeddings = chunked_head, tie_embeddings
        self.dtype = as_torch_dtype(dtype)
        self.embed = Embed(vocab_size, embed_dim, self.dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", LlamaMoeBlock(
                embed_dim, num_heads, num_kv_heads, self.head_dim, mlp_dim,
                num_experts, rms_eps, self.dtype, device,
                num_selected=num_selected, capacity_factor=capacity_factor,
                attn_impl=attn_impl, mesh=mesh))
        self.norm = RMSNorm(embed_dim, rms_eps, self.dtype, device)
        if not tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(embed_dim, vocab_size,
                                                    device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: every weight normal(0.02), RMSNorm scales one."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] == "scale":
                nn.init.ones_(p)
            else:
                p.copy_(torch.empty(p.shape).normal_(std=0.02,
                                                     generator=generator))

    def forward(self, tokens: torch.Tensor, cache=None, *,
                train: bool = False, generator=None):
        """``tokens`` [B, L] -> fp32 logits [B, L, V], or with
        ``chunked_head`` the ``ops.chunked_xent.head_output`` dict. With a
        contiguous ``KVCache`` (``generate``) the RoPE positions are Llama's
        decode positions and each block writes and reads its cache. No
        dropout: ``train`` and ``generator`` change nothing."""
        del train, generator
        B, L = tokens.shape
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        positions = (torch.arange(L, device=tokens.device) if cache is None
                     else cache_positions(cache, L))
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


@register("llama_moe")
def llama_moe(size: str = "tiny", **kwargs) -> LlamaMoe:
    sizes = {
        # (layers, heads, kv_heads, embed, mlp)
        "tiny": (2, 4, 2, 64, 128),
        "8x300m": (12, 16, 8, 1024, 2816),
    }
    n_l, n_h, n_kv, d, m = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, num_kv_heads=n_kv,
                    embed_dim=d, mlp_dim=m)
    defaults.update(kwargs)
    return LlamaMoe(**defaults)
