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

On a ``mesh`` both models cut their leaves over ``ep`` (the experts and the
router's columns), ``tp`` (heads, the experts' hidden units, the
vocabulary; ``sequence_parallel``) and ``fsdp`` (every ``embed``
dimension), as the JAX package's logical axes place them
(``sharding.py``), and route each row whole across its ``cp`` blocks.

Parameter names follow the flax tree (``block_1.moe_mlp.router.kernel``,
``block_1.moe_mlp.w1`` ``[e, d, h]``, ``…w_gate``, ``…b1``), so
``weights.from_jax_params`` loads a JAX init one to one. :class:`LlamaMoe`
decodes against ``generate``'s contiguous ``KVCache``; a decode step routes
one token a row, so it never meets the capacity limit (a model whose batched
forward drops tokens decodes slightly differently, the standard
capacity-MoE asymmetry), on one rank. :class:`MoeGPT2` has no decode, as in
the reference, and the serving engine refuses both, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import comms
from ..parallel.ep import (
    expert_capacity,
    expert_range,
    route_top_k,
    scale_grad,
)
from ..parallel.fsdp import full_param
from ..parallel.tp import (
    VocabShard,
    check_tp_fsdp,
    draw_block,
    enter,
    leave,
    seq_shard,
    tp_rules,
    vocab_parallel_embed,
)
from ..sharding import shard_model
from . import register
from .gpt2 import Embed, as_torch_dtype
from .llama import Llama, LlamaAttention, RMSNorm
from .sow import sow_loss, sow_metric
from .transformer import (
    ACTIVATIONS,
    Dense,
    LayerNorm,
    SelfAttention,
    TransformerBlock,
    block_scope,
    check_attn,
    act_cuts,
    dropout,
)

MLP_STYLES = ("gelu", "swiglu")


class Einsum(nn.Module):
    """One einsum, a module of its own so that a FLOP count can name it
    (``benchmark.py``: the one-hot products a tp rank repeats)."""

    def __init__(self, equation: str):
        super().__init__()
        self.equation = equation

    def forward(self, a, b):
        return torch.einsum(self.equation, a, b)


class MoeMlp(nn.Module):
    """Routed expert MLP over ``x`` [groups, tokens, embed]: each batch row
    is a routing group, so a row routes the same whichever rank holds
    it.

    On a ``mesh`` the layer is one region of the ep ranks (and of the tp
    ranks), entered by Megatron's f and left by its g:

    - ep: the rank holds ``num_experts / ep`` experts and its columns of
      the router (``("embed", "expert")``); the logits are gathered over
      ep, every rank routes the whole set alike, runs its experts over its
      columns of the dispatch and sums its share of the combine over ep;
    - tp: each expert's hidden units are cut over tp (``w1``/``w_gate``
      column-parallel, ``w2`` row-parallel, summed at the exit); ``b2``
      lies inside the combine and is added on tp member 0 alone. Under
      sequence parallelism the entry gathers the sequence (routing sees
      whole rows) and the exit scatters it;
    - fsdp: every leaf's ``embed`` dimension is gathered before use;
    - cp: ``x`` is the rank's block of each row; the routing carries the
      counts of the other blocks (``parallel.ep.route_top_k``) and the
      capacity is the whole row's. A rank runs its experts over its own
      slots alone: the others' are zeros that its combine never reads.

    The aux loss is computed whole on every rank of the region, whose
    backward sums the ranks' partial gradients, so its gradient enters
    scaled by ``1 / (ep * tp)``."""

    def __init__(self, embed_dim, num_experts, hidden_dim, dtype, device=None,
                 *, num_selected: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu_exact", mlp_style: str = "gelu",
                 aux_loss_weight: float = 1e-2, dropout_rate: float = 0.0,
                 mesh=None, sequence_parallel: bool = False):
        super().__init__()
        if mlp_style not in MLP_STYLES:
            raise ValueError(f"unknown mlp_style {mlp_style!r}")
        self.num_experts, self.num_selected = num_experts, num_selected
        self.capacity_factor, self.mlp_style = capacity_factor, mlp_style
        self.aux_loss_weight, self.dtype = aux_loss_weight, dtype
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.embed_dim = embed_dim
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self.ep = 1 if mesh is None else mesh.shape["ep"]
        self.sequence_parallel = sequence_parallel and self.tp > 1
        self.expert_lo, e = expert_range(num_experts, mesh)
        d, h = embed_dim, hidden_dim // self.tp
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
        self.dispatch_in = Einsum("gtec,gtd->egcd")
        self.combine_out = Einsum("gtec,egcd->gtd")

    def capacity(self, tokens: int) -> int:
        return expert_capacity(tokens, self.num_experts, self.num_selected,
                               self.capacity_factor)

    def forward(self, x, generator=None):
        mesh, sp = self.mesh, self.sequence_parallel
        if self.tp > 1:
            x = enter(x, mesh, sp)
        if self.ep > 1:
            x = comms.identity_fwd_psum_bwd(x, mesh, "ep")
        g, t, _ = x.shape
        cp = 1 if mesh is None else mesh.shape["cp"]
        dt = x.dtype
        # The router runs in fp32 whatever the compute dtype.
        logits = self.router(x.float())
        if self.ep > 1:
            logits = comms.all_gather_fwd_reduce_scatter_bwd(logits, mesh,
                                                             "ep", 2)
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, aux, kept = route_top_k(
            probs, self.num_selected, self.capacity(t * cp), dtype=dt,
            mesh=mesh)
        sow_loss("moe_aux", self.aux_loss_weight
                 * scale_grad(aux, 1.0 / (self.ep * self.tp)))
        # Each kept (token, choice) assignment fills one slot.
        sow_metric("moe_dropped_frac",
                   1.0 - kept.float() / (g * t * cp * self.num_selected))
        if self.ep > 1:
            n = self.w1.shape[0]
            dispatch = dispatch.narrow(2, self.expert_lo, n)
            combine = combine.narrow(2, self.expert_lo, n)
        expert_in = self.dispatch_in(dispatch, x)
        w1 = full_param(self, "w1", dt).to(dt)
        w2 = full_param(self, "w2", dt).to(dt)
        if self.mlp_style == "swiglu":
            w_gate = full_param(self, "w_gate", dt).to(dt)
            h = F.silu(torch.einsum("egcd,edh->egch", expert_in, w_gate)
                       ) * torch.einsum("egcd,edh->egch", expert_in, w1)
            out = torch.einsum("egch,ehd->egcd", h, w2)
        else:
            h = self.act(torch.einsum("egcd,edh->egch", expert_in, w1)
                         + self.b1.to(dt)[:, None, None, :])
            out = torch.einsum("egch,ehd->egcd", h, w2)
            if self.tp == 1 or mesh.coords["tp"] == 0:
                out = out + full_param(self, "b2", dt).to(dt)[:, None, None,
                                                              :]
        # Back to token order; a dropped assignment contributes zero (the
        # residual around the block carries the token through).
        out = self.combine_out(combine, out)
        if self.tp > 1:
            out = leave(out, mesh, sp)
        if self.ep > 1:
            out = comms.psum_identity_bwd(out, mesh, "ep")
        return dropout(out, self.dropout_rate, generator, self.mesh,
                       act_cuts(mesh, sp))


def moe_mlps(model) -> list[MoeMlp]:
    """The routed MLPs of ``model``, in block order."""
    return [m for m in model.modules() if isinstance(m, MoeMlp)]


def onehot_flops(mlp: MoeMlp, rows: int, tokens: int,
                 forwards: int = 1, mesh=None) -> int:
    """The matrix FLOPs of one training step's products with the dispatch
    and combine one-hots in ``mlp`` over ``rows`` x ``tokens``: each
    einsum is 2·g·t·e·c·d a forward (``forwards`` 2 under remat: the
    recompute), then the dispatch's backward takes one product (the input's
    gradient) and the combine's two (its own and the experts'). On a
    ``mesh``, one rank's: ``tokens`` its cp block, its ep slice of the
    experts, the whole rows' capacity."""
    cp, ep = (1, 1) if mesh is None else (mesh.shape["cp"], mesh.shape["ep"])
    one = (2 * rows * tokens * (mlp.num_experts // ep)
           * mlp.capacity(tokens * cp) * mlp.embed_dim)
    return one * (2 * forwards + 3)


def router_flops(mlp: MoeMlp, rows: int, tokens: int, forwards: int = 1,
                 mesh=None) -> int:
    """The router's product in one training step of ``mlp`` over ``rows`` x
    ``tokens``: 2·g·t·d·e ``forwards`` times, and its two backward products
    (the input's gradient and the kernel's); on a ``mesh``, over the rank's
    ep columns."""
    ep = 1 if mesh is None else mesh.shape["ep"]
    return (2 * rows * tokens * mlp.embed_dim * (mlp.num_experts // ep)
            * (forwards + 2))


class MoeTransformerBlock(nn.Module):
    """Pre-LN GPT-2 block with a routed MLP: x + drop(attn(ln1(x))), then
    x + moe_mlp(ln2(x)) (the routed MLP applies its own dropout)."""

    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, num_experts,
                 dtype, device=None, *, num_selected: int = 2,
                 capacity_factor: float = 1.25, attn_impl: str = "xla",
                 dropout_rate: float = 0.0, mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.cuts = act_cuts(mesh, sequence_parallel and (
            mesh is not None and mesh.shape["tp"] > 1))
        self.attn = SelfAttention(embed_dim, num_heads, head_dim, dtype,
                                  device, causal=True, attn_impl=attn_impl,
                                  dropout_rate=dropout_rate, mesh=mesh,
                                  sequence_parallel=sequence_parallel)
        self.ln1 = LayerNorm(embed_dim, 1e-5, dtype, device)
        self.ln2 = LayerNorm(embed_dim, 1e-5, dtype, device)
        self.moe_mlp = MoeMlp(
            embed_dim, num_experts, mlp_dim, dtype, device,
            num_selected=num_selected, capacity_factor=capacity_factor,
            activation="gelu_tanh", mlp_style="gelu",
            dropout_rate=dropout_rate, mesh=mesh,
            sequence_parallel=sequence_parallel)

    def forward(self, x, generator=None):
        x = x + dropout(self.attn(self.ln1(x), generator=generator),
                        self.dropout_rate, generator, self.mesh, self.cuts)
        return x + self.moe_mlp(self.ln2(x), generator)


class MoeGPT2(nn.Module):
    """GPT-2 with every ``moe_every``-th block routed (1 = all MoE): the
    blocks ``i`` with ``(i + 1) % moe_every == 0``, GShard's interleave.

    On a ``mesh`` with tp, fsdp or ep above 1 the model holds this rank's
    blocks of its leaves (``sharding.shard_model``), as ``models.gpt2``
    does (``wte`` vocab-parallel with the tied head on the same slice, the
    heads over tp, every ``embed`` dimension over fsdp, the seq shard
    between the blocks under ``sequence_parallel``), with its experts over
    ep and their hidden units over tp (:class:`MoeMlp`). On a mesh with
    cp > 1, ``tokens`` is the rank's block of the sequence, its positions
    starting at ``cp_index * L``."""

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, num_heads: int = 12,
                 embed_dim: int = 768, num_experts: int = 8,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 moe_every: int = 2, dropout_rate: float = 0.0,
                 dtype="float32", attn_impl: str = "xla",
                 chunked_head: bool = False, sequence_parallel: bool = False,
                 mesh=None, device=None):
        super().__init__()
        check_attn(attn_impl, mesh)
        tp = check_tp_fsdp("gpt2_moe", mesh, num_heads=num_heads)
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.num_experts = num_experts
        self.dropout_rate, self.attn_impl, self.mesh = (dropout_rate,
                                                        attn_impl, mesh)
        self.chunked_head = chunked_head
        self.dtype = as_torch_dtype(dtype)
        self.sequence_parallel = sp = sequence_parallel and tp > 1
        self.wte = Embed(-(-vocab_size // tp), embed_dim, self.dtype, device)
        self.wpe = Embed(max_len, embed_dim, self.dtype, device)
        hd, mlp = self.head_dim, 4 * embed_dim
        for i in range(num_layers):
            if (i + 1) % moe_every == 0:
                block = MoeTransformerBlock(
                    embed_dim, num_heads, hd, mlp, num_experts, self.dtype,
                    device, num_selected=num_selected,
                    capacity_factor=capacity_factor, attn_impl=attn_impl,
                    dropout_rate=dropout_rate, mesh=mesh,
                    sequence_parallel=sp)
            else:
                block = TransformerBlock(
                    embed_dim, num_heads, hd, mlp, 1e-5, self.dtype, device,
                    pre_ln=True, causal=True, activation="gelu_tanh",
                    attn_impl=attn_impl, dropout_rate=dropout_rate,
                    mesh=mesh, sequence_parallel=sp)
            self.add_module(f"block_{i}", block)
        self.ln_f = LayerNorm(embed_dim, 1e-5, self.dtype, device)
        # This rank's blocks of the leaves over tp, fsdp and ep (None:
        # whole).
        self.shards = shard_model(self, mesh, tp_rules(sequence_parallel),
                                  vocab_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: ``wpe`` normal(0.01); ``wte``, every kernel and the
        expert matrices normal(0.02); biases (the experts' ``b1``/``b2``
        too) zero; LayerNorm scales one. Each leaf is drawn whole and cut
        to this rank's block, so every mesh holds the one-rank model."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                nn.init.ones_(p)
            elif leaf in ("bias", "b1", "b2"):
                nn.init.zeros_(p)
            else:
                std = 0.01 if name == "wpe.embedding" else 0.02
                p.copy_(draw_block(self.shards, name, p, std, generator))

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                generator=None):
        """``tokens`` [B, L] -> fp32 logits [B, L, V], or with
        ``chunked_head`` the ``ops.chunked_xent.head_output`` dict (always,
        on a model cut over tp or fsdp: the head's softmax reads every
        vocabulary slice). ``train=True`` applies dropout from
        ``generator``."""
        from ..ops.chunked_xent import head_output

        B, L = tokens.shape
        mesh = self.mesh
        cp = 1 if mesh is None else mesh.shape["cp"]
        if L * cp > self.max_len:
            raise ValueError(f"seq_len {L * cp} exceeds max_len "
                             f"{self.max_len}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        offset = 0 if cp == 1 else mesh.coords["cp"] * L
        positions = torch.arange(L, device=tokens.device)[None, :] + offset
        table = full_param(self.wte, "embedding")
        shard = None
        if mesh is not None and mesh.shape["tp"] > 1:
            shard = VocabShard.of(mesh, self.vocab_size)
            x = vocab_parallel_embed(tokens, table, shard, self.dtype,
                                     self.sequence_parallel)
        else:
            x = F.embedding(tokens, table).to(self.dtype)
        if self.sequence_parallel:
            positions = seq_shard(positions, mesh)
        x = x + self.wpe(positions)
        x = dropout(x, self.dropout_rate, gen, mesh,
                    act_cuts(mesh, self.sequence_parallel))
        for i in range(self.num_layers):
            with block_scope(mesh, "none"):
                x = getattr(self, f"block_{i}")(x, generator=gen)
        x = self.ln_f(x)
        emb = table.to(self.dtype)
        if mesh is not None and (mesh.shape["tp"] > 1
                                 or mesh.shape["fsdp"] > 1):
            return head_output(enter(x, mesh, self.sequence_parallel, L),
                               emb, vocab=shard)
        if self.chunked_head:
            return head_output(x, emb)
        return (x @ emb.t()).float()


@register("gpt2_moe", remat=False, experts=True)
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
                 attn_impl: str = "xla", mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.attn = LlamaAttention(embed_dim, num_heads, num_kv_heads,
                                   head_dim, dtype, device,
                                   attn_impl=attn_impl, mesh=mesh,
                                   sequence_parallel=sequence_parallel)
        self.mlp_norm = RMSNorm(embed_dim, rms_eps, dtype, device)
        self.moe_mlp = MoeMlp(
            embed_dim, num_experts, mlp_dim, dtype, device,
            num_selected=num_selected, capacity_factor=capacity_factor,
            mlp_style="swiglu", mesh=mesh,
            sequence_parallel=sequence_parallel)

    def forward(self, x, rope, cache=None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), rope, cache, layer)
        return x + self.moe_mlp(self.mlp_norm(x))


class LlamaMoe(Llama):
    """Mixtral-class decoder: the Llama backbone (RoPE, RMSNorm, GQA, and
    its forward, sharded or not, with its decode caches) with every MLP a
    top-k routed SwiGLU expert layer (:class:`LlamaMoeBlock`)."""

    NAME = "llama_moe"

    def __init__(self, vocab_size: int = 32000, max_len: int = 4096,
                 num_layers: int = 8, num_heads: int = 8,
                 num_kv_heads: int = 4, embed_dim: int = 512,
                 mlp_dim: int = 1408, num_experts: int = 8,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 rope_theta: float = 10000.0, rms_eps: float = 1e-6,
                 remat: str = "none", dtype="float32",
                 attn_impl: str = "xla", chunked_head: bool = False,
                 tie_embeddings: bool = False,
                 sequence_parallel: bool = False, mesh=None, device=None):
        # Read by make_block while the base class builds the blocks.
        self.num_experts = num_experts
        self._routing = dict(num_selected=num_selected,
                             capacity_factor=capacity_factor)
        super().__init__(
            vocab_size=vocab_size, max_len=max_len, num_layers=num_layers,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            embed_dim=embed_dim, mlp_dim=mlp_dim, rope_theta=rope_theta,
            rms_eps=rms_eps, remat=remat, dtype=dtype, attn_impl=attn_impl,
            chunked_head=chunked_head, tie_embeddings=tie_embeddings,
            sequence_parallel=sequence_parallel, mesh=mesh, device=device)

    def make_block(self, embed_dim, num_heads, num_kv_heads, head_dim,
                   mlp_dim, rms_eps, dtype, device, **kwargs):
        return LlamaMoeBlock(embed_dim, num_heads, num_kv_heads, head_dim,
                             mlp_dim, self.num_experts, rms_eps, dtype,
                             device, **self._routing, **kwargs)


@register("llama_moe", experts=True)
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
