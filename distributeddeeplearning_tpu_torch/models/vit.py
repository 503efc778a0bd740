"""ViT image classifier, the reference's workload 5 (``BASELINE.json:11``:
"ViT-L/16 on ImageNet-21k, DP + activation checkpointing"): the JAX
package's ``models/vit.py`` in torch.

- The patch embedding is flax's VALID stride-p p x p conv, run as what it
  is: each patch flattened in (row, column, channel) order against the
  HWIO kernel ``patch_embed.kernel`` [p, p, C, E] read as [p*p*C, E]
  (:class:`~.transformer.Dense` over the trailing (p, p, C) dims), so the
  kernel keeps JAX's layout.
- A CLS token, learned position embeddings, the pre-LN encoder with exact
  GELU and LayerNorm eps 1e-12, non-causal; the CLS token's final state
  through the ``head`` gives fp32 logits.
- The fp32 ``cls_token`` and ``pos_embed`` promote the bf16 patch
  embeddings to fp32, as jnp's promotion does, so the residual stream is
  fp32 and each block's LayerNorm casts its input to the compute dtype.
- Names are the flax tree's (``patch_embed``, ``cls_token``, ``pos_embed``,
  ``encoder.block_{i}``, ``ln_f``, ``head``): ``weights.from_jax_params``
  loads a JAX init one to one.

With ``attn_impl='flash'`` the 197 tokens of ViT-L/16 at 224² are padded
to 256, the padded columns hidden by the kernels' static limit.

On a ``mesh`` with tp or fsdp above 1 the model holds this rank's blocks
(``sharding.shard_model``): the encoder's heads and MLP units over tp
(``parallel.tp``), the head's classes over tp (21843 cut into blocks of
``ceil(21843 / tp)``, the last padded with zeros; the logits gathered over
tp before the loss), every ``embed`` dimension (the patch kernel's output,
``cls_token``, ``pos_embed``, the encoder's) over fsdp (``parallel.fsdp``).
``sequence_parallel``: between the blocks a rank holds ``ceil(197 / tp)``
of the tokens, the last rank's shard padded (``parallel.tp.seq_shard``).

On a ``mesh`` with cp > 1 (a context-parallel core, at a token count cp
divides: 226 at image 240, not ViT-L/16's 197, which raises the
reference's ``seq % cp`` error) a rank embeds its contiguous block of the
tokens only: the CLS token and the first patches on cp rank 0, its block
of ``pos_embed`` on each. The CLS token's final state lives on rank 0, and
every cp rank reads it through a sum over cp whose backward sums the
cotangents (``comms.psum_differentiable``): rank 0 gets the cotangent of
every rank's copy of the loss, so the mean over cp of the ranks' gradients
that the Trainer takes is the one-process gradient. Each cp rank runs the
head on the same rows (``cp_repeated``).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import comms
from ..parallel.fsdp import full_param
from ..parallel.sp_ring import check_ring_shapes
from ..parallel.sp_ulysses import check_ulysses_shapes
from ..parallel.tp import (
    check_tp_fsdp,
    class_parallel_logits,
    draw_block,
    seq_shard,
    tp_rules,
)
from ..sharding import shard_model
from . import register
from .gpt2 import as_torch_dtype
from .transformer import (
    Dense,
    LayerNorm,
    TransformerStack,
    act_cuts,
    check_attn,
    dropout,
)

CHANNELS = 3  # RGB, as every image kind draws


class ViT(nn.Module):
    # The work every tp rank repeats whole, and every cp rank
    # (``benchmark.model_share``).
    tp_repeated = ("patch_embed",)
    cp_repeated = ("head",)

    def __init__(self, num_classes: int = 21843, image_size: int = 224,
                 patch_size: int = 16, num_layers: int = 24,
                 num_heads: int = 16, embed_dim: int = 1024,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0,
                 remat: str = "none", dtype="float32",
                 attn_impl: str = "xla", sequence_parallel: bool = False,
                 mesh=None, device=None):
        super().__init__()
        check_attn(attn_impl, mesh)
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is no multiple of "
                             f"patch_size {patch_size}")
        tp = check_tp_fsdp("vit", mesh, num_heads=num_heads)
        self.sequence_parallel = sequence_parallel and tp > 1
        self.num_classes, self.image_size = num_classes, image_size
        self.patch_size = patch_size
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.head_dim = embed_dim, embed_dim // num_heads
        self.dropout_rate, self.remat = dropout_rate, remat
        self.attn_impl, self.mesh = attn_impl, mesh
        self.dtype = as_torch_dtype(dtype)
        p, n_tokens = patch_size, (image_size // patch_size) ** 2 + 1
        _check_cp(mesh, attn_impl, num_heads, n_tokens)
        self.patch_embed = Dense((p, p, CHANNELS), (embed_dim,), self.dtype,
                                 device)
        self.cls_token = nn.Parameter(torch.empty(1, embed_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(n_tokens, embed_dim,
                                                  device=device))
        self.encoder = TransformerStack(
            num_layers, embed_dim, num_heads, self.head_dim,
            mlp_ratio * embed_dim, 1e-12, self.dtype, device, pre_ln=True,
            causal=False, activation="gelu_exact", remat=remat,
            attn_impl=attn_impl, dropout_rate=dropout_rate, mesh=mesh,
            sequence_parallel=self.sequence_parallel)
        self.ln_f = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.head = Dense((embed_dim,), (-(-num_classes // tp),), self.dtype,
                          device)
        # This rank's blocks of the leaves over tp and fsdp (None: whole).
        self.shards = shard_model(self, mesh, tp_rules(sequence_parallel),
                                  num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn on the CPU from
        ``generator``: the patch kernel, ``pos_embed`` and the encoder's
        kernels normal(0.02); ``cls_token``, the head and every bias zero;
        LayerNorm scales one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "pos_embed" or (leaf == "kernel"
                                       and not name.startswith("head.")):
                p.copy_(draw_block(self.shards, name, p, 0.02, generator))
            elif leaf == "scale":
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        """``images`` [B, H, W, C] (NHWC, as the JAX batches) -> fp32
        logits [B, num_classes]. ``train=True`` applies dropout from
        ``generator``."""
        B, H, W, C = images.shape
        if (H, W, C) != (self.image_size, self.image_size, CHANNELS):
            raise ValueError(f"images {tuple(images.shape[1:])} but the "
                             f"model takes {self.image_size}² x {CHANNELS}")
        if train and self.dropout_rate and generator is None:
            raise ValueError("train=True with dropout_rate > 0 needs a "
                             "dropout generator")
        gen = generator if train else None
        p, mesh = self.patch_size, self.mesh
        patches = images.reshape(B, H // p, p, W // p, p, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, -1, p, p, C)
        cp = 1 if mesh is None else mesh.shape["cp"]
        c = 0 if cp == 1 else mesh.coords["cp"]
        n = (patches.shape[1] + 1) // cp  # the tokens of a cp block
        # Token t > 0 is patch t - 1: rank c embeds tokens [c n, (c + 1) n).
        x = self.patch_embed(patches[:, max(c * n - 1, 0):(c + 1) * n - 1])
        cls_token = full_param(self, "cls_token")
        dt = torch.promote_types(x.dtype, cls_token.dtype)
        if c == 0:
            cls = cls_token.to(dt)[None].expand(B, 1, self.embed_dim)
            x = torch.cat([cls, x.to(dt)], dim=1)
        x = x + full_param(self, "pos_embed")[c * n:(c + 1) * n][None]
        x = dropout(x, self.dropout_rate, gen, mesh, act_cuts(mesh))
        if not self.sequence_parallel:
            x = self.ln_f(self.encoder(x, generator=gen))
        else:
            # The rank's shard of the tokens between the blocks; the whole
            # block back after the final LayerNorm (each rank's slice of
            # its gradient kept: the CLS row's, whole on every rank).
            x = self.encoder(seq_shard(x, mesh), generator=gen, seq_len=n)
            x = comms.all_gather_fwd_slice_bwd(self.ln_f(x), mesh, "tp", 1)
        x = x[:, 0]  # the CLS token (cp rank 0's first)
        if cp > 1:
            # Zeros off rank 0, the graph kept: every rank's backward runs
            # its blocks, whose ring or all-to-all backward the others wait
            # on.
            x = comms.psum_differentiable(
                torch.where(torch.tensor(c == 0, device=x.device), x,
                            torch.zeros((), dtype=x.dtype, device=x.device)),
                mesh, "cp")
        return class_parallel_logits(x, self.head, mesh,
                                     self.num_classes).float()


def _check_cp(mesh, attn_impl: str, num_heads: int, n_tokens: int) -> None:
    """ViT's tokens over cp ranks: the reference's shape errors where cp
    does not divide them (ViT-L/16's 197 under any cp core)."""
    cp = 1 if mesh is None else mesh.shape["cp"]
    if cp == 1 or attn_impl in ("xla", "flash"):
        return  # the Trainer refuses a core that does not split over cp
    if attn_impl in ("ring", "ring_pallas"):
        check_ring_shapes(n_tokens, cp)
    else:
        check_ulysses_shapes(num_heads, n_tokens, mesh.shape["tp"], cp)


@register("vit")
def vit(size: str = "l16", **kwargs) -> ViT:
    sizes = {
        # (layers, heads, embed, patch)
        "tiny": (2, 4, 64, 8),
        "b16": (12, 12, 768, 16),
        "l16": (24, 16, 1024, 16),
    }
    n_l, n_h, d, p = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d, patch_size=p)
    defaults.update(kwargs)
    return ViT(**defaults)
