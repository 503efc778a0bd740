"""Pipelined transformer models over the ``pp`` axis: the JAX package's
``models/pipeline.py`` in torch (``gpt2_pp``, ``llama_pp``, ``bert_pp``).

The blocks sit in one stage-stacked tree, ``h.stages.block_j...`` (BERT:
``encoder.stages...``) with a leading stage dim, as in the JAX tree; a rank
holds its rows of it (``parallel.pp.StageRows``): ``[1, ...]`` when the
model pipelines over ``pp = num_stages`` ranks, the whole ``[S, ...]`` on
one rank or with ``pipeline=False`` (the stages back to back, the
reference's sequential oracle). The position table and the final norm are
replicated on every rank of the axis; the token tables (and Llama's
untied head) are cut over it (``vocab_pp``, below).

- ``forward`` (evaluation, any caller): every rank embeds, the stages run
  as a pipeline whose output every rank of the axis gets, and every rank
  runs the head, as the reference's SPMD program does;
- :meth:`_Pipelined.pipeline_value_and_grad` (the Trainer's step): the
  embedding runs on stage 0 only and the head on the last stage only; the
  ``gpipe`` and ``1f1b`` schedules take the task's loss over the whole
  local batch on the last stage, ``1f1b_interleaved`` the engine's mean of
  microbatch losses; the shared leaves' gradients are summed over ``pp``.

Every stage block attends with the plain core (``attn_impl='xla'``), as the
reference's stages do; the models have no dropout and no remat.

On a ``mesh`` with tp or fsdp above 1 (``sharding.shard_model``) a rank
holds its blocks of every leaf, the stage leaves' ``[rows, ...]`` cut past
their stage dim as their block's leaves are (JAX's
``manual_tp_stage_setup``: heads, ``mlp_dim`` and Llama's ``num_kv_heads``
over tp, with JAX's divisibility errors; ``embed`` over fsdp). A stage's
blocks run tp-local behind the f/g markers (``parallel.tp``), each
row-parallel bias added once after g, so torch's autograd gives every tp
rank the whole gradient of the replicated leaves and JAX's 1/tp pre-scale of
those biases has no counterpart; a block's leaves are gathered over fsdp in
its forward, freed at its end and gathered again in its backward
(``parallel.fsdp.reshard_after_forward``). The embedding is vocab-parallel
on stage 0 and the tied (or untied) head is the vocab-parallel chunked head
on the last stage (``ops.chunked_xent``), both over the stage's tp ranks;
the pipeline's activations and cotangents are whole on every tp rank, so
stage ``s`` exchanges with the stages that share its tp, fsdp and dp
coordinates. The batch is split over dp x fsdp. On every mesh pipelined
over pp (pp alone too) the embedding tables (and Llama's untied head) are
JAX's ``vocab_pp``: each pp rank stores its block of the table's tp slice
(of the whole table at tp = 1), not a copy of it; the stages' ranks
all-gather the slice over pp before a step or an evaluation, and each
keeps its block of the gradient summed over pp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import comms
from ..parallel import pp
from ..parallel.fsdp import full_param
from ..parallel.tp import (
    VocabShard,
    gather_columns,
    tp_size,
    vocab_parallel_embed,
)
from ..sharding import SHARD_AXES, make_rules, shard_model
from . import register
from .gpt2 import Embed, as_torch_dtype
from .llama import LlamaBlock, RMSNorm, rope_tables
from .transformer import (
    Dense,
    LayerNorm,
    TransformerBlock,
    block_scope,
    gelu_exact,
)

SCHEDULES = ("gpipe", "1f1b", "1f1b_interleaved")


class PipelineStage(nn.Module):
    """``num_layers`` blocks ``block_{j}`` of one stage: the GPT-2/BERT
    family's ``TransformerBlock`` or Llama's ``LlamaBlock`` (RoPE over the
    stage input's positions, GQA, SwiGLU). On a ``mesh`` with tp > 1 each
    block holds the rank's heads and MLP units; under fsdp each block's
    gathered leaves are freed at the end of its forward."""

    def __init__(self, num_layers, embed_dim, num_heads, head_dim, mlp_dim, *,
                 pre_ln=True, causal=False, activation="gelu_exact",
                 ln_eps=1e-5, dtype=torch.float32, block_kind="gpt2",
                 num_kv_heads=0, rope_theta=10000.0, mesh=None, device=None):
        super().__init__()
        if block_kind not in ("gpt2", "llama"):
            raise ValueError(f"unknown block_kind {block_kind!r}")
        self.num_layers, self.block_kind = num_layers, block_kind
        self.head_dim, self.rope_theta = head_dim, rope_theta
        self.mesh = mesh
        for j in range(num_layers):
            if block_kind == "llama":
                block = LlamaBlock(embed_dim, num_heads, num_kv_heads,
                                   head_dim, mlp_dim, ln_eps, dtype, device,
                                   mesh=mesh)
            else:
                block = TransformerBlock(
                    embed_dim, num_heads, head_dim, mlp_dim, ln_eps, dtype,
                    device, pre_ln=pre_ln, causal=causal,
                    activation=activation, mesh=mesh)
            self.add_module(f"block_{j}", block)

    def forward(self, x, mask=None):
        if self.block_kind == "llama":
            if mask is not None:
                raise NotImplementedError(
                    "llama pipeline stages are causal-LM only — key-padding "
                    "masks apply to the gpt2/bert block family"
                )
            rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                               self.head_dim, self.rope_theta)
            for j in range(self.num_layers):
                with block_scope(self.mesh, "none"):
                    x = getattr(self, f"block_{j}")(x, rope)
            return x
        for j in range(self.num_layers):
            with block_scope(self.mesh, "none"):
                x = getattr(self, f"block_{j}")(x, mask=mask)
        return x


class PipelinedTransformerStack(nn.Module):
    """The stage-stacked blocks: ``stages`` is a :class:`PipelineStage`
    whose every parameter has a leading dim of this rank's stage rows. On
    ``mesh.pp == num_stages`` (and ``pipeline``) it runs a pipeline
    schedule over pp; else its ``num_stages`` rows back to back."""

    def __init__(self, num_layers, num_stages, num_microbatches, embed_dim,
                 num_heads, head_dim, mlp_dim, *, pre_ln=True, causal=False,
                 activation="gelu_exact", ln_eps=1e-5, dropout_rate=0.0,
                 dtype=torch.float32, pipeline=True, schedule="gpipe",
                 mesh=None, block_kind="gpt2", num_kv_heads=0,
                 rope_theta=10000.0, device=None):
        super().__init__()
        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown pipeline schedule {schedule!r}; "
                "expected 'gpipe', '1f1b' or '1f1b_interleaved'"
            )
        if num_layers % num_stages:
            raise ValueError(
                f"pipeline: num_layers={num_layers} not divisible by "
                f"num_stages={num_stages}"
            )
        size = pp.stage_count(mesh)
        self.pipelined = bool(pipeline) and size > 1
        if self.pipelined and size != num_stages:
            raise ValueError(f"mesh pp={size} != num_stages={num_stages}")
        tp = tp_size(mesh)
        if tp > 1:
            # JAX's manual_tp_stage_setup: a stage runs on the rank's heads.
            if num_heads % tp or mlp_dim % tp:
                raise ValueError(
                    f"pp×tp: num_heads={num_heads} and mlp_dim={mlp_dim} "
                    f"must be divisible by tp={tp}")
            if block_kind == "llama" and num_kv_heads % tp:
                raise ValueError(f"pp×tp: num_kv_heads={num_kv_heads} must "
                                 f"be divisible by tp={tp}")
        self.num_layers, self.num_stages = num_layers, num_stages
        self.num_microbatches, self.schedule = num_microbatches, schedule
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.embed_dim, self.dtype = embed_dim, dtype
        self.stages = PipelineStage(
            num_layers // num_stages, embed_dim, num_heads, head_dim,
            mlp_dim, pre_ln=pre_ln, causal=causal, activation=activation,
            ln_eps=ln_eps, dtype=dtype, block_kind=block_kind,
            num_kv_heads=num_kv_heads, rope_theta=rope_theta, mesh=mesh,
            device=device)
        rows = 1 if self.pipelined else num_stages
        self.first = mesh.coords["pp"] if self.pipelined else 0
        for mod in self.stages.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(
                    torch.empty((rows, *p.shape), device=p.device)))

    def stage_fn(self, params: dict, x, mask=None):
        """One stage on ``x`` from ``params`` (the stage's leaves without
        the stage dim, named inside ``stages``)."""
        return functional_call(self.stages, params, (x,), {"mask": mask})

    def stacked(self) -> dict:
        return dict(self.stages.named_parameters())

    def check(self, x, mask, train: bool) -> None:
        """The reference's fences on a call with ``x`` [local batch, ...]."""
        if mask is not None:
            if self.schedule == "1f1b_interleaved":
                raise NotImplementedError(
                    "key-padding masks compose with the 'gpipe' and '1f1b' "
                    "schedules only (the interleaved engine is causal-LM "
                    "only)"
                )
            if self.stages.block_kind == "llama":
                raise NotImplementedError(
                    "llama pipeline stages are causal-LM only — key-padding "
                    "masks apply to the gpt2/bert block family"
                )
            if mask.ndim != 2:
                raise ValueError(
                    "pipelined stack supports [batch, k_len] key-padding "
                    f"masks; got ndim={mask.ndim}"
                )
        if self.dropout_rate and train:
            raise NotImplementedError(
                "dropout inside pipeline stages is not supported (set "
                "dropout_rate=0 or deterministic=True)"
            )
        pp.check_pipeline_shapes(x.shape[0], self.num_microbatches,
                                 self.num_layers, self.num_stages)

    def act(self, batch: int, seq: int) -> tuple:
        """A microbatch's activation: (shape, dtype)."""
        return ((batch // self.num_microbatches, seq, self.embed_dim),
                self.dtype)

    def forward(self, x, mask=None, *, train: bool = False):
        """The stages on ``x``; pipelined, every rank of pp gets the last
        stage's output (differentiable under the ``gpipe`` and ``1f1b``
        engines, whose backward every rank runs; the interleaved schedule's
        forward is gpipe's, as in the reference)."""
        self.check(x, mask, train)
        if not self.pipelined:
            return pp.sequential(self.stage_fn, self.stacked(), x, mask)
        kw = dict(mesh=self.mesh, num_microbatches=self.num_microbatches,
                  extra=mask)
        if not torch.is_grad_enabled():
            return pp.forward_only(self.stage_fn, self.stacked(), x, **kw)
        engine = pp.one_f_one_b if self.schedule == "1f1b" else pp.gpipe
        return engine(self.stage_fn, self.stacked(), x, **kw)


def _part(module: nn.Module, name: str, shared: dict, *args):
    """Submodule ``name`` of ``module`` called on ``args`` with its
    parameters taken from ``shared`` (keyed by the model's names)."""
    prefix = name + "."
    return functional_call(getattr(module, name), {
        k[len(prefix):]: v for k, v in shared.items()
        if k.startswith(prefix)}, args)


class _Pipelined(nn.Module):
    """What the three pipelined models share: the stack ``self.<STACK>``,
    the replicated leaves, initialization by rows, the two training paths.
    A model defines ``embed_tokens(shared, tokens, *extra)``, ``head(shared,
    y)`` and ``_draw(name, shape, generator)``."""

    STACK = "h"
    # The tables whose vocabulary is JAX's ``vocab_pp``.
    VOCAB_PP: tuple = ()
    shards = None  # sharding.ShardLayout under tp or fsdp (``_place``)

    def _place(self, vocab_size: int) -> None:
        """Cut the leaves over the mesh's tp and fsdp (``sharding.
        shard_model``), the tables' tp slices over pp too (at pp alone the
        tables only), the stage rows counted over pp in a norm."""
        self.shards = shard_model(self, self.mesh, make_rules(), vocab_size,
                                  self.VOCAB_PP if self.pipelined else ())
        if self.shards is not None and self.pipelined:
            self.shards.pp_names = set(self.stage_rows.names)

    def _pp_tables(self) -> list:
        """The leaves this rank holds a pp block of (``vocab_pp``)."""
        if self.shards is None:
            return []
        return [k for k, dims in self.shards.dims.items() if "pp" in dims]

    def _whole_shared(self, track: bool = False) -> dict:
        """:meth:`shared`, each ``vocab_pp`` table all-gathered over pp
        into its tp slice, as the embedding and the head use it (every
        stage's rank takes part); with ``track``, leaves that autograd
        differentiates against."""
        shared = self.shared()
        for k in self._pp_tables():
            t = self.shards.gather_axis(k, shared[k], "pp")
            shared[k] = t.requires_grad_() if track else t
        return shared

    def _own_blocks(self, grads: dict) -> dict:
        """``grads`` with each ``vocab_pp`` table's (its tp slice's,
        summed over pp) cut to this rank's pp block."""
        for k in self._pp_tables():
            grads[k] = self.shards.take_axis(k, grads[k], "pp")
        return grads

    def _whole_leaf(self, name: str, shared: dict, dtype=None):
        """Leaf ``name`` of ``shared`` whole over fsdp (gathered in
        ``dtype`` when ``shard_model`` cut it), as it is otherwise."""
        owner_name, _, leaf = name.rpartition(".")
        owner = self.get_submodule(owner_name) if owner_name else self
        return full_param(owner, leaf, dtype, shared[name])

    def _embed_vocab(self, name: str, shared: dict, tokens):
        """The lookup of ``tokens`` in embedding module ``name``:
        vocab-parallel over tp (each token's row from the rank that holds
        it, summed), plain otherwise."""
        if tp_size(self.mesh) == 1:
            return _part(self, name, shared, tokens)
        table = self._whole_leaf(f"{name}.embedding", shared)
        return vocab_parallel_embed(
            tokens, table, VocabShard.of(self.mesh, self.vocab_size),
            self.dtype, False)

    def _decode(self, x, dec, bias=None):
        """The LM head on the final states ``x`` with decoder ``dec`` [rows,
        E] (compute dtype) and ``bias``: fp32 logits, or under tp or fsdp
        the vocab-parallel chunked head (``ops.chunked_xent``) behind f."""
        if self.shards is None or not any(
                self.mesh.shape[a] > 1 for a in SHARD_AXES):
            logits = x @ dec.t()
            return (logits if bias is None else logits + bias).float()
        from ..ops.chunked_xent import head_output

        vocab = None
        if tp_size(self.mesh) > 1:
            x = comms.identity_fwd_psum_bwd(x, self.mesh, "tp")
            vocab = VocabShard.of(self.mesh, self.vocab_size)
        return head_output(x, dec, bias, vocab=vocab)

    @property
    def stack(self) -> PipelinedTransformerStack:
        return getattr(self, self.STACK)

    @property
    def pipelined(self) -> bool:
        return self.stack.pipelined

    @property
    def stage_rows(self) -> pp.StageRows:
        prefix = f"{self.STACK}.stages."
        st = self.stack
        n = st.num_stages if not st.pipelined else 1
        return pp.StageRows(
            {k for k, _ in self.named_parameters() if k.startswith(prefix)},
            st.num_stages, st.first * n, st.first * n + n,
            st.mesh if st.pipelined else None)

    def shared(self) -> dict:
        prefix = f"{self.STACK}.stages."
        return {k: p for k, p in self.named_parameters()
                if not k.startswith(prefix)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's distributions drawn on the CPU from
        ``generator``: every leaf is drawn at its WHOLE shape (a stage leaf
        for all ``num_stages``), in the parameters' order, and this rank
        keeps its rows, so every ``pp`` gives the weights ``pp = 1``
        draws."""
        rows, shards = self.stage_rows, self.shards
        for name, p in self.named_parameters():
            shape = (p.shape if shards is None
                     else shards.whole_shape(name, p.shape))
            full = self._draw(name, rows.whole_shape(name, shape), generator)
            full = rows.take({name: full})[name]
            p.copy_(full if shards is None else shards.take_leaf(name, full))

    def _sequence(self, shared, tokens, *extra):
        """(stage input, mask): the embedded tokens and this batch's
        key-padding mask, if the model takes one."""
        return self.embed_tokens(shared, tokens, *extra), None

    def forward(self, tokens, *extra, train: bool = False, generator=None):
        del generator  # no dropout
        shared = self._whole_shared()
        x, mask = self._sequence(shared, tokens, *extra)
        return self.head(shared, self.stack(x, mask, train=train))

    def pipeline_value_and_grad(self, batch: dict, task):
        """One training schedule on this rank's ``batch``: ``(loss, grads
        by parameter name, metrics)``. The loss and metrics hold on every
        rank of ``pp``; the shared leaves' gradients are summed over ``pp``
        (the embedding's from stage 0, the head's from the last stage) and
        the stage leaves' are this rank's. The mean over the batch axes is
        the caller's."""
        st = self.stack
        if st.schedule == "1f1b_interleaved":
            return self._interleaved(batch)
        inputs = task.input_fn(batch)
        tokens, extra = inputs[0], inputs[1:]
        mask = extra[0] if extra else None
        st.check(tokens, mask, True)
        mesh = st.mesh if st.pipelined else None
        S, s = pp.stage_count(mesh), st.first
        shared = self._whole_shared(track=True)
        params = {**dict(self.named_parameters()), **shared}
        engine = pp.one_f_one_b if st.schedule == "1f1b" else pp.gpipe
        with torch.enable_grad():
            x = self.embed_tokens(shared, tokens, *extra) if s == 0 else None
            y = engine(st.stage_fn, st.stacked(), x, mesh=mesh,
                       num_microbatches=st.num_microbatches, extra=mask,
                       broadcast=False,
                       act=st.act(tokens.shape[0], tokens.shape[1]))
            if s == S - 1:
                loss, metrics = task.loss_fn(self.head(shared, y), batch)
                target, cot = loss, None
            else:
                target, cot = y, torch.zeros_like(y)
        names = list(params)
        got = torch.autograd.grad(target, [params[n] for n in names], cot,
                                  allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, got)}
        summed, metrics = self._over_stages(
            metrics if s == S - 1 else None, task, tokens.device, mesh,
            [grads[n] for n in shared])
        grads.update(zip(shared, summed))
        return metrics["loss"], self._own_blocks(grads), metrics

    @staticmethod
    def _over_stages(metrics, task, device, mesh, tensors=()):
        """``tensors`` and the last stage's ``metrics`` (None on the other
        stages, which hold zeros for them) summed over pp: (the tensors,
        the metrics), on every rank of the axis."""
        if metrics is None:
            metrics = {k: torch.zeros((), device=device) for k in task.keys}
        keys, n = list(metrics), len(tensors)
        summed = pp.psum_shared(
            list(tensors) + [metrics[k].float() for k in keys], mesh)
        return summed[:n], dict(zip(keys, summed[n:]))

    @torch.no_grad()
    def pipeline_eval(self, batch: dict, task) -> dict:
        """The task's metrics on this rank's ``batch`` from the forward
        schedule, on every rank of ``pp``: the last stage runs the head and
        the task's loss, and its metrics are summed over ``pp`` (zeros
        elsewhere), so the head's logits exist on one rank only."""
        st = self.stack
        inputs = task.input_fn(batch)
        tokens, extra = inputs[0], inputs[1:]
        mask = extra[0] if extra else None
        st.check(tokens, mask, False)
        shared = self._whole_shared()
        x = (self.embed_tokens(shared, tokens, *extra)
             if st.first == 0 else None)
        y = pp.forward_only(st.stage_fn, st.stacked(), x, mesh=st.mesh,
                            num_microbatches=st.num_microbatches,
                            extra=mask, broadcast=False,
                            act=st.act(tokens.shape[0], tokens.shape[1]))
        metrics = None
        if st.first == st.num_stages - 1:
            _, metrics = task.loss_fn(self.head(shared, y), batch)
        return self._over_stages(metrics, task, tokens.device, st.mesh)[1]

    def _interleaved(self, batch: dict):
        """The interleaved 1F1B step on a causal-LM batch (``tokens``)."""
        st = self.stack
        tokens = batch["tokens"]
        st.check(tokens[:, :-1], None, True)

        def embed_fn(shared, bm):
            return self.embed_tokens(shared, bm["tokens"][:, :-1])

        def head_fn(shared, y, bm):
            from ..ops.chunked_xent import chunked_xent, is_chunked_head

            logits, targets = self.head(shared, y), bm["tokens"][:, 1:]
            if is_chunked_head(logits):
                return chunked_xent(logits, targets).mean()
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1).long())

        loss, (dstacked, dshared) = pp.interleaved_1f1b(
            embed_fn, st.stage_fn, head_fn, st.stacked(),
            self._whole_shared(),
            {"tokens": tokens}, mesh=st.mesh if st.pipelined else None,
            num_microbatches=st.num_microbatches,
            act=st.act(tokens.shape[0], tokens.shape[1] - 1))
        prefix = f"{self.STACK}.stages."
        grads = {**dshared, **{prefix + k: g for k, g in dstacked.items()}}
        return loss, self._own_blocks(grads), {"loss": loss}


def _normal(shape, std, generator):
    return torch.empty(shape).normal_(std=std, generator=generator)


class PipelinedGPT2(_Pipelined):
    """GPT-2 with a pipelined block stack (the embeddings and tied head of
    ``models/gpt2.py``): ``wte``, ``wpe``, ``h.stages``, ``ln_f``."""

    VOCAB_PP = ("wte.embedding",)

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, num_heads: int = 12,
                 embed_dim: int = 768, num_stages: int = 2,
                 num_microbatches: int = 2, pipeline: bool = True,
                 schedule: str = "gpipe", dtype="float32", mesh=None,
                 device=None):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.num_stages = embed_dim, num_stages
        self.num_microbatches, self.pipeline = num_microbatches, pipeline
        self.schedule, self.mesh = schedule, mesh
        self.dtype = as_torch_dtype(dtype)
        self.wte = Embed(-(-vocab_size // tp_size(mesh)), embed_dim,
                         self.dtype, device)
        self.wpe = Embed(max_len, embed_dim, self.dtype, device)
        self.h = PipelinedTransformerStack(
            num_layers, num_stages, num_microbatches, embed_dim, num_heads,
            embed_dim // num_heads, 4 * embed_dim, pre_ln=True, causal=True,
            activation="gelu_tanh", ln_eps=1e-5, dtype=self.dtype,
            pipeline=pipeline, schedule=schedule, mesh=mesh, device=device)
        self.ln_f = LayerNorm(embed_dim, 1e-5, self.dtype, device)
        self._place(vocab_size)

    def _draw(self, name, shape, generator):
        leaf = name.rsplit(".", 1)[-1]
        if name == "wpe.embedding":
            return _normal(shape, 0.01, generator)
        if leaf in ("embedding", "kernel"):
            return _normal(shape, 0.02, generator)
        return torch.ones(shape) if leaf == "scale" else torch.zeros(shape)

    def embed_tokens(self, shared, tokens):
        L = tokens.shape[1]
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        pos = torch.arange(L, device=tokens.device)[None, :]
        return (self._embed_vocab("wte", shared, tokens)
                + _part(self, "wpe", shared, pos))

    def head(self, shared, y):
        x = _part(self, "ln_f", shared, y)
        return self._decode(x, self._whole_leaf(
            "wte.embedding", shared, self.dtype).to(self.dtype))


class PipelinedLlama(_Pipelined):
    """Llama with a pipelined block stack (``models/llama.py``'s blocks and
    head): ``embed``, ``h.stages``, ``norm``, and ``lm_head`` [E, V]
    unless ``tie_embeddings``."""

    VOCAB_PP = ("embed.embedding", "lm_head")

    def __init__(self, vocab_size: int = 32000, max_len: int = 4096,
                 num_layers: int = 8, num_heads: int = 8,
                 num_kv_heads: int = 4, embed_dim: int = 512,
                 mlp_dim: int = 1408, rope_theta: float = 10000.0,
                 rms_eps: float = 1e-6, num_stages: int = 2,
                 num_microbatches: int = 2, pipeline: bool = True,
                 schedule: str = "gpipe", dtype="float32", mesh=None,
                 tie_embeddings: bool = False, device=None):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads, self.embed_dim = num_kv_heads, embed_dim
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self.pipeline, self.schedule, self.mesh = pipeline, schedule, mesh
        self.tie_embeddings = tie_embeddings
        self.dtype = as_torch_dtype(dtype)
        self.embed = Embed(-(-vocab_size // tp_size(mesh)), embed_dim,
                           self.dtype, device)
        self.h = PipelinedTransformerStack(
            num_layers, num_stages, num_microbatches, embed_dim, num_heads,
            embed_dim // num_heads, mlp_dim, ln_eps=rms_eps,
            dtype=self.dtype, pipeline=pipeline, schedule=schedule,
            mesh=mesh, block_kind="llama", num_kv_heads=num_kv_heads,
            rope_theta=rope_theta, device=device)
        self.norm = RMSNorm(embed_dim, rms_eps, self.dtype, device)
        if not tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                embed_dim, -(-vocab_size // tp_size(mesh)), device=device))
        self._place(vocab_size)

    def _draw(self, name, shape, generator):
        if name.rsplit(".", 1)[-1] == "scale":
            return torch.ones(shape)
        return _normal(shape, 0.02, generator)

    def embed_tokens(self, shared, tokens):
        L = tokens.shape[1]
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        return self._embed_vocab("embed", shared, tokens)

    def head(self, shared, y):
        x = _part(self, "norm", shared, y)
        name = "embed.embedding" if self.tie_embeddings else "lm_head"
        dec = self._whole_leaf(name, shared, self.dtype).to(self.dtype)
        return self._decode(x, dec if self.tie_embeddings else dec.t())


class PipelinedBERT(_Pipelined):
    """BERT MLM with a pipelined encoder (``models/bert.py``'s embeddings,
    post-LN blocks and tied MLM head, no dropout): the key-padding
    ``attention_mask`` goes to every stage, each taking its microbatch's
    rows. ``gpipe`` and ``1f1b`` only."""

    STACK = "encoder"
    VOCAB_PP = ("word_embeddings.embedding",)

    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 type_vocab_size: int = 2, num_layers: int = 12,
                 num_heads: int = 12, embed_dim: int = 768,
                 num_stages: int = 2, num_microbatches: int = 2,
                 pipeline: bool = True, schedule: str = "gpipe",
                 dtype="float32", mesh=None, device=None):
        super().__init__()
        if schedule not in ("gpipe", "1f1b"):
            raise NotImplementedError(
                "PipelinedBERT supports the 'gpipe' and '1f1b' schedules "
                "(the interleaved engine is causal-LM only)"
            )
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.embed_dim, self.num_stages = embed_dim, num_stages
        self.num_microbatches, self.pipeline = num_microbatches, pipeline
        self.schedule, self.mesh = schedule, mesh
        self.dtype = as_torch_dtype(dtype)
        tp = tp_size(mesh)
        if embed_dim % tp:
            raise ValueError(f"bert_pp at mesh tp={tp}: mlm_transform's "
                             f"{embed_dim} units not divisible by tp={tp}")
        self.word_embeddings = Embed(-(-vocab_size // tp), embed_dim,
                                     self.dtype, device)
        self.position_embeddings = Embed(max_len, embed_dim, self.dtype,
                                         device)
        self.token_type_embeddings = Embed(type_vocab_size, embed_dim,
                                           self.dtype, device)
        self.embeddings_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.encoder = PipelinedTransformerStack(
            num_layers, num_stages, num_microbatches, embed_dim, num_heads,
            embed_dim // num_heads, 4 * embed_dim, pre_ln=False,
            causal=False, activation="gelu_exact", ln_eps=1e-12,
            dtype=self.dtype, pipeline=pipeline, schedule=schedule,
            mesh=mesh, device=device)
        self.mlm_transform = Dense((embed_dim,), (embed_dim // tp,),
                                   self.dtype, device)
        self.mlm_ln = LayerNorm(embed_dim, 1e-12, self.dtype, device)
        self.mlm_bias = nn.Parameter(torch.empty(-(-vocab_size // tp),
                                                 device=device))
        self._place(vocab_size)

    def _draw(self, name, shape, generator):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("embedding", "kernel"):
            return _normal(shape, 0.02, generator)
        return torch.ones(shape) if leaf == "scale" else torch.zeros(shape)

    def embed_tokens(self, shared, tokens, attention_mask=None,
              token_type_ids=None):
        del attention_mask  # the stages' input, not the embeddings'
        L = tokens.shape[1]
        if L > self.max_len:
            raise ValueError(f"seq_len {L} exceeds max_len {self.max_len}")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        pos = torch.arange(L, device=tokens.device)[None, :]
        x = (self._embed_vocab("word_embeddings", shared, tokens)
             + _part(self, "position_embeddings", shared, pos)
             + _part(self, "token_type_embeddings", shared, token_type_ids))
        return _part(self, "embeddings_ln", shared, x)

    def _sequence(self, shared, tokens, attention_mask=None,
                  token_type_ids=None):
        return (self.embed_tokens(shared, tokens, None, token_type_ids),
                attention_mask)

    def head(self, shared, y):
        if tp_size(self.mesh) > 1:
            # mlm_transform's units are a column-parallel slice, gathered
            # whole before the LayerNorm (``models/bert.py``).
            y = comms.identity_fwd_psum_bwd(y, self.mesh, "tp")
        x = gelu_exact(_part(self, "mlm_transform", shared, y))
        x = _part(self, "mlm_ln", shared,
                  gather_columns(x, self.mesh, self.embed_dim))
        emb = self._whole_leaf("word_embeddings.embedding", shared,
                               self.dtype).to(self.dtype)
        return self._decode(x, emb, shared["mlm_bias"])


# The reference registers them without a remat field: its cli refuses
# train.remat for them. ``sequence_parallel`` is dropped: a stage's
# activations stay whole over tp, as the reference's stages see whole
# sequences inside their shard_map.
@register("bert_pp", remat=False, pipelined=True)
def bert_pp(size: str = "base", **kwargs) -> PipelinedBERT:
    sizes = {"tiny": (2, 4, 64), "base": (12, 12, 768),
             "large": (24, 16, 1024)}
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    kwargs.pop("sequence_parallel", None)
    defaults.update(kwargs)
    return PipelinedBERT(**defaults)


@register("llama_pp", remat=False, pipelined=True)
def llama_pp(size: str = "tiny", **kwargs) -> PipelinedLlama:
    sizes = {
        # (layers, heads, kv_heads, embed, mlp)
        "tiny": (4, 4, 2, 64, 128),
        "300m": (12, 16, 8, 1024, 2816),
        "1b": (16, 32, 8, 2048, 5632),
    }
    n_l, n_h, n_kv, d, m = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, num_kv_heads=n_kv,
                    embed_dim=d, mlp_dim=m)
    kwargs.pop("sequence_parallel", None)
    defaults.update(kwargs)
    return PipelinedLlama(**defaults)


@register("gpt2_pp", remat=False, pipelined=True)
def gpt2_pp(size: str = "124m", **kwargs) -> PipelinedGPT2:
    sizes = {
        "tiny": (4, 4, 64),
        "124m": (12, 12, 768),
        "350m": (24, 16, 1024),
    }
    n_l, n_h, d = sizes[size]
    defaults = dict(num_layers=n_l, num_heads=n_h, embed_dim=d)
    kwargs.pop("sequence_parallel", None)
    defaults.update(kwargs)
    return PipelinedGPT2(**defaults)
