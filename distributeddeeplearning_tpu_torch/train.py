"""Trainer of the port: tasks, the optimizer factory, the single-device
training step and the host loop.

The reference compiles one step program over a device mesh; here each rank
runs the step eagerly on its device, over its slice of the global batch
(rows over dp, the sequence over cp):

- compute cast of the fp32 masters (``precision``), forward with dropout
  from a generator seeded per step, backward by ``torch.autograd``;
- gradients to fp32 and averaged over every rank (``comms.pmean_tensors``,
  a few flat buckets), then the optimizer: global-norm clip before the
  update, and ``p += delta`` in place on the masters (the fused AdamW
  kernel, or the plain optax-semantics AdamW or SGD);
- the model's buffers (BatchNorm's running statistics) are
  ``TrainState.model_state``, updated in place by the training forward;
- the host loop logs ``{"loss", "perplexity", "step", "wall_s"}`` every
  ``log_every`` steps with one interval of lag, never draining the device
  queue for logging;
- ZeRO-1 over dp > 1 (``parallel.zero``): a reduce-scatter of the
  gradients, each rank's update of its shard, an all-gather of the masters;
- a model cut over tp, fsdp or ep (``sharding.shard_model``): each rank's
  params are its blocks; the tp and fsdp share of the batch mean
  (``parallel.fsdp.reduce_grads``) comes before the cp and dp sync (tp and
  ep ranks hold the same rows: nothing is averaged over them), the clip's
  and the guard's norm counts each block and each replicated leaf once;
- ``grad_accum`` microbatches a step, ``steps_per_call`` steps a call
  (:meth:`Trainer.fused_train_step`), and :func:`evaluate`; ``fit`` runs
  the cadences of logging, evaluation and checkpoints
  (``checkpoint.CheckpointManager``).

- the health guard (``health.py``, ``Trainer(health=...)``): the step is
  staged, its loss and global gradient norm read on the host before the
  update, and an anomalous step skips the update; ``fit`` raises
  :class:`HealthRollback` after ``max_consecutive_anomalies`` of them, and
  ``Trainer(fault_nan_step=K)`` poisons step K's gradients to exercise it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .comms import axis_size, pmean_tensors, psum
from .ops.fused_adamw import (
    FusedAdamW,
    FusedAdamWState,
    decay_leaf,
    f32,
    global_norm,
    stochastic_round,
)
from .precision import (
    Policy,
    cast_grads_to_update,
    cast_to_compute,
    check_precision_composition,
    get_policy,
)

# ---------------------------------------------------------------------------
# Tasks: how a model consumes a batch.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Task:
    """Adapter between a model and a batch dict."""

    input_fn: Callable[[dict], tuple]  # batch -> model positional args
    loss_fn: Callable[[Any, dict], tuple]  # (output, batch) -> (loss, metrics)
    # metrics averaged over the ranks -> the logged metrics
    finish_metrics: Callable[[dict], dict] = lambda m: m
    keys: tuple = ("loss",)  # the names of loss_fn's metrics


def _xent(logits, labels):
    """Per-position softmax cross-entropy in fp32 over [..., V] logits."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _per_token_xent(model_out, targets, head_chunk: int):
    """Per-token xent for either head form: full [B, L, V] logits, or a
    chunked-head dict that never materializes them."""
    from .ops.chunked_xent import chunked_xent, is_chunked_head

    if is_chunked_head(model_out):
        return chunked_xent(model_out, targets, seq_chunk=head_chunk)
    return _xent(model_out, targets)


def seq_block(x, mesh):
    """This cp rank's contiguous block ``[r*l, (r+1)*l)`` of dim 1."""
    cp = 1 if mesh is None else mesh.shape["cp"]
    if cp == 1:
        return x
    if x.shape[1] % cp:
        raise ValueError(f"seq_len {x.shape[1]} not divisible by cp={cp}")
    n = x.shape[1] // cp
    r = mesh.coords["cp"]
    return x[:, r * n:(r + 1) * n]


def lm_task(head_chunk: int = 128, mesh=None) -> Task:
    """Causal LM: predict tokens[1:] from tokens[:-1]. On a mesh with cp > 1
    both are cut to this rank's block of the positions AFTER the shift, so
    no target is lost at a block edge."""

    def input_fn(batch):
        return (seq_block(batch["tokens"][:, :-1], mesh),)

    def loss_fn(out, batch):
        targets = seq_block(batch["tokens"][:, 1:], mesh)
        loss = _per_token_xent(out, targets, head_chunk).mean()
        return loss, {"loss": loss}

    def finish_metrics(m):
        return {**m, "perplexity": torch.exp(m["loss"])}

    return Task(input_fn=input_fn, loss_fn=loss_fn,
                finish_metrics=finish_metrics)


def classification_task(label_smoothing: float = 0.0) -> Task:
    """Image classification: the mean softmax cross-entropy of the fp32
    logits against ``(1 - eps) onehot + eps / K`` (``label_smoothing`` eps;
    the MLPerf ResNet-50 recipe uses 0.1). Metrics: ``loss`` (the
    objective), ``xent`` (the plain cross-entropy, comparable across
    smoothing settings) and top-1 ``accuracy``."""

    def loss_fn(logits, batch):
        labels = batch["label"].long()
        logits = logits.float()
        xent = F.cross_entropy(logits, labels)
        if label_smoothing:
            k = logits.shape[-1]
            soft = (F.one_hot(labels, k).float() * (1.0 - label_smoothing)
                    + label_smoothing / k)
            loss = -(soft * F.log_softmax(logits, -1)).sum(-1).mean()
        else:
            loss = xent
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss, "xent": xent, "accuracy": acc}

    return Task(input_fn=lambda b: (b["image"],), loss_fn=loss_fn,
                keys=("loss", "xent", "accuracy"))


def mlm_task(head_chunk: int = 128, mesh=None) -> Task:
    """Masked LM: the loss on the masked positions only (label -1 is
    ignored), ``sum(xent * [label >= 0]) / max(count, 1)``. A batch's
    ``attention_mask`` (``synthetic_mlm`` with ``pad_min_len``) goes to the
    model as its key-padding mask; pad positions carry label -1, so they
    are outside the loss already. Metrics: ``loss`` and
    ``masked_fraction``.

    On a ``mesh`` of n > 1 ranks the count is the whole (micro)batch's, as
    the reference's loss over the global batch divides by it: a rank's
    loss is ``n * sum_rank / max(count, 1)``, so the mean over the ranks
    (the gradient and metric sync) is the global loss. The ``n`` ranks are
    those that split the batch's tokens, dp x fsdp x cp: the ranks of a
    ``pp`` or ``tp`` group hold the same rows. On a mesh with cp > 1 the
    tokens, the mask and the labels are cut to this rank's block of the
    positions, as the ``lm`` task cuts them."""
    from .mesh import BATCH_AXES

    axes = [] if mesh is None else [a for a in (*BATCH_AXES, "cp")
                                    if mesh.shape[a] > 1]
    ranks = math.prod(axis_size(mesh, a) for a in axes)

    def input_fn(batch):
        tokens = seq_block(batch["input_tokens"], mesh)
        if "attention_mask" in batch:
            return (tokens, seq_block(batch["attention_mask"], mesh))
        return (tokens,)

    def loss_fn(out, batch):
        labels = seq_block(batch["labels"], mesh)
        weights = (labels >= 0).float()
        per_tok = _per_token_xent(out, labels.clamp_min(0), head_chunk)
        count = weights.sum()
        for axis in axes:
            count = psum(count, mesh, axis)
        loss = (per_tok * weights).sum() / (count.clamp_min(1.0) / ranks)
        return loss, {"loss": loss, "masked_fraction": weights.mean()}

    return Task(input_fn=input_fn, loss_fn=loss_fn,
                keys=("loss", "masked_fraction"))


_TASK_KNOBS = {"head_chunk", "label_smoothing"}  # every task's, reference


def get_task(name: str, mesh=None, **task_kwargs) -> Task:
    """``task_kwargs``: per-task knobs; a knob no task of the reference
    declares is a TypeError, a knob another task declares is dropped.
    ``mesh``: the ranks a batch is split over."""
    unknown = set(task_kwargs) - _TASK_KNOBS
    if unknown:
        raise TypeError(f"unknown task knob(s) {sorted(unknown)}")
    if name == "classification":
        return classification_task(task_kwargs.get("label_smoothing", 0.0))
    chunk = {k: v for k, v in task_kwargs.items() if k == "head_chunk"}
    if name == "mlm":
        return mlm_task(mesh=mesh, **chunk)
    if name != "lm":
        raise KeyError(f"unknown task {name!r}")
    return lm_task(mesh=mesh, **chunk)


# ---------------------------------------------------------------------------
# Schedules: optax's formulas, evaluated on the host in fp32 at an int count.
# ---------------------------------------------------------------------------

_F = np.float32


def constant_schedule(value: float):
    return lambda count: _F(value)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax ``linear_schedule`` (a polynomial schedule of power 1)."""
    if transition_steps <= 0:
        return lambda count: _F(init_value)

    def schedule(count):
        c = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return _F(init_value - end_value) * frac + _F(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count):
        c = _F(min(count, decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * c / _F(decay_steps)))
        return _F(init_value) * ((_F(1) - _F(alpha)) * cosine + _F(alpha))

    return schedule


def join_schedules(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha)],
        [warmup_steps],
    )


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def clip_to(grads: dict, norm, clip: float) -> dict:
    """optax ``clip_by_global_norm`` at a global ``norm``: g unchanged below
    the threshold, else (g / norm) * clip."""
    return {k: torch.where(norm < clip, g, (g / norm) * clip)
            for k, g in grads.items()}


class AdamW(FusedAdamW):
    """``optax.chain(clip_by_global_norm(clip), optax.adamw(sched, b1, b2,
    weight_decay=wd, mask=decay_leaf))`` in plain torch, updating the
    params and moments in place: the reference path of ``optim.name=
    'adamw'``, which runs no kernel. Its state has the fused optimizer's
    (count, mu, nu) layout, as optax's ``ScaleByAdamState`` does. Each
    moment is advanced in fp32 and stored through :meth:`_store` (as it is
    here; :class:`LowPrecisionAdamW` narrows it)."""

    def _store(self, x32, bits):
        """A moment advanced in fp32 -> its stored value (``bits``: the
        random bits of a stochastic rounding, or None)."""
        return x32

    def _leaf_bits(self, count: int, i: int, name: str, p) -> tuple:
        """(mu bits, nu bits) of the i-th leaf ``p`` (``name``) at the
        incremented ``count``: none here."""
        return None, None

    def _shard_bits(self, count: int, layout, group: str, device) -> tuple:
        """(mu bits, nu bits) of this ZeRO-1 rank's shard of ``group``:
        none here."""
        return None, None

    def _step(self, count: int, leaves) -> None:
        """The update at the pre-increment ``count`` over ``leaves``, (p,
        g, mu, nu, decayed, (mu bits, nu bits)) each."""
        lr = f32(self.learning_rate(count)
                 if callable(self.learning_rate) else self.learning_rate)
        bc1 = float(_F(1) - np.power(_F(self.b1), _F(count + 1)))
        bc2 = float(_F(1) - np.power(_F(self.b2), _F(count + 1)))
        b1, b2 = f32(self.b1), f32(self.b2)
        omb1, omb2 = f32(1 - self.b1), f32(1 - self.b2)
        eps, wd = f32(self.eps), f32(self.weight_decay)
        for p, g, mu, nu, decayed, (mu_bits, nu_bits) in leaves:
            g = g.float()
            mu32 = mu.float() * b1 + g * omb1
            nu32 = nu.float() * b2 + (g * g) * omb2
            u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
            if wd and decayed:
                u = u + p * wd
            p.add_(u * -lr)
            mu.copy_(self._store(mu32, mu_bits))
            nu.copy_(self._store(nu32, nu_bits))

    @torch.no_grad()
    def update(self, grads: dict, state, params: dict, norm=None):
        """``norm``: the global gradient norm when ``grads`` are not the
        whole model's (a pipeline stage's); else computed from them."""
        if self.grad_clip:
            grads = clip_to(grads, global_norm(grads) if norm is None
                            else norm, self.grad_clip)
        count = state.count + 1
        self._step(state.count, (
            (p, grads[k], state.mu[k], state.nu[k], decay_leaf(p),
             self._leaf_bits(count, i, k, p))
            for i, (k, p) in enumerate(params.items())))
        return state._replace(count=count)

    @torch.no_grad()
    def update_shard(self, grads: dict, state, params: dict, norm):
        """:meth:`FusedAdamW.update_shard`'s contract, in plain torch: each
        group's weight decay is the group's."""
        if self.grad_clip:
            grads = clip_to(grads, norm, self.grad_clip)
        count = state.count + 1
        self._step(state.count, (
            (p, grads[g], state.mu[g], state.nu[g], g == "decay",
             self._shard_bits(count, state.layout, g, p.device))
            for g, p in params.items()))
        return state._replace(count=count)


class LowPrecisionAdamWState(NamedTuple):
    """AdamW state with the moments stored in a low-precision dtype (the
    ``bf16_full`` policy): the (count, mu, nu) layout of ``FusedAdamWState``,
    so ZeRO-1 and the checkpoints treat it alike, but its own type."""

    count: int  # completed updates
    mu: dict  # name -> first moment in moment_dtype, params-shaped
    nu: dict  # name -> second moment in moment_dtype


ROUNDING_SEED = 0x5F3759  # the reference's key for the rounding stream


def rounding_bits(count: int, leaf: int, numel: int, device) -> torch.Tensor:
    """The default random bits of :class:`LowPrecisionAdamW`: ``numel``
    uniform 16-bit integers (int32) for the moment tree ``leaf`` at the
    incremented ``count``, from a ``torch.Generator`` on ``device`` seeded
    from ``(ROUNDING_SEED, count, leaf)``. The stream is a function of its
    key alone, so a resume replays it, as the reference's ``fold_in`` key
    chain does (whose bits torch cannot reproduce)."""
    seed = np.random.SeedSequence([ROUNDING_SEED, int(count), int(leaf)])
    gen = torch.Generator(device=device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))
    return torch.randint(0, 1 << 16, (numel,), generator=gen, device=device,
                         dtype=torch.int32)


class LowPrecisionAdamW(AdamW):
    """The reference's ``low_precision_adamw``: AdamW whose moments LIVE in
    ``moment_dtype`` (bf16 under ``bf16_full``: half the bytes of fp32
    moments) while every update is COMPUTED in fp32 (:class:`AdamW`'s
    math): only the moments' store narrows, with
    :func:`ops.fused_adamw.stochastic_round` (round-to-nearest on ``mu <-
    b1*mu + (1-b1)*g`` would drop every ``g`` below one bf16 ulp of ``mu``,
    and the moment would stall).

    ``bits(count, leaf, numel, device)`` supplies the rounding's random
    bits for moment tree ``leaf`` = ``2 * i`` (mu) or ``2 * i + 1`` (nu) of
    the i-th leaf in the params' order, at the incremented ``count``;
    default :func:`rounding_bits`. Under ZeRO-1 a rank takes the slice of
    each leaf's bits that its shard holds, so the update equals the
    unsharded one element for element. On a model cut over tp, fsdp or ep
    (``shards``, the model's ``sharding.ShardLayout``, which the Trainer
    sets) a rank draws each leaf's bits at the leaf's whole shape and takes
    its block, in the whole leaf's element order, so every mesh rounds
    every element as one process does."""

    shards = None

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 grad_clip: float = 0.0, moment_dtype=torch.bfloat16,
                 stochastic_rounding: bool = True, bits=rounding_bits):
        super().__init__(learning_rate, b1, b2, eps, weight_decay,
                         grad_clip=grad_clip)
        self.moment_dtype = moment_dtype
        self.stochastic_rounding, self.bits = stochastic_rounding, bits

    def init(self, params: dict) -> LowPrecisionAdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=self.moment_dtype,
                                   device=p.device)
                    for k, p in params.items()}

        return LowPrecisionAdamWState(count=0, mu=zeros(), nu=zeros())

    def init_shard(self, layout):
        """One ZeRO-1 rank's state: its shard of each group's moments."""
        from .parallel.zero import ZeroState

        def zeros():
            return {g: f.new_zeros(layout.shard_size[g],
                                   dtype=self.moment_dtype)
                    for g, f in layout.flats.items()}

        return ZeroState(count=0, mu=zeros(), nu=zeros(), layout=layout)

    def _store(self, x32, bits):
        if not self.stochastic_rounding:
            return x32.to(self.moment_dtype)
        return stochastic_round(x32, bits, self.moment_dtype)

    def _block_bits(self, count: int, tree: int, name: str, shape, shards,
                    device) -> torch.Tensor:
        """Moment tree ``tree``'s bits for leaf ``name``, in the shape
        ``shape`` this rank holds: the whole leaf's drawn, and this rank's
        block of them kept where ``shards`` cuts the leaf (zeros on its
        padding)."""
        if shards is None or name not in shards.dims:
            return self.bits(count, tree, math.prod(shape), device).view(
                shape)
        whole = shards.whole_shape(name)
        bits = self.bits(count, tree, math.prod(whole), device)
        return shards.take_leaf(name, bits.view(whole))

    def _leaf_bits(self, count: int, i: int, name: str, p) -> tuple:
        if not self.stochastic_rounding:
            return None, None
        return tuple(self._block_bits(count, 2 * i + m, name, p.shape,
                                      self.shards, p.device)
                     for m in (0, 1))

    def _shard_bits(self, count: int, layout, group: str, device) -> tuple:
        """The slice of each leaf's bits (its block's, on a model cut over
        tp, fsdp or ep) that this rank's shard of ``group`` holds, zeros
        on the padding."""
        if not self.stochastic_rounding:
            return None, None
        order = {k: i for i, k in enumerate(layout.shapes)}
        lo = layout.shard_slice(group).start
        hi = lo + layout.shard_size[group]
        out = []
        for m in (0, 1):
            bits = torch.zeros(hi - lo, dtype=torch.int32, device=device)
            for k in layout.names[group]:
                o, n = layout.offsets[k], layout.shapes[k].numel()
                a, b = max(o, lo), min(o + n, hi)
                if a < b:
                    bits[a - lo:b - lo] = self._block_bits(
                        count, 2 * order[k] + m, k, layout.shapes[k],
                        layout.shards, device).reshape(-1)[a - o:b - o]
            out.append(bits)
        return tuple(out)


class SGDState(NamedTuple):
    count: int  # completed updates
    trace: dict  # name -> fp32 momentum trace, params-shaped


class SGD:
    """``optax.chain(clip_by_global_norm(clip), add_decayed_weights(wd,
    mask=decay_leaf), optax.sgd(sched, momentum, nesterov=False))`` in plain
    torch, in place on the params and the trace: ``g`` clipped on the
    global norm, ``+ wd * p`` on the decayed leaves (ndim >= 2), ``t = g +
    momentum * t``, ``p += -lr(count) * t``. The state is (count, trace),
    as optax's schedule count and ``TraceState``."""

    def __init__(self, learning_rate, momentum: float = 0.9,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        self.learning_rate, self.momentum = learning_rate, momentum
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> SGDState:
        return SGDState(count=0, trace={
            k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()})

    def init_shard(self, layout):
        """One ZeRO-1 rank's state (``parallel.zero.ZeroSGDState``): its
        shard of each group's momentum trace, zeros."""
        from .parallel.zero import ZeroSGDState

        return ZeroSGDState(count=0, trace={
            g: f.new_zeros(layout.shard_size[g])
            for g, f in layout.flats.items()}, layout=layout)

    def _step(self, count: int, leaves) -> None:
        """The update at the pre-increment ``count`` over ``leaves``, (p,
        g, trace, decayed) each."""
        lr = f32(self.learning_rate(count)
                 if callable(self.learning_rate) else self.learning_rate)
        wd, mom = f32(self.weight_decay), f32(self.momentum)
        for p, g, t, decayed in leaves:
            g = g.float()
            if wd and decayed:
                g = g + p * wd
            t.copy_(g + t * mom)
            p.add_(t * -lr)

    @torch.no_grad()
    def update(self, grads: dict, state: SGDState, params: dict,
               norm=None) -> SGDState:
        if self.grad_clip:
            grads = clip_to(grads, global_norm(grads) if norm is None
                            else norm, self.grad_clip)
        self._step(state.count, ((p, grads[k], state.trace[k], decay_leaf(p))
                                 for k, p in params.items()))
        return SGDState(count=state.count + 1, trace=state.trace)

    @torch.no_grad()
    def update_shard(self, grads: dict, state, params: dict, norm):
        """One ZeRO-1 rank's update (``FusedAdamW.update_shard``'s
        contract): ``grads`` and ``params`` map each group to this rank's
        flat shard, ``norm`` is the global gradient norm, each group's
        weight decay the group's."""
        if self.grad_clip:
            grads = clip_to(grads, norm, self.grad_clip)
        self._step(state.count, ((p, grads[g], state.trace[g], g == "decay")
                                 for g, p in params.items()))
        return state._replace(count=state.count + 1)


def opt_state_trees(opt_state) -> dict:
    """The params-shaped trees of an optimizer state, by name: Adam's
    ``mu`` and ``nu`` (a ZeRO-1 rank's shards of them), or SGD's
    ``trace``."""
    if hasattr(opt_state, "trace"):
        return {"trace": opt_state.trace}
    return {"mu": opt_state.mu, "nu": opt_state.nu}


def opt_state_bytes(opt_state) -> int:
    """The bytes of :func:`opt_state_trees` on this rank."""
    return sum(t.numel() * t.element_size()
               for tree in opt_state_trees(opt_state).values()
               for t in tree.values())


def make_optimizer(name: str = "sgd", lr: float = 0.1, *,
                   momentum: float = 0.9, b1: float = 0.9,
                   b2: float = 0.999, weight_decay: float = 0.0,
                   warmup_steps: int = 0, schedule: str = "constant",
                   total_steps: int = 0, grad_clip: float = 0.0,
                   precision: str | Policy = "fp32"):
    """The reference's optimizer factory. ``sgd`` is SGD with a momentum
    trace (optax semantics, decay mask, outer clip); ``adamw`` the plain
    AdamW (the same), or :class:`LowPrecisionAdamW` when the policy stores
    the moments in a narrower dtype than the masters (``bf16_full``);
    ``adamw_fused`` the fused kernel with the clip inside its update."""
    if schedule == "constant":
        sched = constant_schedule(lr)
    elif schedule == "cosine":
        sched = warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    elif schedule == "linear":
        sched = join_schedules(
            [linear_schedule(0.0, lr, max(warmup_steps, 1)),
             linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))],
            [warmup_steps],
        )
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    policy = check_precision_composition(precision, optim_name=name)
    if name == "sgd":
        return SGD(sched, momentum=momentum, weight_decay=weight_decay,
                   grad_clip=grad_clip)
    if name == "adamw" and policy.moment_dtype != policy.param_dtype:
        return LowPrecisionAdamW(
            sched, b1=b1, b2=b2, weight_decay=weight_decay,
            grad_clip=grad_clip, moment_dtype=policy.moment_dtype,
            stochastic_rounding=policy.stochastic_rounding)
    if name == "adamw":
        return AdamW(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                     grad_clip=grad_clip)
    if name == "adamw_fused":
        return FusedAdamW(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                          grad_clip=grad_clip)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def fold_in_step(seed: int, step: int) -> int:
    """The per-step dropout seed from the root seed and the step: the
    counterpart of the reference's ``fold_in_step`` (JAX's and torch's
    generators differ, so the bits do too; the derivation is as
    deterministic). Folding the microbatch index into a step's seed the
    same way stands for the reference's ``fold_in(rng, idx)``."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class TrainState:
    """The training state: ``params`` are the model's own fp32 master
    parameters (updated in place), ``rng`` the root dropout seed,
    ``model_state`` the model's own buffers that are no parameters
    (BatchNorm's running statistics; updated in place by the training
    forward, as JAX's ``model_state``), ``health`` the guard's counters."""

    step: int
    params: dict
    opt_state: Any
    rng: int
    model_state: dict = dataclasses.field(default_factory=dict)
    # The health guard's counters (``health.HealthState``); None while the
    # guard is off, so the state's schema (and its checkpoints) is unchanged.
    health: Any = None
    # A pipelined model's stage rows (``parallel.pp.StageRows``): which
    # params leaves are stage-stacked and the rows this rank holds, for the
    # checkpoints' whole layout; None for any other model.
    stage_rows: Any = None
    # A model cut over tp or fsdp: its ``sharding.ShardLayout`` (each
    # leaf's whole shape and this rank's block), for the checkpoints' whole
    # layout; None for any other model.
    shards: Any = None
    # The compressed sync's error-feedback residual: this rank's own
    # compression error, per parameter (name -> fp32 tensor) or per bucket
    # (a tuple of flat fp32 buffers); None under fp32, so the state's
    # schema (and its checkpoints) is unchanged.
    grad_residual: Any = None
    # The explicit dp sync's placement (``comms_overlap.DpSync``: the dp
    # group, the buckets, the sharded update's flat shards); None
    # otherwise.
    dp_sync: Any = None


def check_explicit_sync(*, grad_comm: str = "fp32",
                        grad_bucket_mb: float = 0.0,
                        update_sharding: str = "replicated", dcn_dp: int = 1,
                        comm_hierarchy: str = "auto", pipelined: bool = False,
                        mesh_shape: dict | None = None,
                        grad_accum: int = 1, model_name: str = "model"):
    """The reference Trainer's fences of the explicit data-parallel sync,
    with its exception types and messages, in its order: the lossy wire
    modes, then the bucketed/sharded/hierarchical paths, are pure dp (no
    fsdp/tp/pp/cp/ep axis above 1), refuse a pipelined model and
    ``grad_accum > 1``. ``mesh_shape``: the axis sizes (None: the dp size
    is not known yet, and the hierarchy's dp checks wait). Returns the
    active ``comms_hier.HierTopology``, or None."""
    from .comms_hier import (
        HierTopology,
        check_comm_hierarchy_config,
        resolve_hierarchy,
    )
    from .comms_overlap import UPDATE_SHARDING_MODES
    from .comms_quant import GRAD_COMM_MODES

    shape = mesh_shape or {}
    busy = {a: shape[a] for a in ("fsdp", "tp", "pp", "cp", "ep")
            if shape.get(a, 1) > 1}
    if grad_comm not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm={grad_comm!r} not in {GRAD_COMM_MODES}")
    if grad_comm != "fp32":
        if pipelined:
            raise NotImplementedError(
                f"grad_comm={grad_comm!r} x pipelined model {model_name} is "
                "unsupported in v1: the pipeline engine computes grads "
                "inside its schedule — use grad_comm='fp32'"
            )
        if busy:
            raise NotImplementedError(
                f"grad_comm={grad_comm!r} is pure-DP in v1 but the mesh "
                f"has {busy}: quantized sync composes with dp/zero1 only"
            )
        if grad_accum > 1:
            raise NotImplementedError(
                f"grad_comm={grad_comm!r} x grad_accum={grad_accum} is "
                "unsupported in v1: accumulate-then-compress needs the "
                "residual threaded through the microbatch scan"
            )
    if update_sharding not in UPDATE_SHARDING_MODES:
        raise ValueError(f"update_sharding={update_sharding!r} not in "
                         f"{UPDATE_SHARDING_MODES}")
    if grad_bucket_mb < 0:
        raise ValueError(f"grad_bucket_mb={grad_bucket_mb} must be >= 0")
    dp = shape.get("dp")
    check_comm_hierarchy_config(comm_hierarchy=comm_hierarchy, dcn_dp=dcn_dp,
                                dp=dp)
    hier = resolve_hierarchy(comm_hierarchy, dcn_dp)
    if grad_bucket_mb > 0 or update_sharding == "sharded" or hier:
        knobs = (f"grad_bucket_mb={grad_bucket_mb}" if grad_bucket_mb > 0
                 else f"update_sharding={update_sharding!r}"
                 if update_sharding == "sharded"
                 else f"comm_hierarchy={comm_hierarchy!r} (dcn_dp={dcn_dp})")
        if pipelined:
            raise NotImplementedError(
                f"{knobs} x pipelined model {model_name} is unsupported in "
                "v1: the pipeline engine computes grads inside its schedule "
                "— use grad_bucket_mb=0 and update_sharding='replicated'"
            )
        if busy:
            raise NotImplementedError(
                f"{knobs} is pure-DP in v1 but the mesh has {busy}: "
                "bucketed/sharded sync composes with dp/zero1 only"
            )
        if grad_accum > 1:
            raise NotImplementedError(
                f"{knobs} x grad_accum={grad_accum} is unsupported in v1: "
                "per-bucket collectives (and EF residuals) would need "
                "threading through the microbatch scan"
            )
    if hier and dp is not None:
        return HierTopology(n=dp, dcn=dcn_dp)
    return None


# The attention cores that split the sequence over mesh.cp (the
# reference's ``cp_attn``).
CP_ATTN = ("ring", "ring_pallas", "ulysses", "ulysses_flash")


class Trainer:
    """Trainer of one rank over a model, an optimizer (``AdamW``,
    ``FusedAdamW`` or ``SGD``) and a task. ``mesh`` (``mesh.Mesh``,
    default one rank): the ranks the step's gradients and metrics are
    averaged over; the model and the task must have been built on the same
    mesh.

    ``zero1``: over ``mesh.dp > 1``, ZeRO-1 (``parallel.zero``): the
    model's masters become views into flat group buffers, each rank keeps
    its shard of the moments only, and the step's gradient sync is a
    reduce-scatter, a shard update and an all-gather. Over dp = 1 it is a
    no-op, as the reference's placement is. ``grad_accum``: each step
    splits this rank's rows into that many equal microbatches and
    averages their fp32 gradients and metrics.

    ``health``: a ``config.HealthConfig`` with ``enabled=True`` guards every
    step (``health.guard_step``); anything else leaves the step unguarded.
    ``fault_nan_step``: the step whose pre-step counter equals it has its
    gradients poisoned to NaN (``train.fault_injection=nan:K``), before the
    guard's norm, so the guard sees what the optimizer would consume.

    The explicit data-parallel sync (``comms_quant``, ``comms_overlap``,
    ``comms_hier``; pure dp, ``grad_accum`` 1): ``grad_comm`` 'bf16' or
    'int8' syncs the gradients on the compressed ring with error feedback
    (``grad_comm_block`` elements a scale); ``grad_bucket_mb`` > 0 syncs
    them in buckets of about that many MiB; ``update_sharding='sharded'``
    reduce-scatters them, updates each rank's flat shard and all-gathers
    the params; ``dcn_dp`` slices of the dp axis with ``comm_hierarchy``
    'auto' or 'hierarchical' sync each bucket within, then across, the
    slices. Each rank's loss and gradient are then those of its own rows
    (its own dropout, BatchNorm statistics of its rows, averaged over dp
    after the step), as in the reference's ``shard_map`` steps."""

    def __init__(self, model, tx, task: Task, *, device,
                 precision: str | Policy = "fp32", mesh=None,
                 zero1: bool = False, grad_accum: int = 1, health=None,
                 fault_nan_step: int | None = None, grad_comm: str = "fp32",
                 grad_comm_block: int = 256, grad_bucket_mb: float = 0.0,
                 update_sharding: str = "replicated", dcn_dp: int = 1,
                 comm_hierarchy: str = "auto"):
        self.model, self.tx, self.task = model, tx, task
        self.mesh = mesh
        from .mesh import single_device_mesh

        # The explicit sync's dp group (one rank when there is no mesh).
        self._dp_mesh = mesh or single_device_mesh()
        shape = self._dp_mesh.shape
        self._hier_topo = check_explicit_sync(
            grad_comm=grad_comm, grad_bucket_mb=grad_bucket_mb,
            update_sharding=update_sharding, dcn_dp=dcn_dp,
            comm_hierarchy=comm_hierarchy,
            pipelined=hasattr(model, "num_stages"), mesh_shape=shape,
            grad_accum=grad_accum, model_name=type(model).__name__)
        self.grad_comm, self.grad_comm_block = grad_comm, grad_comm_block
        self.grad_bucket_mb = float(grad_bucket_mb)
        self.update_sharding = update_sharding
        self.dcn_dp, self.comm_hierarchy = dcn_dp, comm_hierarchy
        self._overlap = (self.grad_bucket_mb > 0
                         or update_sharding == "sharded"
                         or self._hier_topo is not None)
        self.explicit = grad_comm != "fp32" or self._overlap
        if (update_sharding == "sharded" and isinstance(tx, FusedAdamW)
                and not isinstance(tx, AdamW)):
            raise NotImplementedError(
                "update_sharding='sharded' x adamw_fused is unsupported "
                "in v1: the fused kernel has its own per-leaf shard_map "
                "dispatch (_tx_update) — use optimizer 'adamw' or "
                "update_sharding='replicated'"
            )
        self.bucket_layout = self._posted = None
        if self._overlap:
            from .comms_overlap import PostedBuckets, build_bucket_layout

            self.bucket_layout = build_bucket_layout(
                dict(model.named_parameters()), self.grad_bucket_mb,
                n_members=shape["dp"], block_size=grad_comm_block)
            if (grad_comm == "fp32" and update_sharding == "replicated"
                    and self._hier_topo is None):
                # fp32 buckets are posted from the backward; the lossy
                # rings, the hierarchy's three phases and the sharded
                # update's reduce-scatter run after it (ROADMAP A15).
                self._posted = PostedBuckets(self.bucket_layout,
                                             self._dp_mesh)
        self.health = health if (health is not None
                                 and health.enabled) else None
        self.fault_nan_step = fault_nan_step
        cp = 1 if mesh is None else mesh.shape["cp"]
        pp_size = 1 if mesh is None else mesh.shape["pp"]
        attn = getattr(model, "attn_impl", None)
        if hasattr(model, "num_stages"):
            # The reference's fences on a pipelined model.
            dead = {a: mesh.shape[a] for a in ("ep", "cp")
                    if mesh is not None and mesh.shape[a] > 1}
            if dead:
                raise NotImplementedError(
                    f"pipeline x {'/'.join(dead)} is unsupported in v1 "
                    f"(mesh has {dead}): pipelined stacks compose with "
                    "dp/fsdp/tp/zero1 only"
                )
            if get_policy(precision).mixed:
                raise NotImplementedError(
                    f"precision={get_policy(precision).name!r} x pipelined "
                    f"model {type(model).__name__} is unsupported in v1: the "
                    "1f1b engine differentiates inside its schedule on the "
                    "model's own dtype, so there is no seam for the "
                    "master->compute cast — use precision='fp32'"
                )
        elif pp_size > 1:
            raise ValueError(
                f"mesh pp={pp_size} but model {type(model).__name__} is not "
                "pipelined: the pp axis would silently replicate — use "
                "gpt2_pp/llama_pp or drop the axis"
            )
        # The pipeline engines run the step (model.pipeline_value_and_grad)
        # when the model pipelines over pp, and under the interleaved
        # schedule on any pp, as the reference's Trainer dispatches.
        self.engine = hasattr(model, "pipeline_value_and_grad") and (
            model.pipelined or (model.pipeline
                                and model.schedule == "1f1b_interleaved"))
        if hasattr(model, "num_experts"):
            from .parallel.ep import check_moe_shapes

            check_moe_shapes(model.num_experts,
                             1 if mesh is None else mesh.shape["ep"])
        elif mesh is not None and mesh.shape["ep"] > 1:
            raise ValueError(
                f"mesh ep={mesh.shape['ep']} but model "
                f"{type(model).__name__} has no experts: the ep axis would "
                "silently replicate — use an MoE model (gpt2_moe/llama_moe) "
                "or drop the axis"
            )
        # A model cut over tp, fsdp or ep (``sharding.ShardLayout``); the
        # low-precision optimizer draws its rounding bits over its blocks.
        self.shards = getattr(model, "shards", None)
        if isinstance(tx, LowPrecisionAdamW):
            tx.shards = self.shards
        # Gradients and metrics average over the ranks that split the
        # batch: every rank, or under pp (whose ranks hold the same rows)
        # the dp ranks; under tp, fsdp and ep the dp ranks after the fsdp
        # and cp ranks' share (``parallel.fsdp.reduce_grads``,
        # :meth:`_batch_mean`): tp and ep ranks hold the same rows.
        self.sync_axis = ("dp" if pp_size > 1 or self.shards is not None
                          else "world")
        # The whole model's gradient norm when a rank holds one stage.
        self.stage_rows = (model.stage_rows
                           if getattr(model, "pipelined", False) else None)
        if cp > 1 and attn not in CP_ATTN:
            raise ValueError(
                f"mesh cp={cp} but model {type(model).__name__} attention "
                f"(attn_impl={attn!r}) is not context-parallel: the cp axis "
                f"would silently replicate — use attn_impl in {CP_ATTN} or "
                "drop the axis"
            )
        if (mesh is not None and mesh.size > 1
                and getattr(model, "mesh", None) is not mesh):
            raise ValueError("the model was built on another mesh than the "
                             "trainer's")
        if grad_accum < 1:
            raise ValueError(f"grad_accum={grad_accum} must be >= 1")
        self.grad_accum = grad_accum
        self.device = torch.device(device)
        self.precision = get_policy(precision)
        if self.precision.mixed and model.dtype != self.precision.compute_dtype:
            raise ValueError(
                f"precision={self.precision.name!r} requires model dtype "
                f"{self.precision.compute_dtype} (got {model.dtype}): the "
                "step casts a compute copy of the fp32 masters, and a model "
                "at another dtype would cast it straight back at every use"
            )
        self._generator = torch.Generator(device=self.device)
        self.layout = None
        if (zero1 and mesh is not None and mesh.shape["dp"] > 1
                and self.update_sharding != "sharded"):
            # (The sharded update holds each rank's 1/dp of the state
            # already.)
            from .parallel.zero import ZeroLayout

            self.layout = ZeroLayout(dict(model.named_parameters()), mesh,
                                     stage_rows=self.stage_rows,
                                     shards=self.shards)
            self.layout.bind(dict(model.named_parameters()))

    def _batch_mean(self, tensors: list, *, fsdp: bool = True) -> list:
        """The mean over the ranks that split the batch: under a sharded
        model the fsdp ranks' (unless ``fsdp`` is False: done already)
        and the cp ranks' first, then :attr:`sync_axis`'s."""
        if self.mesh is None or self.mesh.size == 1:
            return list(tensors)
        if self.shards is not None:
            if fsdp:
                tensors = pmean_tensors(tensors, self.mesh, "fsdp")
            tensors = pmean_tensors(tensors, self.mesh, "cp")
        return pmean_tensors(tensors, self.mesh, self.sync_axis)

    def init(self, seed: int) -> TrainState:
        """Draw the weights from ``seed`` and make the optimizer state (the
        sharded update's in the flat-shard layout, never whole) and the
        error-feedback residual (zeros) of a compressed sync."""
        self.model.init_weights(torch.Generator().manual_seed(int(seed)))
        params = dict(self.model.named_parameters())
        dp_sync = residual = None
        if self.explicit:
            from .comms_overlap import DpSync

            n, topo = self._dp_mesh.shape["dp"], self._hier_topo
            dp_sync = DpSync(self._dp_mesh, self.bucket_layout, tuple(
                topo.chunk_index(i) if topo else i for i in range(n))
                if self.update_sharding == "sharded" else None)
        if dp_sync is not None and dp_sync.sharded:
            opt_state = self.tx.init(dp_sync.local(params))
        elif self.layout is None:
            opt_state = self.tx.init(params)
        else:
            opt_state = self.tx.init_shard(self.layout)
        if self.grad_comm != "fp32":
            from .comms_overlap import zeros_bucket_residuals
            from .comms_quant import zeros_residual

            residual = (zeros_bucket_residuals(self.bucket_layout,
                                               self.device)
                        if self._overlap else zeros_residual(params))
        health = None
        if self.health is not None:
            from .health import init_health_state

            health = init_health_state()
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=int(seed),
                          model_state=dict(self.model.named_buffers()),
                          health=health,
                          stage_rows=getattr(self.model, "stage_rows", None),
                          shards=self.shards, grad_residual=residual,
                          dp_sync=dp_sync)

    def _forward(self, state: TrainState, params: dict, batch: dict,
                 train: bool):
        """The model's output on ``batch`` from ``params``: the masters
        themselves (the model's own parameters) or a compute copy. The
        model's buffers (``state.model_state``) are its own either way, so
        a training forward updates them in place."""
        inputs = self.task.input_fn(batch)
        kw = {"train": train,
              "generator": self._generator if train else None}
        if params is state.params:
            return self.model(*inputs, **kw)
        return torch.func.functional_call(self.model, params, inputs, kw)

    def _grads(self, state: TrainState, batch: dict, posted=None):
        """(fp32 gradients, metrics) of this rank's loss on ``batch``. What
        the training forward sows (``models/sow.py``) joins the step as the
        reference's ``losses`` and ``metrics`` collections do: the objective
        is the task's loss plus every sown loss, ``metrics["loss"]`` stays
        the task's, ``metrics["aux_loss"]`` is the sum of the sown losses,
        and each sown metric is its mean over the modules that sowed it.
        ``posted`` (``comms_overlap.PostedBuckets``) hooks the tensors
        differentiated, so the sync's buckets are posted from the
        backward."""
        from .models.sow import collecting

        if self.engine:
            _, grads, metrics = self.model.pipeline_value_and_grad(
                batch, self.task)
            return grads, {k: v.detach() for k, v in metrics.items()}
        # Mixed precision: ONE compute copy per call, differentiated
        # directly; fp32 returns the masters themselves.
        cparams = cast_to_compute(self.precision, state.params)
        with collecting() as sown:
            out = self._forward(state, cparams, batch, train=True)
        loss, metrics = self.task.loss_fn(out, batch)
        if sown.losses:
            aux = sum(v for _, v in sown.losses)
            loss = loss + aux
            metrics = {**metrics, "aux_loss": aux}
        metrics = {**metrics, **{
            name: torch.stack([v.float() for v in vals]).mean()
            for name, vals in sown.metrics.items()}}
        names = list(cparams)
        handles = [] if posted is None else posted.attach(cparams)
        try:
            grads = torch.autograd.grad(loss, [cparams[k] for k in names],
                                        allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        grads = {k: torch.zeros_like(cparams[k]) if g is None else g
                 for k, g in zip(names, grads)}
        grads = cast_grads_to_update(self.precision, grads)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def _accumulated_grads(self, state: TrainState, batch: dict):
        """The mean of the microbatches' fp32 gradients and metrics."""
        n, a = next(iter(batch.values())).shape[0], self.grad_accum
        if n % a:
            raise ValueError(f"grad_accum={a} must divide this rank's batch "
                             f"of {n} rows")
        step_seed = fold_in_step(state.rng, state.step)
        grads = metrics = None
        for i in range(a):
            micro = {k: v[i * (n // a):(i + 1) * (n // a)]
                     for k, v in batch.items()}
            self._generator.manual_seed(fold_in_step(step_seed, i))
            g, m = self._grads(state, micro)
            if grads is None:
                grads = {k: v.float() for k, v in g.items()}
                metrics = {k: v.float() for k, v in m.items()}
                continue
            for k, v in g.items():
                grads[k].add_(v.float())
            for k, v in m.items():
                metrics[k] = metrics[k] + v.float()
        return ({k: v / a for k, v in grads.items()},
                {k: v / a for k, v in metrics.items()})

    def _instrument_grads(self, grads: dict, step: int, metrics: dict,
                          norm=None):
        """The post-gradient hook of every step (whole or ZeRO-1 shards):
        the NaN fault injection first, then the guard's ``grad_norm``
        (``norm`` computes a sharded one), so the guard detects what the
        optimizer would consume."""
        if self.fault_nan_step is not None and step == self.fault_nan_step:
            grads = {k: torch.full_like(g, float("nan"))
                     for k, g in grads.items()}
        if self.health is not None:
            metrics = {**metrics, "grad_norm": (
                global_norm(grads) if norm is None else norm(grads))}
        return grads, metrics

    def _norm(self, grads: dict):
        """The whole model's gradient norm from this rank's whole leaves:
        over every pp stage, the shared leaves once; over every tp, fsdp
        and ep block, the replicated leaves once."""
        if self.shards is not None:
            from .parallel import fsdp

            return fsdp.global_norm(grads, self.shards)
        if self.stage_rows is None:
            return global_norm(grads)
        from .parallel.pp import whole_norm

        return whole_norm(grads, self.stage_rows)

    def _local_grads(self, state: TrainState, batch: dict, posted=None):
        """The explicit sync's front half: this rank's fp32 gradients of
        its own rows with its own dropout (the step's seed folded with its
        dp index) and BatchNorm statistics of its rows; the metrics and the
        float buffers (running statistics) averaged over dp."""
        from .models.resnet import local_batch_statistics

        dp_index = self._dp_mesh.coords["dp"]
        self._generator.manual_seed(fold_in_step(
            fold_in_step(state.rng, state.step), dp_index))
        with local_batch_statistics():
            grads, metrics = self._grads(state, batch, posted)
        keys = list(metrics)
        metrics = dict(zip(keys, pmean_tensors(
            [metrics[k] for k in keys], self._dp_mesh, "dp")))
        bufs = [b for b in state.model_state.values()
                if b.is_floating_point()]
        with torch.no_grad():
            for b, m in zip(bufs, pmean_tensors(bufs, self._dp_mesh, "dp")):
                b.copy_(m)
        return grads, metrics

    def _sync_fns(self):
        """(all-reduce, reduce-scatter, param gather) of the buckets: the
        flat collectives, or the hierarchical ones."""
        from . import comms_hier, comms_overlap

        kw = dict(mode=self.grad_comm, block_size=self.grad_comm_block)
        layout, mesh, topo = self.bucket_layout, self._dp_mesh, self._hier_topo
        if topo is not None:
            return (lambda g, r: comms_hier.bucketed_hier_all_reduce(
                        g, layout, mesh, topo, residuals=r, **kw),
                    lambda g, r: comms_hier.bucketed_hier_reduce_scatter(
                        g, layout, mesh, topo, residuals=r, **kw),
                    lambda s: comms_hier.hier_all_gather_buckets(
                        s, layout, mesh, topo))
        return (lambda g, r: comms_overlap.bucketed_all_reduce(
                    g, layout, mesh, residuals=r, **kw),
                lambda g, r: comms_overlap.bucketed_reduce_scatter(
                    g, layout, mesh, residuals=r, **kw),
                lambda s: comms_overlap.all_gather_buckets(s, layout, mesh))

    def _explicit_step(self, state: TrainState, batch: dict):
        """:meth:`_staged_step` under the explicit sync (the reference's
        ``_quantized_dp_step_fn`` and ``_overlapped_dp_step_fn``)."""
        from .comms import axis_size

        posted = self._posted
        grads, metrics = self._local_grads(state, batch, posted)
        n = axis_size(self._dp_mesh, "dp")
        all_reduce, reduce_scatter, gather_params = (
            self._sync_fns() if self._overlap else (None, None, None))
        residual = state.grad_residual
        if self.update_sharding == "sharded":
            # Reduce-scatter, the update of this rank's flat shard, then
            # the params gathered: the fault and the guard's norm on the
            # shards (the psum of their squares is the global norm).
            keys = state.dp_sync.keys()
            shards, new_res = reduce_scatter(grads, residual)
            del grads
            shards = dict(zip(keys, (s / n for s in shards)))
            shards, metrics = self._instrument_grads(
                shards, state.step, metrics, norm=self._shard_norm)

            def commit():
                params = state.dp_sync.local(state.params)
                opt_state = self.tx.update(shards, state.opt_state, params)
                whole = gather_params([params[k] for k in keys])
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.copy_(whole[k])
                return dataclasses.replace(state, step=state.step + 1,
                                           opt_state=opt_state,
                                           grad_residual=new_res)

            return self.task.finish_metrics(metrics), commit
        if posted is not None:
            summed, new_res = posted.finish(grads), None
        elif self._overlap:
            summed, new_res = all_reduce(grads, residual)
        elif self.grad_comm != "fp32":
            from .comms_quant import quantized_tree_all_reduce

            summed, new_res = quantized_tree_all_reduce(
                grads, self._dp_mesh, "dp", mode=self.grad_comm,
                block_size=self.grad_comm_block, residual=residual)
        del grads
        grads = {k: v / n for k, v in summed.items()}
        if self.layout is not None:
            # ZeRO-1 downstream of the synced (replicated) gradients: this
            # rank's shard of them, no further collective.
            flats = self.layout.flatten(grads)
            shards = {g: f[self.layout.shard_slice(g)]
                      for g, f in flats.items()}
            shards, metrics = self._instrument_grads(
                shards, state.step, metrics, norm=self.layout.global_norm)

            def commit():
                norm = (self.layout.global_norm(shards) if self.tx.grad_clip
                        else None)
                opt_state = self.tx.update_shard(
                    shards, state.opt_state, self.layout.param_shards(), norm)
                self.layout.gather_params()
                return dataclasses.replace(state, step=state.step + 1,
                                           opt_state=opt_state,
                                           grad_residual=new_res)
        else:
            grads, metrics = self._instrument_grads(grads, state.step,
                                                    metrics)

            def commit():
                norm = global_norm(grads) if self.tx.grad_clip else None
                opt_state = self.tx.update(grads, state.opt_state,
                                           state.params, norm=norm)
                return dataclasses.replace(state, step=state.step + 1,
                                           opt_state=opt_state,
                                           grad_residual=new_res)
        return self.task.finish_metrics(metrics), commit

    def _shard_norm(self, shards: dict):
        """The global gradient norm from every dp rank's flat shards."""
        sq = torch.stack([(s * s).sum() for s in shards.values()]).sum()
        return torch.sqrt(psum(sq, self._dp_mesh, "dp"))

    def _staged_step(self, state: TrainState, batch: dict):
        """One step up to its update: ``(metrics as device scalars,
        commit)``, where ``commit()`` applies the update in place and
        returns the new state (the health guard runs it on healthy steps
        only)."""
        if self.explicit:
            return self._explicit_step(state, batch)
        if self.grad_accum == 1:
            self._generator.manual_seed(fold_in_step(state.rng, state.step))
            grads, metrics = self._grads(state, batch)
        else:
            grads, metrics = self._accumulated_grads(state, batch)
        if self.layout is not None:
            # ZeRO-1: this rank's shard of the world-mean gradient, the
            # clip on the global norm, the update of this rank's shard of
            # the masters and moments, then every rank's shard gathered.
            keys = list(metrics)
            metrics = dict(zip(keys, self._batch_mean(
                [metrics[k] for k in keys])))
            if self.shards is not None:
                from .parallel.fsdp import reduce_grads

                grads = reduce_grads(grads, self.shards)
            shards = self.layout.reduce_scatter_grads(grads)
            del grads
            shards, metrics = self._instrument_grads(
                shards, state.step, metrics, norm=self.layout.global_norm)

            def commit():
                norm = (self.layout.global_norm(shards) if self.tx.grad_clip
                        else None)
                opt_state = self.tx.update_shard(
                    shards, state.opt_state, self.layout.param_shards(), norm)
                self.layout.gather_params()
                return dataclasses.replace(state, step=state.step + 1,
                                           opt_state=opt_state)
        else:
            if self.shards is not None:
                from .parallel.fsdp import reduce_grads

                # The tp and fsdp share of the batch mean; the cp and dp
                # shares below.
                grads = reduce_grads(grads, self.shards)
                keys = list(metrics)
                metrics = dict(zip(keys, pmean_tensors(
                    [metrics[k] for k in keys], self.mesh, "fsdp")))
            if self.mesh is not None and self.mesh.size > 1:
                # Each rank's loss is the mean over an equal share of the
                # tokens, so the world average of the gradients (and
                # metrics) is that of the global mean loss, as the
                # reference's. Before the update, so its clip sees the
                # global norm.
                names, keys = list(grads), list(metrics)
                synced = self._batch_mean(
                    [grads[k] for k in names] + [metrics[k] for k in keys],
                    fsdp=False)
                grads = dict(zip(names, synced[:len(names)]))
                metrics = dict(zip(keys, synced[len(names):]))
            grads, metrics = self._instrument_grads(grads, state.step,
                                                    metrics, norm=self._norm)

            def commit():
                norm = self._norm(grads) if self.tx.grad_clip else None
                opt_state = self.tx.update(grads, state.opt_state,
                                           state.params, norm=norm)
                return dataclasses.replace(state, step=state.step + 1,
                                           opt_state=opt_state)
        if self.engine and self.model.schedule == "1f1b_interleaved":
            # The reference's interleaved step reports its loss alone.
            return metrics, commit
        return self.task.finish_metrics(metrics), commit

    def train_step(self, state: TrainState, batch: dict):
        """One step: (new state, metrics as device scalars). Under the
        health guard the step's loss and gradient norm are read on the host
        before the update, which a bad step skips."""
        if self.health is not None:
            from .health import guard_step

            return guard_step(self._staged_step, self.health)(state, batch)
        metrics, commit = self._staged_step(state, batch)
        return commit(), metrics

    def fused_train_step(self, steps_per_call: int):
        """K-step dispatch: a callable ``(state, superbatch) -> (state,
        metrics)`` that runs :meth:`train_step` over each of the K batches
        of a stacked superbatch (leaves ``[K, B, ...]``), back to back with
        no host read between them, and returns the metrics stacked over the
        K steps (leaves ``[K]``). ``steps_per_call=1`` returns
        ``train_step`` itself."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call={steps_per_call} must be >= 1")
        if steps_per_call == 1:
            return self.train_step

        def fused(state: TrainState, superbatch: dict):
            k = next(iter(superbatch.values())).shape[0]
            if k != steps_per_call:
                raise ValueError(f"superbatch of {k} steps, expected "
                                 f"steps_per_call={steps_per_call}")
            out = []
            for j in range(k):
                state, m = self.train_step(
                    state, {x: v[j] for x, v in superbatch.items()})
                out.append(m)
            return state, {x: torch.stack([m[x] for m in out])
                           for x in out[0]}

        return fused

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """The task's metrics on ``batch`` from a forward with ``train=
        False``, in fp32, averaged over the ranks. A model pipelined over pp
        runs its head on the last stage only
        (``pipeline_eval``)."""
        if self.stage_rows is not None:
            metrics = self.model.pipeline_eval(batch, self.task)
        else:
            out = self._forward(
                state, cast_to_compute(self.precision, state.params), batch,
                train=False)
            _, metrics = self.task.loss_fn(out, batch)
        keys = list(metrics)
        vals = self._batch_mean([metrics[k].float() for k in keys])
        return self.task.finish_metrics(dict(zip(keys, vals)))


def evaluate(trainer: Trainer, state: TrainState, batches) -> dict:
    """:meth:`Trainer.eval_step` over an iterable of this rank's batches:
    the batch mean of every metric, prefixed ``eval_``. The sums stay on
    the device in fp32 and come to the host in one pull per pass. For the
    LM task ``eval_perplexity`` is exp(eval_loss), as the reference's (a
    mean of per-batch exp(loss) would overstate it)."""
    sums, count = None, 0
    for batch in batches:
        m = trainer.eval_step(state, batch)
        sums = m if sums is None else {k: sums[k] + v for k, v in m.items()}
        count += 1
    if count == 0:
        raise ValueError("evaluate() got an empty batch iterable")
    keys = list(sums)
    host = torch.stack([sums[k] for k in keys]).cpu().tolist()
    out = {f"eval_{k}": v / count for k, v in zip(keys, host)}
    if "perplexity" in sums and "loss" in sums:
        out["eval_perplexity"] = math.exp(out["eval_loss"])
    return out


def check_fusion_cadences(steps_per_call: int, *, steps: int, start: int = 0,
                          log_every: int = 0, eval_every: int = 0,
                          save_every: int = 0,
                          fault: FaultSpec | None = None) -> None:
    """The reference's fences for multi-step dispatch: the host regains
    control only every ``steps_per_call`` steps, so every cadence (steps,
    log, eval, save), a host-side fault's step and the resume step must
    land on a call edge (``nan:K`` fires inside the step: it is exempt)."""
    k = steps_per_call
    if k < 1:
        raise ValueError(f"steps_per_call={k} must be >= 1")
    if fault is not None and fault.kind not in FAULT_KINDS:
        raise ValueError(f"fault kind {fault.kind!r} not in {FAULT_KINDS}")
    if k == 1:
        return
    for name, every in (("steps", steps), ("log_every", log_every),
                        ("eval_every", eval_every),
                        ("save_every", save_every)):
        if every and every % k:
            raise ValueError(
                f"steps_per_call={k} must divide {name}={every}: fused calls "
                f"advance {k} steps at a time, so every cadence boundary has "
                "to land on a call edge"
            )
    if fault is not None and fault.kind != "nan" and fault.step % k:
        raise ValueError(
            f"steps_per_call={k} must divide fault_step={fault.step} "
            f"(kind={fault.kind!r}): host-side fault injections fire between "
            "fused calls — use steps_per_call=1 for mid-interval faults"
        )
    if start % k:
        raise ValueError(
            f"resume step {start} is not a multiple of steps_per_call={k}: "
            "align save_every to the fused cadence (it is fenced above) or "
            "finish the partial interval with steps_per_call=1"
        )


FAULT_KINDS = ("step", "nan", "hang", "corrupt")


class FaultSpec(NamedTuple):
    """One injected fault (``train.fault_injection='kind:K'``): ``kind`` is
    how the run breaks, ``step`` the pre-step counter it breaks at.

    - ``step``: the process exits at once (``os._exit(EXIT_FAULT)``: a
      crash, no cleanup);
    - ``nan``: that step's gradients are poisoned (Trainer
      ``fault_nan_step``);
    - ``hang``: the host loop stalls for ever (the heartbeat goes stale);
    - ``corrupt``: the latest checkpoint is truncated, then as ``step``.
    """

    kind: str
    step: int


def parse_fault_injection(spec: str) -> FaultSpec | None:
    """'kind:K' -> FaultSpec(kind, K) for kind in FAULT_KINDS; '' -> None."""
    if not spec:
        return None
    kind, _, arg = spec.partition(":")
    if kind not in FAULT_KINDS or not arg.isdigit():
        raise ValueError(
            f"fault_injection {spec!r}: expected one of "
            f"{'|'.join(FAULT_KINDS)}:K"
        )
    return FaultSpec(kind, int(arg))


class Preempted(Exception):
    """Raised by :func:`fit` after the final save a SIGTERM or SIGINT asked
    for: the state at ``step`` is on disk, and the process should exit
    ``supervisor.EXIT_PREEMPTED`` and not be restarted."""

    def __init__(self, step: int, saved: bool):
        super().__init__(f"preempted at step {step} (saved={saved})")
        self.step = step
        self.saved = saved


class HealthRollback(Exception):
    """Raised by :func:`fit` when the health guard reports
    ``max_consecutive_anomalies`` anomalous steps in a row: the in-memory
    state is not worth continuing from, and the caller (``cli train``)
    restores the last checkpoint and trains again."""

    def __init__(self, step: int, consecutive: int):
        super().__init__(
            f"{consecutive} consecutive anomalous steps at step {step}"
        )
        self.step = step
        self.consecutive = consecutive


def fit(trainer: Trainer, state: TrainState, batches, steps: int,
        log_every: int = 10, steps_per_call: int = 1, log_fn=print,
        writer=None, profiler=None, ckpt=None, save_every: int = 0,
        fault: FaultSpec | None = None, eval_every: int = 0, eval_fn=None,
        step_times: list | None = None, health=None, on_step=None,
        heartbeat_file: str | None = None, telemetry=None):
    """Host step loop from ``state.step`` to ``steps`` (callers start
    ``batches`` at the same index).

    Every ``log_every`` steps a record ``{metric, ..., "step", "wall_s"}``
    goes to ``log_fn`` (and ``writer``, a ``metrics.MetricWriter``) with one
    interval of lag (``DeferredMetrics``); the last interval is flushed
    before returning. Loop events (faults, preemption saves, rollbacks) go
    through the same ordered stream (``metrics.event_record``).
    ``steps_per_call`` = K > 1 runs :meth:`Trainer.fused_train_step` over
    stacked superbatches (leaves ``[K, B, ...]``, ``data.stacked_batches``),
    and K must divide ``steps``, every cadence and a host-side fault's step
    (:func:`check_fusion_cadences`). ``eval_every`` > 0 runs
    :func:`evaluate` over ``eval_fn()`` (a fresh iterable of this rank's
    eval batches) every that many steps and after the last, its record
    keyed ``eval_*``. ``ckpt`` (a ``checkpoint.CheckpointManager``) saves
    the state with ``{"next_index": step}`` every ``save_every`` steps.
    ``profiler`` (a ``metrics.Profiler``) sees every step's index.
    ``step_times``: when a list, each call ends in a device sync and its
    seconds are appended (for timing; the loop otherwise never waits on
    the device outside its log records and evaluations). ``on_step(end)``
    runs after each call, at its last step (after ``step_times``' sync).
    Returns (state, history).

    Resilience, as the reference's loop:

    - ``fault`` (:class:`FaultSpec`) injects one failure: ``step`` and
      ``corrupt`` exit through ``os._exit(EXIT_FAULT)`` (a crash: no
      cleanup; ``corrupt`` first truncates the latest checkpoint), ``hang``
      stalls the loop for ever, ``nan`` is the Trainer's
      ``fault_nan_step``. With a fault armed every save is waited for, so a
      crash resumes from a known step.
    - SIGTERM or SIGINT (preemption; handlers installed from the main
      thread only, and restored on every exit path) turns into a forced,
      synchronous save at the next call edge, a ``preempt_save`` record and
      :class:`Preempted`.
    - The loop writes ``{step, attempt, phase}`` to ``heartbeat_file``
      (default ``$DDL_HEARTBEAT_FILE``, which the supervisor exports) at
      its start and at every step edge, log record, evaluation and save.
    - ``health`` (a ``config.HealthConfig``): when the logged metric stream
      reports ``max_consecutive_anomalies`` anomalous steps in a row (one
      logging interval late, the deferred fetch's lag), a
      ``health_rollback`` event is emitted and :class:`HealthRollback`
      raised.

    ``telemetry`` (an enabled ``telemetry.Telemetry``) gets host spans
    (``step`` > ``data_wait``/``dispatch``/``device_wait``, plus
    ``checkpoint`` and ``eval``), the goodput ledger's seconds (the first
    dispatch of the step program is classed ``compile`` and registered;
    then data wait, checkpoint stall, eval, and productive or rollback
    replay) and a flight record on every fault, rollback and preemption.
    Off (None), each hook costs one truthiness check."""
    import os
    import signal
    import sys

    from .metrics import DeferredMetrics, event_record
    from .supervisor import ATTEMPT_ENV, EXIT_FAULT, HEARTBEAT_ENV
    from .supervisor import touch as hb_touch
    from .telemetry import NULL_TELEMETRY

    if eval_every and eval_fn is None:
        raise ValueError("eval_every > 0 requires eval_fn")
    k, start = steps_per_call, int(state.step)
    check_fusion_cadences(k, steps=steps, start=start, log_every=log_every,
                          eval_every=eval_every, save_every=save_every,
                          fault=fault)
    if fault is not None and fault.kind == "corrupt" and ckpt is None:
        raise ValueError("fault_injection=corrupt:K requires a checkpoint_dir")
    step_call = trainer.fused_train_step(k)
    max_consec = (health.max_consecutive_anomalies if health is not None
                  else 0)
    hb = (heartbeat_file if heartbeat_file is not None
          else os.environ.get(HEARTBEAT_ENV))
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    ledger = tel.ledger
    attempt = int(os.environ.get(ATTEMPT_ENV, "0") or 0)
    step_name = "train_step" if k == 1 else f"fused_train_step_{k}"
    history = []

    def beat(phase, at):
        # The mtime is the supervisor's liveness signal; the content says
        # where the loop was when it stopped.
        hb_touch(hb, step=at, attempt=attempt, phase=phase)

    def emit(m):
        history.append(m)
        log_fn(m)
        tel.note_event(m)
        if writer is not None and "event" not in m:
            writer.write(m["step"],
                         {x: v for x, v in m.items() if x != "step"})
        if max_consec and m.get("consecutive_anomalies", 0) >= max_consec:
            raise HealthRollback(int(m.get("step", 0)),
                                 int(m["consecutive_anomalies"]))

    deferred = DeferredMetrics(emit)

    def run_eval(at):
        # evaluate() syncs anyway; the train line of step N goes first.
        deferred.flush()
        t_ev = time.perf_counter()
        with tel.span("eval", step=at):
            m = evaluate(trainer, state, eval_fn())
        if ledger is not None:
            ledger.add("eval", time.perf_counter() - t_ev)
        emit({**m, "step": at})

    def fault_exit(event, at, **fields):
        # The process ends here, before the caller's finally: its records,
        # flight record and trace are written now or never.
        deferred.emit_event(event_record(event, at, **fields))
        tel.flight_dump(event, step=at, phase="fault")
        tel.write_trace()
        if ledger is not None:
            ledger.close(at)
        sys.stdout.flush()

    preempt = {"signum": None}

    def on_preempt(signum, frame):
        preempt["signum"] = signum

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_preempt)
        except ValueError:
            pass  # not the main thread

    t0 = time.perf_counter()
    it = iter(batches)
    end = start
    beat("start", start)
    try:
        for i in range(start, steps, k):
            if preempt["signum"] is not None:
                # Synchronous and forced (off the save cadence too): by the
                # time Preempted propagates, the state is on disk.
                saved = False
                if ckpt is not None:
                    with tel.span("checkpoint", step=end, forced=True):
                        if ckpt.latest_step() != end:
                            ckpt.save(end, state, {"next_index": end},
                                      force=True)
                        ckpt.wait()
                    saved = True
                signum = int(preempt["signum"])
                deferred.emit_event(event_record("preempt_save", end,
                                                 saved=saved, signum=signum))
                tel.flight_dump("preempt", step=end, phase="preempt",
                                signum=signum, saved=saved)
                tel.write_trace()
                sys.stdout.flush()
                raise Preempted(end, saved)
            if fault is not None and i == fault.step and fault.kind != "nan":
                if fault.kind == "step":
                    fault_exit("fault_kill", i)
                    os._exit(EXIT_FAULT)
                if fault.kind == "hang":
                    # Recorded before the stall: the supervisor's recovery
                    # is a SIGKILL, after which nothing is written.
                    fault_exit("fault_hang", i)
                    while True:
                        time.sleep(3600)
                ckpt.wait()  # corrupt a finished save, not a temp dir
                bad = ckpt.corrupt_latest_for_test()
                fault_exit("fault_corrupt", i, corrupted_step=bad)
                os._exit(EXIT_FAULT)
            beat("step", end)
            with tel.span("step", step=i):
                t_dw = time.perf_counter()
                try:
                    with tel.span("data_wait", step=i):
                        batch = next(it)
                except StopIteration:
                    break
                if ledger is not None:
                    ledger.add("data_wait", time.perf_counter() - t_dw)
                # The first call builds what the step needs (the kernels'
                # libraries, the allocator's pools): classed as compile.
                cold = tel.enabled and step_name not in tel.registry
                t_step = time.perf_counter()
                with tel.span("dispatch", step=i):
                    try:
                        state, metrics = step_call(state, batch)
                    except FloatingPointError as e:  # train.debug_nans
                        raise FloatingPointError(f"{e} (at step {i})") from e
                dt = time.perf_counter() - t_step
                if cold:
                    tel.record_exe(step_name, None, compile_s=dt)
                    if ledger is not None:
                        ledger.add("compile", dt)
                elif ledger is not None:
                    ledger.step_time(dt, i + k)
            if step_times is not None:
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize(trainer.device)
                step_times.append(time.perf_counter() - t_step)
            end = i + k
            if on_step is not None:
                on_step(end)
            if profiler is not None:
                for j in range(i, end):
                    profiler.step(j)
            if log_every and end % log_every == 0:
                # Fused metrics come back stacked [K]: the logged step is
                # the interval's last, as the unfused loop's.
                last = (metrics if k == 1
                        else {x: v[-1] for x, v in metrics.items()})
                with tel.span("device_wait", step=end):
                    deferred.push(end, last,
                                  wall_s=round(time.perf_counter() - t0, 3))
                beat("log", end)
            if eval_every and end % eval_every == 0:
                run_eval(end)
                beat("eval", end)
            if ckpt is not None and save_every and end % save_every == 0:
                t_ck = time.perf_counter()
                with tel.span("checkpoint", step=end):
                    ckpt.save(end, state, {"next_index": end})
                    if fault is not None:
                        # An injected crash resumes from the last save on
                        # disk: waiting makes that step known.
                        ckpt.wait()
                if ledger is not None:
                    ledger.add("checkpoint_stall",
                               time.perf_counter() - t_ck)
                beat("save", end)
        if eval_every and end % eval_every and end > start:
            run_eval(end)  # a final eval, so short runs still report one
        deferred.flush()
    except HealthRollback as rb:
        # The pending interval describes state that is being rewound;
        # emitting it could fire the policy again mid-unwind.
        deferred.discard()
        emit(event_record("health_rollback", rb.step,
                          consecutive=rb.consecutive))
        tel.flight_dump("health_rollback", step=rb.step, phase="rollback",
                        consecutive=rb.consecutive)
        tel.write_trace()
        sys.stdout.flush()
        raise
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if profiler is not None:
            profiler.close()
        if writer is not None:
            writer.flush()
    return state, history
