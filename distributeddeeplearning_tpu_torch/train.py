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
- ``grad_accum`` microbatches a step, ``steps_per_call`` steps a call
  (:meth:`Trainer.fused_train_step`), and :func:`evaluate`; ``fit`` runs
  the cadences of logging, evaluation and checkpoints
  (``checkpoint.CheckpointManager``).

The health guard comes in a later slice; ``cli train`` refuses its knob by
name.
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

from .comms import pmean_tensors
from .ops.fused_adamw import (
    FusedAdamW,
    FusedAdamWState,
    decay_leaf,
    f32,
    global_norm,
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

    return Task(input_fn=lambda b: (b["image"],), loss_fn=loss_fn)


_TASK_KNOBS = {"head_chunk", "label_smoothing"}  # every task's, reference
_UNPORTED_TASKS = {"mlm": "A9"}


def get_task(name: str, mesh=None, **task_kwargs) -> Task:
    """``task_kwargs``: per-task knobs; a knob no task of the reference
    declares is a TypeError, a knob another task declares is dropped.
    ``mesh``: the ranks a batch is split over."""
    unknown = set(task_kwargs) - _TASK_KNOBS
    if unknown:
        raise TypeError(f"unknown task knob(s) {sorted(unknown)}")
    if name in _UNPORTED_TASKS:
        raise NotImplementedError(
            f"train.task={name!r} not yet ported to "
            "distributeddeeplearning_tpu_torch (ROADMAP queue "
            f"{_UNPORTED_TASKS[name]}); 'lm' and 'classification' are"
        )
    if name == "classification":
        return classification_task(task_kwargs.get("label_smoothing", 0.0))
    if name != "lm":
        raise KeyError(f"unknown task {name!r}")
    return lm_task(mesh=mesh, **{k: v for k, v in task_kwargs.items()
                                 if k == "head_chunk"})


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
    (count, mu, nu) layout, as optax's ``ScaleByAdamState`` does."""

    def _step(self, count: int, leaves) -> None:
        """The update at the pre-increment ``count`` over ``leaves``, (p,
        g, mu, nu, decayed) each."""
        lr = f32(self.learning_rate(count)
                 if callable(self.learning_rate) else self.learning_rate)
        bc1 = float(_F(1) - np.power(_F(self.b1), _F(count + 1)))
        bc2 = float(_F(1) - np.power(_F(self.b2), _F(count + 1)))
        b1, b2 = f32(self.b1), f32(self.b2)
        omb1, omb2 = f32(1 - self.b1), f32(1 - self.b2)
        eps, wd = f32(self.eps), f32(self.weight_decay)
        for p, g, mu, nu, decayed in leaves:
            g = g.float()
            mu.copy_(g * omb1 + mu * b1)
            nu.copy_((g * g) * omb2 + nu * b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if wd and decayed:
                u = u + p * wd
            p.add_(u * -lr)

    @torch.no_grad()
    def update(self, grads: dict, state: FusedAdamWState,
               params: dict) -> FusedAdamWState:
        if self.grad_clip:
            grads = clip_to(grads, global_norm(grads), self.grad_clip)
        self._step(state.count, (
            (p, grads[k], state.mu[k], state.nu[k], decay_leaf(p))
            for k, p in params.items()))
        return FusedAdamWState(count=state.count + 1, mu=state.mu,
                               nu=state.nu)

    @torch.no_grad()
    def update_shard(self, grads: dict, state, params: dict, norm):
        """:meth:`FusedAdamW.update_shard`'s contract, in plain torch: each
        group's weight decay is the group's."""
        if self.grad_clip:
            grads = clip_to(grads, norm, self.grad_clip)
        self._step(state.count, (
            (p, grads[g], state.mu[g], state.nu[g], g == "decay")
            for g, p in params.items()))
        return state._replace(count=state.count + 1)


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

    @torch.no_grad()
    def update(self, grads: dict, state: SGDState, params: dict) -> SGDState:
        if self.grad_clip:
            grads = clip_to(grads, global_norm(grads), self.grad_clip)
        lr = f32(self.learning_rate(state.count)
                 if callable(self.learning_rate) else self.learning_rate)
        wd, mom = f32(self.weight_decay), f32(self.momentum)
        for k, p in params.items():
            g, t = grads[k].float(), state.trace[k]
            if wd and decay_leaf(p):
                g = g + p * wd
            t.copy_(g + t * mom)
            p.add_(t * -lr)
        return SGDState(count=state.count + 1, trace=state.trace)


def opt_state_trees(opt_state) -> dict:
    """The params-shaped trees of an optimizer state, by name: Adam's
    ``mu`` and ``nu`` (a ZeRO-1 rank's shards of them), or SGD's
    ``trace``."""
    if isinstance(opt_state, SGDState):
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
    AdamW (the same); ``adamw_fused`` the fused kernel with the clip inside
    its update. The ``bf16_full`` policy is refused by name."""
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
    check_precision_composition(precision, optim_name=name)
    if name == "sgd":
        return SGD(sched, momentum=momentum, weight_decay=weight_decay,
                   grad_clip=grad_clip)
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
    forward, as JAX's ``model_state``)."""

    step: int
    params: dict
    opt_state: Any
    rng: int
    model_state: dict = dataclasses.field(default_factory=dict)


CP_ATTN = ("ring", "ring_pallas")
ZERO1_SGD = ("train.zero1=True with optim.name='sgd' over dp > 1: ZeRO-1 of "
             "the SGD momentum trace not yet ported to "
             "distributeddeeplearning_tpu_torch (ROADMAP queue A8; the port "
             "shards AdamW's moments)")


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
    averages their fp32 gradients and metrics."""

    def __init__(self, model, tx, task: Task, *, device,
                 precision: str | Policy = "fp32", mesh=None,
                 zero1: bool = False, grad_accum: int = 1):
        self.model, self.tx, self.task = model, tx, task
        self.mesh = mesh
        cp = 1 if mesh is None else mesh.shape["cp"]
        attn = getattr(model, "attn_impl", None)
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
        if zero1 and mesh is not None and mesh.shape["dp"] > 1:
            if isinstance(tx, SGD):
                raise NotImplementedError(ZERO1_SGD)
            from .parallel.zero import ZeroLayout

            self.layout = ZeroLayout(dict(model.named_parameters()), mesh)
            self.layout.bind(dict(model.named_parameters()))

    def init(self, seed: int) -> TrainState:
        """Draw the weights from ``seed`` and make the optimizer state."""
        self.model.init_weights(torch.Generator().manual_seed(int(seed)))
        params = dict(self.model.named_parameters())
        opt_state = (self.tx.init(params) if self.layout is None
                     else self.tx.init_shard(self.layout))
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=int(seed),
                          model_state=dict(self.model.named_buffers()))

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

    def _grads(self, state: TrainState, batch: dict):
        """(fp32 gradients, metrics) of this rank's loss on ``batch``."""
        # Mixed precision: ONE compute copy per call, differentiated
        # directly; fp32 returns the masters themselves.
        cparams = cast_to_compute(self.precision, state.params)
        out = self._forward(state, cparams, batch, train=True)
        loss, metrics = self.task.loss_fn(out, batch)
        names = list(cparams)
        grads = torch.autograd.grad(loss, [cparams[k] for k in names],
                                    allow_unused=True)
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

    def train_step(self, state: TrainState, batch: dict):
        """One step: (new state, metrics as device scalars)."""
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
            metrics = dict(zip(keys, pmean_tensors(
                [metrics[k] for k in keys], self.mesh)))
            shards = self.layout.reduce_scatter_grads(grads)
            del grads
            norm = (self.layout.global_norm(shards) if self.tx.grad_clip
                    else None)
            opt_state = self.tx.update_shard(
                shards, state.opt_state, self.layout.param_shards(), norm)
            self.layout.gather_params()
        else:
            if self.mesh is not None and self.mesh.size > 1:
                # Each rank's loss is the mean over an equal share of the
                # tokens, so the world average of the gradients (and
                # metrics) is that of the global mean loss, as the
                # reference's. Before the update, so its clip sees the
                # global norm.
                names, keys = list(grads), list(metrics)
                synced = pmean_tensors(
                    [grads[k] for k in names] + [metrics[k] for k in keys],
                    self.mesh)
                grads = dict(zip(names, synced[:len(names)]))
                metrics = dict(zip(keys, synced[len(names):]))
            opt_state = self.tx.update(grads, state.opt_state, state.params)
        metrics = self.task.finish_metrics(metrics)
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

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
        False``, in fp32, averaged over the ranks."""
        out = self._forward(
            state, cast_to_compute(self.precision, state.params), batch,
            train=False)
        _, metrics = self.task.loss_fn(out, batch)
        keys = list(metrics)
        vals = [metrics[k].float() for k in keys]
        if self.mesh is not None and self.mesh.size > 1:
            vals = pmean_tensors(vals, self.mesh)
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
                          save_every: int = 0) -> None:
    """The reference's fences for multi-step dispatch: the host regains
    control only every ``steps_per_call`` steps, so every cadence (steps,
    log, eval, save) and the resume step must land on a call edge."""
    k = steps_per_call
    if k < 1:
        raise ValueError(f"steps_per_call={k} must be >= 1")
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
    if start % k:
        raise ValueError(
            f"resume step {start} is not a multiple of steps_per_call={k}: "
            "align save_every to the fused cadence (it is fenced above) or "
            "finish the partial interval with steps_per_call=1"
        )


def fit(trainer: Trainer, state: TrainState, batches, steps: int,
        log_every: int = 10, steps_per_call: int = 1, log_fn=print,
        writer=None, profiler=None, ckpt=None, save_every: int = 0,
        eval_every: int = 0, eval_fn=None, step_times: list | None = None):
    """Host step loop from ``state.step`` to ``steps`` (callers start
    ``batches`` at the same index).

    Every ``log_every`` steps a record ``{metric, ..., "step", "wall_s"}``
    goes to ``log_fn`` (and ``writer``, a ``metrics.MetricWriter``) with one
    interval of lag (``DeferredMetrics``); the last interval is flushed
    before returning. ``steps_per_call`` = K > 1 runs
    :meth:`Trainer.fused_train_step` over stacked superbatches (leaves
    ``[K, B, ...]``, ``data.stacked_batches``), and K must divide ``steps``
    and every cadence (:func:`check_fusion_cadences`). ``eval_every`` > 0
    runs :func:`evaluate` over ``eval_fn()`` (a fresh iterable of this
    rank's eval batches) every that many steps and after the last, its
    record keyed ``eval_*``. ``ckpt`` (a ``checkpoint.CheckpointManager``)
    saves the state with ``{"next_index": step}`` every ``save_every``
    steps. ``profiler`` (a ``metrics.Profiler``) sees every step's index.
    ``step_times``: when a list, each call ends in a device sync and its
    seconds are appended (for timing; the loop otherwise never waits on
    the device outside its log records and evaluations). Returns (state,
    history)."""
    from .metrics import DeferredMetrics

    if eval_every and eval_fn is None:
        raise ValueError("eval_every > 0 requires eval_fn")
    k, start = steps_per_call, int(state.step)
    check_fusion_cadences(k, steps=steps, start=start, log_every=log_every,
                          eval_every=eval_every, save_every=save_every)
    step_call = trainer.fused_train_step(k)
    history = []

    def emit(m):
        history.append(m)
        log_fn(m)
        if writer is not None and "event" not in m:
            writer.write(m["step"],
                         {x: v for x, v in m.items() if x != "step"})

    deferred = DeferredMetrics(emit)

    def run_eval(at):
        # evaluate() syncs anyway; the train line of step N goes first.
        deferred.flush()
        emit({**evaluate(trainer, state, eval_fn()), "step": at})

    t0 = time.perf_counter()
    it = iter(batches)
    end = start
    try:
        for i in range(start, steps, k):
            try:
                batch = next(it)
            except StopIteration:
                break
            t_step = time.perf_counter()
            state, metrics = step_call(state, batch)
            if step_times is not None:
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize(trainer.device)
                step_times.append(time.perf_counter() - t_step)
            end = i + k
            if profiler is not None:
                for j in range(i, end):
                    profiler.step(j)
            if log_every and end % log_every == 0:
                # Fused metrics come back stacked [K]: the logged step is
                # the interval's last, as the unfused loop's.
                last = (metrics if k == 1
                        else {x: v[-1] for x, v in metrics.items()})
                deferred.push(end, last,
                              wall_s=round(time.perf_counter() - t0, 3))
            if eval_every and end % eval_every == 0:
                run_eval(end)
            if ckpt is not None and save_every and end % save_every == 0:
                ckpt.save(end, state, {"next_index": end})
        if eval_every and end % eval_every and end > start:
            run_eval(end)  # a final eval, so short runs still report one
        deferred.flush()
    finally:
        if profiler is not None:
            profiler.close()
        if writer is not None:
            writer.flush()
    return state, history
