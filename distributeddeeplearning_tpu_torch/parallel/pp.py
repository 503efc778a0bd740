"""Pipeline parallelism over the ``pp`` axis, one stage a rank: the
counterpart of the JAX package's ``parallel/pp.py``.

The JAX package runs the whole pipeline as one SPMD program: the stage
parameters are stacked on a leading ``[S]`` axis sharded over ``pp``, and a
``lax.scan`` of ticks moves activations with ``ppermute``. Here every rank
is a process that holds its own rows of the stacked leaves (``[1, ...]`` at
``pp = S``, the whole ``[S, ...]`` at ``pp = 1``), runs the same ticks in a
host loop, and exchanges activations and cotangents with its two
neighbours (``comms.chain_exchange``: stage ``s`` sends up to ``s + 1`` and
down to ``s - 1``, both posted together each tick).

Engines (``M`` microbatches, ``S`` stages, this rank's stage ``s``):

- :func:`sequential`: the stages back to back, the correctness oracle and
  the ``pp = 1`` path;
- :func:`gpipe`: forward ticks ``T = M + S - 1``, stage ``s`` on
  microbatch ``t - s``, the graph of every microbatch kept; the backward is
  autograd over those graphs in the reverse pipeline's order;
- :func:`one_f_one_b`: the same forward, keeping only each microbatch's
  stage INPUT (at most ``M``), no graph; the backward runs the reverse
  pipeline, stage ``s`` on microbatch ``m`` at tick ``(S-1-s) + (M-1-m)``,
  recomputing the stage forward from the stashed input;
- :func:`interleaved_1f1b`: loss inside the schedule, gradients out. Each
  tick runs one forward unit (microbatch ``t - s``) and one backward unit
  (microbatch ``t - 2(S-1) + s``) over ``M + 2(S-1)`` ticks; the last
  stage computes its microbatch's loss and cotangent in the tick of its
  forward; the stash is a ring of depth ``2S``.

:func:`gpipe` and :func:`one_f_one_b` are differentiable: their output is
the last stage's (with ``broadcast=True`` every stage's, as JAX's ``psum``
makes it), and a backward on every rank of the axis runs the reverse
pipeline; the last stage's incoming gradient is the one used, and the
input's gradient is stage 0's (on every rank under ``broadcast``).
Gradients of the stage parameters accumulate over the microbatches in the
parameters' dtype. ``TICKS`` counts what the schedules did on this rank:
ticks, the seconds in the transport and the bytes sent, each for training
and for evaluation's forward, and the input stash's high-water mark.
"""

from __future__ import annotations

import math
import time

import torch

from .. import comms

# What the engines did on this rank since the last reset: ticks run, the
# seconds in the transport's calls and the bytes sent, for training and
# for evaluation (the forward alone), and the input stash's high-water mark.
TICKS = {"train_ticks": 0, "train_transport_s": 0.0,
         "train_transport_bytes": 0, "eval_ticks": 0,
         "eval_transport_s": 0.0, "eval_transport_bytes": 0, "max_stash": 0}


def reset_ticks() -> None:
    for k in TICKS:
        TICKS[k] = 0.0 if k.endswith("_s") else 0


def check_pipeline_shapes(local_batch: int, num_microbatches: int,
                          num_layers: int, num_stages: int) -> None:
    if num_layers % num_stages:
        raise ValueError(
            f"pipeline: num_layers={num_layers} not divisible by "
            f"num_stages={num_stages}"
        )
    if local_batch % num_microbatches:
        raise ValueError(
            f"pipeline: per-device batch {local_batch} not divisible by "
            f"num_microbatches={num_microbatches}"
        )


def gpipe_bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    """Fraction of schedule ticks a stage spends idle: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def stage_count(mesh, axis: str = "pp") -> int:
    return 1 if mesh is None else mesh.shape[axis]


def microbatch(t, m: int, num_microbatches: int):
    """Rows ``[m * n, (m + 1) * n)`` of ``t`` (``n = len / M``): the
    reference's contiguous row blocks; None stays None."""
    if t is None:
        return None
    n = t.shape[0] // num_microbatches
    return t[m * n:(m + 1) * n]


def _tree_microbatch(tree: dict, m: int, num_microbatches: int) -> dict:
    return {k: microbatch(v, m, num_microbatches) for k, v in tree.items()}


def _row(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


def _entry(x):
    """A stage's input: a leaf the engine differentiates against enters
    through a view, so module hooks that track autograd (``torch.utils.
    flop_counter``'s) see no leaf under ``autograd.grad``; without grad it
    enters detached."""
    if not torch.is_grad_enabled():
        return x.detach()
    return x.view_as(x) if x.requires_grad and x.is_leaf else x


def _apply(stage_fn, params, x, extra):
    x = _entry(x)
    return stage_fn(params, x) if extra is None else stage_fn(params, x,
                                                              extra)


def sequential(stage_fn, stacked: dict, x, extra=None):
    """The stacked stages (leaves ``[n, ...]``) applied back to back to
    ``x``; ``extra`` (a key-padding mask) is every stage's, whole."""
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        x = _apply(stage_fn, _row(stacked, i), x, extra)
    return x


class _Chain:
    """This rank's place on the ``axis`` chain and its tick traffic."""

    def __init__(self, mesh, axis: str, device, kind: str = "train"):
        self.mesh, self.axis, self.device = mesh, axis, device
        self.S, self.s = mesh.shape[axis], mesh.coords[axis]
        self.kind = kind  # 'train' or 'eval': which counters of TICKS

    def exchange(self, *, up=None, down=None, from_below=None,
                 from_above=None):
        """One tick's traffic (``comms.chain_exchange``), counted."""
        t0 = time.perf_counter()
        got = comms.chain_exchange(
            self.mesh, self.axis, up=up, down=down, from_below=from_below,
            from_above=from_above, device=self.device)
        TICKS[f"{self.kind}_transport_s"] += time.perf_counter() - t0
        TICKS[f"{self.kind}_ticks"] += 1
        TICKS[f"{self.kind}_transport_bytes"] += sum(
            t.numel() * t.element_size() for t, ok in (
                (up, self.s < self.S - 1), (down, self.s > 0))
            if t is not None and ok)
        return got


def psum_shared(tensors: list, mesh, axis: str = "pp") -> list:
    """The sum over ``axis`` of tensors that live on one stage each (the
    replicated leaves' gradients, the last stage's loss): every rank of the
    axis gets it. ``mesh`` None: one rank, nothing to sum."""
    if mesh is None:
        return list(tensors)
    return comms.psum_tensors(tensors, mesh, axis)


class StageRows:
    """A pipelined model's stage-stacked leaves (``names``), their stage
    count, and this rank's rows ``[lo, hi)`` of them (the same names and
    per-rank shapes as the reference's ``shard_map`` view); ``mesh``: the
    mesh whose ``pp`` ranks hold the other rows, None when this rank holds
    every row."""

    def __init__(self, names, num_stages: int, lo: int, hi: int, mesh=None):
        self.names, self.num_stages = set(names), num_stages
        self.lo, self.hi, self.mesh = lo, hi, mesh

    def take(self, tree: dict) -> dict:
        """This rank's rows of each stage leaf of a whole tree (the others
        as they are)."""
        return {k: v[self.lo:self.hi] if k in self.names else v
                for k, v in tree.items()}

    def whole_shape(self, name: str, shape) -> tuple:
        if name not in self.names:
            return tuple(shape)
        return (self.num_stages, *tuple(shape)[1:])

    def whole_numel(self, tree: dict) -> int:
        """The whole model's element count from a rank's ``tree``."""
        return sum(math.prod(self.whole_shape(k, v.shape))
                   for k, v in tree.items())

    def gather(self, tree: dict) -> dict | None:
        """The whole tree of a rank's ``tree`` (params-shaped: its rows of
        the stage leaves) on rank 0: every stage's rows in stage order, the
        other leaves as rank 0 holds them. A collective over ``pp`` of the
        ranks whose other coordinates are 0 (moved in fp32, as the
        checkpoint's ZeRO-1 gather); None on every other rank."""
        if self.mesh is None:
            return tree
        if any(c for a, c in self.mesh.coords.items() if a != "pp"):
            return None
        names = [k for k in tree if k in self.names]
        flat = torch.cat([tree[k].detach().reshape(-1).float()
                          for k in names])
        full = comms.gather(flat, self.mesh, "pp")
        if full is None:
            return None
        chunks = full.chunk(self.mesh.shape["pp"])
        out, o = dict(tree), 0
        for k in names:
            n, shape = tree[k].numel(), tree[k].shape
            out[k] = torch.cat([c[o:o + n].view(shape) for c in chunks]).to(
                tree[k].dtype)
            o += n
        return out


def whole_sq(stage_sq, shared_sq, mesh, axis: str = "pp"):
    """The whole model's squared gradient norm from one rank's sums of
    squares over its stage leaves and over its shared leaves: the stage
    sums over the axis, the shared leaves' (equal on every rank) once.
    Every rank of the axis gets the same value, so every rank takes the
    same clip and the same health decision."""
    first = comms.axis_index(mesh, axis) == 0
    v = torch.stack([stage_sq, shared_sq if first else
                     torch.zeros_like(shared_sq)])
    v = comms.psum(v, mesh, axis)
    return v[0] + v[1]


def whole_norm(grads: dict, rows: StageRows):
    """The whole model's global gradient norm from one rank's whole leaves
    (``grads`` by name; the stage leaves per ``rows``)."""
    def sq(part):
        return torch.stack([torch.linalg.vector_norm(g.float()) ** 2
                            for g in part]).sum()

    stage = [g for k, g in grads.items() if k in rows.names]
    shared = [g for k, g in grads.items() if k not in rows.names]
    return torch.sqrt(whole_sq(sq(stage), sq(shared), rows.mesh))


def _leaves(params: dict) -> dict:
    """Detached copies of a stage's parameters that autograd tracks, the
    leaves the engine differentiates against."""
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def _accumulate(acc: dict | None, names, grads) -> dict:
    """``acc`` plus ``grads`` (one per name, None for no dependence), in
    the parameters' dtype."""
    if acc is None:
        acc = {}
    for k, g in zip(names, grads):
        if g is None:
            continue
        acc[k] = g.clone() if k not in acc else acc[k].add_(g)
    return acc


def _forward_ticks(stage_fn, params: dict, x, chain: _Chain, M: int, act,
                   extra, keep: str):
    """The forward schedule: ``M + S - 1`` ticks, stage ``s`` on microbatch
    ``t - s``. ``keep``: 'graph' (each microbatch's input leaf and output,
    with the graph between), 'input' (each microbatch's input, no graph)
    or 'none'. Returns (the last stage's outputs by microbatch, what was
    kept by microbatch)."""
    S, s = chain.S, chain.s
    outs, kept = [None] * M, [None] * M
    recv = None
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            x_in = microbatch(x, m, M) if s == 0 else recv
            if keep == "graph":
                x_in = x_in.detach().requires_grad_()
                with torch.enable_grad():
                    y = _apply(stage_fn, params, x_in,
                               microbatch(extra, m, M))
                kept[m] = (x_in, y)
                y = y.detach()
            else:
                with torch.no_grad():
                    y = _apply(stage_fn, params, x_in,
                               microbatch(extra, m, M))
                if keep == "input":
                    kept[m] = x_in
                    TICKS["max_stash"] = max(
                        TICKS["max_stash"], sum(k is not None for k in kept))
            if s == S - 1:
                outs[m] = y
        below = 0 <= t - (s - 1) < M
        recv, _ = chain.exchange(up=y, from_below=act if below else None)
    return outs, kept


def _backward_ticks(stage_fn, params: dict, kept, cot, chain: _Chain,
                    M: int, act, extra, need_dx: bool, recompute: bool):
    """The reverse pipeline: stage ``s`` handles microbatch ``m`` at tick
    ``(S-1-s) + (M-1-m)``, from its kept graph or by recomputing the stage
    forward from its kept input, and hands the input's cotangent down.
    ``cot(m)``: the output cotangent of microbatch ``m`` (the last stage's).
    Returns (parameter gradients, input cotangents by microbatch on stage
    0)."""
    S, s = chain.S, chain.s
    names = list(params)
    leaves = _leaves(params) if recompute else params
    grads, dxs = None, [None] * M
    recv = None
    for u in range(M + S - 1):
        k = u - (S - 1 - s)
        dx = None
        if 0 <= k < M:
            m = M - 1 - k
            g = cot(m) if s == S - 1 else recv
            if not recompute:
                x_in, y = kept[m]
            else:
                x_in = kept[m].detach().requires_grad_()
                with torch.enable_grad():
                    y = _apply(stage_fn, leaves, x_in,
                               microbatch(extra, m, M))
            wrt = [leaves[n] for n in names]
            want_dx = s > 0 or need_dx
            if want_dx:
                wrt.append(x_in)
            got = torch.autograd.grad(y, wrt, g.to(y.dtype),
                                      allow_unused=True)
            kept[m] = None  # the graph or the input goes with its tick
            grads = _accumulate(grads, names, got[:len(names)])
            if want_dx:
                dx = got[-1]
                if s == 0:
                    dxs[m] = dx
        above = 0 <= (u - (S - 1 - (s + 1))) < M
        _, recv = chain.exchange(down=dx, from_above=act if above else None)
    grads = grads or {}
    return ({n: grads.get(n, torch.zeros_like(params[n])) for n in names},
            dxs)


class _Pipeline(torch.autograd.Function):
    """One forward schedule and, in the backward, the reverse pipeline.
    ``spec``: (stage_fn, names, chain, M, act, extra, keep, broadcast)."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        stage_fn, names, chain, M, act, extra, keep, broadcast = spec
        params = {n: leaf[0] for n, leaf in zip(names, leaves)}
        if keep == "graph":
            params = _leaves(params)
        outs, kept = _forward_ticks(stage_fn, params, x, chain, M, act,
                                    extra, keep)
        ctx.spec, ctx.params, ctx.kept = spec, params, kept
        ctx.x_grad = x is not None and ctx.needs_input_grad[1]
        ctx.batch = M * act[0][0]
        y = (torch.cat(outs) if chain.s == chain.S - 1
             else torch.zeros((ctx.batch, *act[0][1:]), dtype=act[1],
                              device=chain.device))
        if broadcast:
            y = comms.psum(y.float(), chain.mesh, chain.axis).to(act[1])
        return y

    @staticmethod
    def backward(ctx, grad):
        stage_fn, names, chain, M, act, extra, keep, broadcast = ctx.spec

        def cot(m):
            return microbatch(grad, m, M)

        grads, dxs = _backward_ticks(stage_fn, ctx.params, ctx.kept, cot,
                                     chain, M, act, extra, ctx.x_grad,
                                     recompute=keep == "input")
        ctx.kept = ctx.params = None
        dx = None
        if ctx.x_grad:
            dx = (torch.cat(dxs) if chain.s == 0 else torch.zeros(
                (ctx.batch, *act[0][1:]), dtype=act[1], device=chain.device))
            if broadcast:
                dx = comms.psum(dx.float(), chain.mesh,
                                chain.axis).to(act[1])
        return (None, dx, *(grads[n][None] for n in names))


def _engine(keep: str, stage_fn, stacked: dict, x, *, mesh,
            num_microbatches: int, axis: str = "pp", extra=None,
            broadcast: bool = True, act=None):
    S = stage_count(mesh, axis)
    if S == 1:
        return sequential(stage_fn, stacked, x, extra)
    names = list(stacked)
    rows = {stacked[n].shape[0] for n in names}
    if rows != {1}:
        raise ValueError(f"pipeline over {axis}={S}: a rank holds one "
                         f"stage, got leaves of {rows} stages")
    if act is None:
        if x is None:
            raise ValueError("a stage without the input needs act=(shape, "
                             "dtype) of a microbatch's activation")
        act = ((x.shape[0] // num_microbatches, *x.shape[1:]), x.dtype)
    device = next(iter(stacked.values())).device
    chain = _Chain(mesh, axis, device, "eval" if keep == "none" else "train")
    spec = (stage_fn, names, chain, num_microbatches, act, extra, keep,
            broadcast)
    return _Pipeline.apply(spec, x, *(stacked[n] for n in names))


def gpipe(stage_fn, stacked: dict, x, *, mesh, num_microbatches: int,
          axis: str = "pp", extra=None, broadcast: bool = True, act=None):
    """``stage_{S-1}(... stage_0(x))`` as a GPipe pipeline over ``axis``.

    ``stage_fn(params, x[, extra_mb]) -> y`` runs ONE stage (shape and dtype
    preserving); ``stacked``: this rank's stage parameters, leaves ``[1,
    ...]`` (``[S, ...]`` on a one-rank axis, which runs :func:`sequential`);
    ``x``: the local batch ``[B, ...]``, read on stage 0 only (None
    elsewhere, with ``act = (microbatch shape, dtype)``); ``extra``: the
    per-row side input (a key-padding mask), each stage taking its
    microbatch's rows. Returns the last stage's output, on every rank of
    the axis with ``broadcast`` (else zeros off the last stage).
    Differentiable in ``x`` and ``stacked``: every rank of the axis must
    run the backward."""
    return _engine("graph", stage_fn, stacked, x, mesh=mesh,
                   num_microbatches=num_microbatches, axis=axis,
                   extra=extra, broadcast=broadcast, act=act)


def one_f_one_b(stage_fn, stacked: dict, x, *, mesh, num_microbatches: int,
                axis: str = "pp", extra=None, broadcast: bool = True,
                act=None):
    """:func:`gpipe`'s function with the 1F1B memory profile: the forward
    keeps each microbatch's stage input only (at most ``M``, no graph); the
    backward recomputes each stage forward from it in the reverse
    pipeline's order."""
    return _engine("input", stage_fn, stacked, x, mesh=mesh,
                   num_microbatches=num_microbatches, axis=axis,
                   extra=extra, broadcast=broadcast, act=act)


def forward_only(stage_fn, stacked: dict, x, *, mesh, num_microbatches: int,
                 axis: str = "pp", extra=None, broadcast: bool = True,
                 act=None):
    """The forward schedule alone, nothing kept (evaluation): the last
    stage's output, on every rank of the axis with ``broadcast``."""
    if stage_count(mesh, axis) == 1:
        return sequential(stage_fn, stacked, x, extra)
    with torch.no_grad():
        return _engine("none", stage_fn, stacked, x, mesh=mesh,
                       num_microbatches=num_microbatches, axis=axis,
                       extra=extra, broadcast=broadcast, act=act)


def interleaved_1f1b(embed_fn, stage_fn, head_fn, stacked: dict,
                     shared: dict, batch: dict, *, mesh,
                     num_microbatches: int, act, axis: str = "pp"):
    """TRUE interleaved 1F1B: ``(loss, (dstacked, dshared))``, the loss
    inside the schedule and the gradients out; nobody differentiates it
    from outside.

    ``embed_fn(shared, batch_mb) -> x_mb`` (stage 0), ``stage_fn(params,
    x) -> x``, ``head_fn(shared, y_mb, batch_mb) -> loss_mb`` (the last
    stage; the MICROBATCH's scalar loss). The loss is the mean of the
    microbatch losses, on every rank of the axis; ``dshared`` is summed over
    the axis (embed gradients from stage 0, head gradients from the last
    stage), ``dstacked`` is this rank's (leaves ``[1, ...]``). The mean over
    the batch axes is the caller's (the Trainer's gradient sync). ``act``:
    a microbatch's activation (shape, dtype).

    Schedule of stage ``s`` and microbatch ``m``: forward at tick ``s + m``;
    the last stage's loss and output cotangent at ``(S-1) + m``, in the
    same tick as its forward (its backward runs on that tick's graph);
    every other stage's backward at ``(S-1) + m + (S-1-s)``, recomputing
    its forward from a stash ring of depth ``2S``."""
    M, S = num_microbatches, stage_count(mesh, axis)
    shared_l = _leaves(shared)
    if S == 1:
        # Every stage here, one microbatch's graph at a time.
        stacked_l = _leaves(stacked)
        names = [*stacked_l, *shared_l]
        wrt = [*stacked_l.values(), *shared_l.values()]
        loss, grads = torch.zeros((), dtype=torch.float32,
                                  device=wrt[0].device), None
        for m in range(M):
            bm = _tree_microbatch(batch, m, M)
            with torch.enable_grad():
                y = sequential(stage_fn, stacked_l, embed_fn(shared_l, bm))
                loss_m = head_fn(shared_l, y, bm) / M
            grads = _accumulate(grads, names, torch.autograd.grad(
                loss_m, wrt, allow_unused=True))
            loss = loss + loss_m.detach().float()
        grads = {n: grads.get(n, torch.zeros_like(w))
                 for n, w in zip(names, wrt)}
        return loss, ({k: grads[k] for k in stacked_l},
                      {k: grads[k] for k in shared_l})
    device = next(iter(stacked.values())).device
    chain = _Chain(mesh, axis, device)
    s = chain.s
    params = _leaves(_row(stacked, 0))
    p_names, sh_names = list(params), list(shared_l)
    depth = 2 * S  # an input lives at most 2(S-1) + 1 ticks
    stash = [None] * depth
    loss = torch.zeros((), dtype=torch.float32, device=device)
    dstage = dshared = None
    recv_f = recv_b = None
    inv_m = torch.tensor(1.0 / M, dtype=torch.float32, device=device)
    for t in range(M + 2 * (S - 1)):
        # ---- forward unit: microbatch t - s --------------------------
        mf = t - s
        y = dx = None
        if 0 <= mf < M:
            bm = _tree_microbatch(batch, mf, M)
            if s == 0:
                with torch.no_grad():
                    x_in = embed_fn(shared_l, bm)
            else:
                x_in = recv_f
            if s < S - 1:
                stash[mf % depth] = x_in
                TICKS["max_stash"] = max(
                    TICKS["max_stash"], sum(x is not None for x in stash))
                with torch.no_grad():
                    y = stage_fn(params, x_in)
            else:
                # The last stage: its microbatch's loss and the backward
                # through the head and the stage, in this tick.
                x_r = x_in.detach().requires_grad_()
                with torch.enable_grad():
                    y_r = stage_fn(params, _entry(x_r))
                    loss_m = head_fn(shared_l, y_r, bm)
                wrt = [*(params[n] for n in p_names),
                       *(shared_l[n] for n in sh_names), x_r]
                got = torch.autograd.grad(loss_m, wrt,
                                          inv_m.to(loss_m.dtype),
                                          allow_unused=True)
                loss = loss + loss_m.detach().float()
                dstage = _accumulate(dstage, p_names, got[:len(p_names)])
                dshared = _accumulate(dshared, sh_names,
                                      got[len(p_names):-1])
                dx = got[-1]
        # ---- backward unit: microbatch t - 2(S-1) + s ------------------
        mb = t - 2 * (S - 1) + s
        if s < S - 1 and 0 <= mb < M:
            x_b = stash[mb % depth].detach().requires_grad_()
            stash[mb % depth] = None
            with torch.enable_grad():
                y_b = stage_fn(params, _entry(x_b))
            got = torch.autograd.grad(y_b, [*(params[n] for n in p_names),
                                            x_b], recv_b.to(y_b.dtype),
                                      allow_unused=True)
            dstage = _accumulate(dstage, p_names, got[:-1])
            dx = got[-1]
            if s == 0:
                # The cotangent leaves the pipeline into the embedding.
                bm_b = _tree_microbatch(batch, mb, M)
                with torch.enable_grad():
                    x_e = embed_fn(shared_l, bm_b)
                got = torch.autograd.grad(
                    x_e, [shared_l[n] for n in sh_names], dx.to(x_e.dtype),
                    allow_unused=True)
                dshared = _accumulate(dshared, sh_names, got)
        below = 0 <= t - (s - 1) < M
        above = s < S - 1 and 0 <= t - 2 * (S - 1) + s + 1 < M
        recv_f, recv_b = chain.exchange(
            up=y, down=dx, from_below=act if below else None,
            from_above=act if above else None)
    dstage, dshared = dstage or {}, dshared or {}
    dstage = {n: dstage.get(n, torch.zeros_like(params[n]))[None]
              for n in p_names}
    dshared = {n: dshared.get(n, torch.zeros_like(shared_l[n]))
               for n in sh_names}
    names = list(dshared)
    summed = comms.psum_tensors([loss, *(dshared[n] for n in names)],
                                mesh, axis)
    loss = summed[0] / M
    return loss, (dstage, dict(zip(names, summed[1:])))
