"""Shared by ``tests/test_torch_grad_comm.py`` and
``tests/test_torch_multislice.py``: the port's Trainer under the explicit
data-parallel sync on gloo ranks, and its reference composed of JAX pieces.

JAX's own ``Trainer`` cannot run its ``shard_map`` step paths on this jax
(flax's sharding constraints inside ``shard_map`` refuse the manual axes),
so the reference is put together from what does run: per-rank
``jax.value_and_grad`` of the JAX model's loss (``Trainer._loss_and_updates``)
on that rank's rows, JAX's own sync function (``comms_quant``,
``comms_overlap``, ``comms_hier``) under ``shard_map`` on 4 CPU devices, and
JAX's ``make_optimizer`` update — replicated after the sync, or on each
member's flat shard inside it under the sharded update, as the reference's
``_quantized_dp_step_fn`` and ``_overlapped_dp_step_fn`` do.
"""

from __future__ import annotations

import numpy as np
import torch

import torch_sharded as ts

N = 4
STEPS = 3
BUCKET_MB = 0.05  # the tiny GPT-2's 120k parameters in about 10 buckets
BLOCK = 256
# The sharded update refuses weight decay and the clip (the reference's
# fences); the replicated paths keep them, so the clip is load-bearing.
SHARDED_OPT = dict(weight_decay=0.0, grad_clip=0.0)


def opt_kw(case: dict) -> dict:
    return (SHARDED_OPT if case.get("update_sharding") == "sharded"
            else ts.OPT)


def trainer_kw(case: dict) -> dict:
    return {k: case[k] for k in ("grad_comm", "grad_bucket_mb",
                                 "update_sharding", "dcn_dp")
            if k in case}


def _host_residual(res):
    if res is None:
        return None
    if isinstance(res, tuple):
        return tuple(r.detach().clone() for r in res)
    return {k: v.detach().clone() for k, v in res.items()}


def port_case(case: dict, mesh, init: dict, steps: int = STEPS) -> dict:
    """``steps`` steps of the tiny GPT-2 under ``case`` on this rank of
    ``mesh`` from ``init``: losses, the whole params, this rank's
    residual."""
    from distributeddeeplearning_tpu_torch import data, models, train

    model = models.get_model("gpt2", **ts.MODEL, attn_impl="xla", mesh=mesh)
    tx = train.make_optimizer(case.get("optim", "adamw"), ts.LR,
                              **opt_kw(case))
    trainer = train.Trainer(model, tx, train.get_task("lm", mesh=mesh),
                            device="cpu", mesh=mesh,
                            zero1=case.get("zero1", False),
                            **trainer_kw(case))
    state = trainer.init(0)
    ts.load_whole(state, init)
    ds = data.SyntheticTokens(**ts.DATA)
    losses = []
    for _, batch in zip(range(steps),
                        data.sharded_batches(ds.iter_from(0), mesh)):
        state, m = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": {k: v.detach().clone()
                       for k, v in state.params.items()},
            "residual": _host_residual(state.grad_residual),
            "state": state, "trainer": trainer}


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:N]), ("dp",))


def jax_sync(case: dict, params, tx, *, n=N):
    """JAX's sync step of ``case`` under ``shard_map`` over ``n`` CPU
    devices: ``(fn, init_residual, init_opt)``. ``fn(grads, residual,
    opt_state, params)`` takes every member's gradients stacked ``[n,
    ...]`` and returns ``(new params, new residual, new opt_state)``."""
    import jax
    import jax.numpy as jnp
    import optax
    from distributeddeeplearning_tpu import comms_hier as ch
    from distributeddeeplearning_tpu import comms_overlap as co
    from distributeddeeplearning_tpu import comms_quant as cq
    from distributeddeeplearning_tpu.utils import compat
    from jax.sharding import PartitionSpec as P

    mode = case.get("grad_comm", "fp32")
    lossy = mode != "fp32"
    bucket_mb = case.get("grad_bucket_mb", 0.0)
    sharded = case.get("update_sharding") == "sharded"
    dcn = case.get("dcn_dp", 1)
    topo = ch.HierTopology(n=n, dcn=dcn) if dcn > 1 else None
    overlap = bucket_mb > 0 or sharded or topo is not None
    layout = (co.build_bucket_layout(params, bucket_mb, n_members=n,
                                     block_size=BLOCK) if overlap else None)
    first = lambda t: jax.tree.map(lambda x: x[0], t)  # noqa: E731
    lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
    if not lossy:
        residual = ()
    elif overlap:
        residual = co.zeros_bucket_residuals(layout, n)
    else:
        residual = jax.tree.map(lambda p: jnp.zeros((n, *p.shape)), params)
    if topo is not None:
        def all_reduce(g, r):
            return ch.bucketed_hier_all_reduce(g, layout, "dp", topo,
                                               mode=mode, block_size=BLOCK,
                                               residuals=r)

        def reduce_scatter(g, r):
            return ch.bucketed_hier_reduce_scatter(
                g, layout, "dp", topo, mode=mode, block_size=BLOCK,
                residuals=r)

        def gather(s):
            return ch.hier_all_gather_buckets(s, layout, "dp", topo)

        def index(i):
            return topo.chunk_index(i)
    else:
        def all_reduce(g, r):
            return co.bucketed_all_reduce(g, layout, "dp", mode=mode,
                                          block_size=BLOCK, residuals=r)

        def reduce_scatter(g, r):
            return co.bucketed_reduce_scatter(g, layout, "dp", mode=mode,
                                              block_size=BLOCK, residuals=r)

        def gather(s):
            return co.all_gather_buckets(s, layout, "dp")

        def index(i):
            return i

    if sharded:
        opt = tx.init(layout.stacked_shards(params))
        opt_specs = jax.tree.map(
            lambda a: P("dp") if getattr(a, "ndim", 0) == 2 else P(), opt)

        def body(g, r, opt_state, params):
            res = [x[0] for x in r] if lossy else None
            shards, nr = reduce_scatter(first(g), res)
            shards = tuple(s / n for s in shards)
            i = index(jax.lax.axis_index("dp"))
            pshards = layout.local_shards(params, i)
            local = jax.tree.map(lambda x: x[0] if x.ndim == 2 else x,
                                 opt_state)
            upd, new_opt = tx.update(shards, local, pshards)
            new_params = gather(optax.apply_updates(pshards, upd))
            new_opt = jax.tree.map(lambda x: x[None] if x.ndim == 1 else x,
                                   new_opt)
            return (new_params, tuple(x[None] for x in nr) if lossy else (),
                    new_opt)

        fn = jax.jit(compat.shard_map(
            body, mesh=_jax_mesh(), in_specs=(P("dp"), P("dp"), opt_specs,
                                              P()),
            out_specs=(P(), P("dp"), opt_specs), check_vma=False))
        return fn, residual, opt

    def body(g, r):
        if overlap:
            res = [x[0] for x in r] if lossy else None
            summed, nr = all_reduce(first(g), res)
            nr = tuple(x[None] for x in nr) if lossy else ()
        else:
            summed, nr = cq.quantized_tree_all_reduce(
                first(g), "dp", mode=mode, block_size=BLOCK,
                residual=first(r))
            nr = lead(nr)
        return jax.tree.map(lambda x: x / n, summed), nr

    sync = jax.jit(compat.shard_map(
        body, mesh=_jax_mesh(), in_specs=(P("dp"), P("dp")),
        out_specs=(P(), P("dp")), check_vma=False))

    def fn(g, r, opt_state, params):
        grads, nr = sync(g, r)
        upd, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), nr, opt_state

    return fn, residual, tx.init(params)


_VG: dict = {}


def _value_and_grad(trainer):
    """The jitted loss-and-gradient of ``trainer``'s model (one compile per
    model, shared by the cases: the loss does not read the optimizer)."""
    import jax

    key = (type(trainer.model).__name__, hash(trainer.model))
    if key not in _VG:
        rng = jax.random.PRNGKey(0)

        def loss(p, ms, b):
            return trainer._loss_and_updates(p, ms, b, rng, True)

        _VG[key] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return _VG[key]


def jax_composed(case: dict, trainer, tx, params, model_state,
                 rank_batches, steps: int = STEPS, n: int = N) -> dict:
    """The reference of ``case``: for each step, every rank's loss and
    gradient on its rows (``rank_batches[step][rank]``), the running
    statistics' updates averaged over the ranks, JAX's sync and update.
    Returns the losses (the ranks' mean), the params, each member's
    residual (host arrays) and the final model_state."""
    import jax
    import jax.numpy as jnp

    vg = _value_and_grad(trainer)
    fn, residual, opt = jax_sync(case, params, tx, n=n)
    losses = []
    for step in range(steps):
        outs = [vg(params, model_state, b) for b in rank_batches[step]]
        losses.append(float(np.mean([float(o[0][1][0]["loss"])
                                     for o in outs])))
        grads = jax.tree.map(lambda *g: jnp.stack(g), *[o[1] for o in outs])
        if model_state:
            model_state = jax.tree.map(
                lambda *u: jnp.mean(jnp.stack(u), 0),
                *[o[0][1][1] for o in outs])
        params, residual, opt = fn(grads, residual, opt, params)
    return {"losses": losses, "params": params,
            "residual": jax.tree.map(np.asarray, residual),
            "model_state": model_state}


def gpt2_reference(case: dict, init: dict, steps: int = STEPS,
                   n: int = N) -> dict:
    """:func:`jax_composed` on the tiny GPT-2 from ``init`` with the
    ``SyntheticTokens`` batches the port's ranks draw."""
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import (
        Trainer,
        get_task,
        make_optimizer,
    )

    model = jmodels.get_model("gpt2", **ts.MODEL)
    # The port's adamw_fused is held to AdamW's math: JAX's plain AdamW.
    name = "adamw" if case.get("optim") == "adamw_fused" else case.get(
        "optim", "adamw")
    tx = make_optimizer(name, ts.LR, **opt_kw(case))
    trainer = Trainer(model, tx, get_task("lm"), single_device_mesh(),
                      donate=False)
    ds = jdata.SyntheticTokens(**ts.DATA)
    rows = ts.DATA["batch_size"] // n
    batches = [[{k: v[r * rows:(r + 1) * rows] for k, v in
                 ds.batch(i).items()} for r in range(n)]
               for i in range(steps)]
    out = jax_composed(case, trainer, tx, ts.jax_tree(init), {}, batches,
                       steps, n)
    out["params"] = ts.flat_numpy(out["params"])
    return out


def residual_rows(ref_residual, like, rank: int):
    """Member ``rank``'s residual of a reference in the port's structure:
    a tuple of buckets, or a dict of the port's names and layout."""
    from distributeddeeplearning_tpu_torch.comms_quant import (
        from_jax_layout,
        jax_path,
    )

    if isinstance(like, tuple):
        return tuple(np.asarray(r)[rank] for r in ref_residual)
    out = {}
    for k in like:
        node = ref_residual
        for p in jax_path(k):
            node = node[p]
        out[k] = from_jax_layout(k, torch.from_numpy(
            np.array(node[rank]))).contiguous().numpy()
    return out


def assert_params_close(got: dict, want: dict, steps: int = STEPS):
    """Params within 2e-5 on all but 0.1% of the elements, none further
    than ``2 * steps * lr`` (an element on a rounding edge may take Adam
    steps of the other sign)."""
    assert set(got) == set(want)
    far, total = 0, 0
    for k, v in want.items():
        g, w = _np(got[k]), _np(v)
        assert g.shape == w.shape, k
        d = np.abs(g - w)
        assert d.max() <= 2 * steps * ts.LR, (k, d.max())
        far += int((d > 2e-5).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)


def assert_residuals_close(got: list, want: list):
    """Residuals within 1e-6 + 1e-3 relative on all but 1% of the elements,
    none further than twice the tensor's largest residual."""
    far, total = 0, 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        d = np.abs(g - w)
        assert d.max() <= 2 * np.abs(w).max() + 1e-6, d.max()
        far += int((d > 1e-6 + 1e-3 * np.abs(w)).sum())
        total += d.size
    assert far <= 1e-2 * total, (far, total)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
