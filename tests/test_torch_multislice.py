"""The port's data parallelism across slices (``mesh.dcn_dp``): the
hierarchical collectives, the Trainer over them, the sharded update's
checkpoint and ``cli launch``, against the JAX package.

One spawn of 4 gloo ranks (``torch_sharded.spawn``) at dp=4 in 2 slices of
2 (``mesh.build_mesh`` makes the ``dp_intra`` and ``dp_cross`` groups), with
JAX's references computed in the parent meanwhile:

- ``hier_psum``, ``hier_psum_scatter``, ``hier_all_gather``,
  ``hier_quantized_all_reduce_flat``, ``hier_quantized_reduce_scatter_flat``
  and the bucketed trio (``bucketed_hier_all_reduce``,
  ``bucketed_hier_reduce_scatter``, ``hier_all_gather_buckets``) against
  JAX's under ``shard_map`` on 4 CPU devices: int8 and bf16 bit for bit,
  fp32 within 1e-6 relative;
- the Trainer, 3 steps of the tiny GPT-2: int8 hierarchical bucketed with
  the sharded update, fp32 hierarchical sharded, against the reference
  composed of JAX pieces (``torch_dp_sync``; its tolerances), the fp32 one
  also against JAX's plain-dp Trainer; a tiny ResNet-18 on the flat
  bucketed sync, which holds the ``pmean`` of BatchNorm's running
  statistics;
- the health guard over the sharded update (a poisoned step skipped bit
  for bit: params, flat-shard moments, residuals) and 2 steps a call
  equal to 2 calls;
- the sharded update's checkpoint: int8 bucketed sharded saved at step 2
  and resumed to 4 in a fresh trainer equals 4 steps straight bit for bit
  (params, moments, residuals); a restore into another bucket layout is
  refused by name.

Beside it: ``cli launch`` (the plan and its env, the prefixed streams, one
real launch of 2 CPU ranks at ``grad_comm=int8`` whose ranks report equal
losses, with JAX blocked in the children), ``HierTopology``, the mesh's
refusals, ``phase_wire_bytes``.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_sync as ds
import torch_sharded as ts

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, DCN = 4, 2
BLOCK = 64
LEN = N * BLOCK * 3
MODES = ("int8", "bf16", "fp32")
CASES = {
    "int8_hier_sharded": dict(grad_comm="int8", grad_bucket_mb=ds.BUCKET_MB,
                              update_sharding="sharded", dcn_dp=DCN),
    "fp32_hier_sharded": dict(update_sharding="sharded", dcn_dp=DCN),
}
CKPT_CASE = dict(grad_comm="int8", grad_bucket_mb=ds.BUCKET_MB,
                 update_sharding="sharded")
RESNET = "distributeddeeplearning_tpu_torch/configs/resnet18_cifar10.py"
# test_torch_resnet_train.py's tiny ResNet-18 (SGD with momentum, label
# smoothing), bucketed, for the running statistics' pmean.
RESNET_TINY = ["model.kwargs.width=8", "data.batch_size=16",
               "data.image_size=16", "data.n_distinct=4", "optim.lr=0.05",
               "optim.warmup_steps=2", "optim.weight_decay=1e-4",
               "train.label_smoothing=0.1", f"train.steps={ds.STEPS}",
               "mesh.dp=4", f"train.grad_bucket_mb={ds.BUCKET_MB}"]
GPT2 = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
LAUNCH = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
          "model.kwargs.max_len=64", "data.vocab_size=256",
          "data.seq_len=32", "data.batch_size=8", "train.steps=2",
          "train.log_every=1", "optim.warmup_steps=0",
          "train.grad_comm=int8", "train.grad_bucket_mb=0.05"]


def _inputs():
    rng = np.random.default_rng(30)
    flat = rng.standard_normal((N, LEN)).astype(np.float32)
    flat *= rng.uniform(1e-3, 10.0, (N, LEN // BLOCK, 1)).repeat(
        BLOCK, 2).reshape(N, LEN).astype(np.float32)
    flat[:, BLOCK:2 * BLOCK] = 0.0
    tree = {"h.block_10.attn.kernel": (6, 9), "h.block_2.attn.kernel": (6, 9),
            "conv.weight": (4, 2, 3, 3), "ln.scale": (31,)}
    trees = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in tree.items()} for _ in range(N)]
    res = [rng.standard_normal(N * 2 * BLOCK).astype(np.float32) * 1e-2
           for _ in range(N)]
    return {"flat": flat, "trees": trees, "res": res}


# ---------------------------------------------------------------------------
# The port on the ranks
# ---------------------------------------------------------------------------


def _collectives(rank, mesh, inp) -> dict:
    from distributeddeeplearning_tpu_torch import comms_hier as ch
    from distributeddeeplearning_tpu_torch import comms_overlap as co

    topo = ch.HierTopology(n=N, dcn=DCN)
    flat = torch.from_numpy(inp["flat"][rank])
    tree = {k: torch.from_numpy(v) for k, v in inp["trees"][rank].items()}
    layout = co.build_bucket_layout(tree, 0.0003, n_members=N,
                                    block_size=BLOCK)
    res = tuple(torch.from_numpy(inp["res"][rank][:p].copy())
                for p in layout.padded_sizes)
    out = {"psum": ch.hier_psum(flat, mesh, topo),
           "psum_scatter": ch.hier_psum_scatter(flat, mesh, topo)}
    out["all_gather"] = ch.hier_all_gather(out["psum_scatter"], mesh, topo)
    for mode in MODES:
        if mode != "fp32":
            out[f"qar_{mode}"] = ch.hier_quantized_all_reduce_flat(
                flat, mesh, topo, mode=mode, block_size=BLOCK)
            out[f"qrs_{mode}"] = ch.hier_quantized_reduce_scatter_flat(
                flat, mesh, topo, mode=mode, block_size=BLOCK)
        out[f"bar_{mode}"] = ch.bucketed_hier_all_reduce(
            tree, layout, mesh, topo, mode=mode, block_size=BLOCK,
            residuals=res)
        shards, r = ch.bucketed_hier_reduce_scatter(
            tree, layout, mesh, topo, mode=mode, block_size=BLOCK,
            residuals=res)
        out[f"brs_{mode}"] = (shards, r)
        out[f"bag_{mode}"] = ch.hier_all_gather_buckets(shards, layout, mesh,
                                                        topo)
    return out


def _resnet_cfg():
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    return apply_overrides(load_config(RESNET), RESNET_TINY)


def _resnet(mesh, init) -> dict:
    from distributeddeeplearning_tpu_torch import cli, data, train
    from distributeddeeplearning_tpu_torch.weights import (
        from_jax_params,
        to_torch_layout,
    )

    cfg = _resnet_cfg()
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(cfg.train.seed)
    params = to_torch_layout(from_jax_params(init["params"]),
                             set(state.params))
    stats = from_jax_params(init["batch_stats"])
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
        for k, b in state.model_state.items():
            b.copy_(stats[k])
    state, hist = train.fit(trainer, state, data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), "cpu"),
        steps=ds.STEPS, log_every=1, log_fn=lambda m: None)
    return {"losses": [r["loss"] for r in hist],
            "params": {k: p.detach().clone() for k, p in
                       state.params.items()},
            "stats": {k: b.detach().clone() for k, b in
                      state.model_state.items()}}


def _snapshot(state) -> dict:
    from distributeddeeplearning_tpu_torch.train import opt_state_trees

    return {"params": {k: p.detach().clone() for k, p in
                       state.params.items()},
            "opt": {n: {k: v.clone() for k, v in t.items()}
                    for n, t in opt_state_trees(state.opt_state).items()},
            "residual": tuple(r.clone() for r in state.grad_residual),
            "count": state.opt_state.count, "step": state.step}


def _checkpoint(mesh, init, tmp) -> dict:
    """4 steps straight, then 2 steps saved and resumed to 4 in a fresh
    trainer; and a restore into another bucket layout."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    straight = ds.port_case(CKPT_CASE, mesh, init, steps=4)["state"]
    half = ds.port_case(CKPT_CASE, mesh, init, steps=2)["state"]
    with CheckpointManager(os.path.join(tmp, "ck")) as ckpt:
        ckpt.save(2, half, {"next_index": 2})
    torch.distributed.barrier()  # rank 0's write is on disk
    fresh = ds.port_case(CKPT_CASE, mesh, init, steps=0)
    trainer = fresh["trainer"]
    with CheckpointManager(os.path.join(tmp, "ck")) as ckpt:
        state, _ = ckpt.restore(fresh["state"])
    for batch in itertools.islice(data.sharded_batches(
            data.SyntheticTokens(**ts.DATA).iter_from(0), mesh), 2, 4):
        state, _ = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    other = ds.port_case({**CKPT_CASE, "grad_bucket_mb": 0.0}, mesh, init,
                         steps=0)["state"]
    try:
        with CheckpointManager(os.path.join(tmp, "ck")) as ckpt:
            ckpt.restore(other)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"straight": _snapshot(straight), "resumed": _snapshot(state),
            "refused": refused}


def _guard_and_fused(mesh, init) -> dict:
    """int8 hierarchical bucketed sharded, the health guard on and step 1's
    gradients poisoned (``fault_nan_step=1``): the state before and after
    that step; and 2 steps in one call (``steps_per_call=2``) against 2
    calls of one step."""
    from distributeddeeplearning_tpu_torch import config, data, models, train

    def trainer(**kw):
        model = models.get_model("gpt2", **ts.MODEL, attn_impl="xla",
                                 mesh=mesh)
        tr = train.Trainer(
            model, train.make_optimizer("adamw", ts.LR, **ds.SHARDED_OPT),
            train.get_task("lm", mesh=mesh), device="cpu", mesh=mesh,
            **ds.trainer_kw(CASES["int8_hier_sharded"]), **kw)
        state = tr.init(0)
        ts.load_whole(state, init)
        return tr, state

    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in itertools.islice(data.sharded_batches(
                   data.SyntheticTokens(**ts.DATA).iter_from(0), mesh), 2)]
    tr, state = trainer(health=config.HealthConfig(enabled=True),
                        fault_nan_step=1)
    state, m0 = tr.train_step(state, batches[0])
    before = _snapshot(state)
    state, m1 = tr.train_step(state, batches[1])
    out = {"before": before, "after": _snapshot(state),
           "skipped": [int(m0["skipped"]), int(m1["skipped"])],
           "grad_norm": [float(m0["grad_norm"]), float(m1["grad_norm"])]}
    tr, state = trainer()
    for b in batches:
        state, _ = tr.train_step(state, b)
    out["single"] = _snapshot(state)
    tr, state = trainer()
    state, _ = tr.fused_train_step(2)(state, {
        k: torch.stack([b[k] for b in batches]) for k in batches[0]})
    out["fused"] = _snapshot(state)
    return out


def _worker(rank, world, port, tmp, inputs, init, resnet_init):
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    hier = build_mesh(MeshConfig(dp=N, dcn_dp=DCN))
    out = {"collectives": _collectives(rank, hier, inputs),
           "groups": sorted(hier.comm.groups)}
    for name, case in CASES.items():
        got = ds.port_case(case, hier, init)
        out[name] = {k: got[k] for k in ("losses", "params", "residual")}
    out["guard"] = _guard_and_fused(hier, init)
    flat = build_mesh(MeshConfig(dp=N))
    out["resnet"] = _resnet(flat, resnet_init)
    out["checkpoint"] = _checkpoint(flat, init, tmp)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX's references (the parent)
# ---------------------------------------------------------------------------


def _nest(flat: dict) -> dict:
    import jax.numpy as jnp

    from distributeddeeplearning_tpu_torch.comms_quant import (
        jax_path,
        to_jax_layout,
    )

    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = jax_path(k)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(to_jax_layout(
            k, torch.from_numpy(np.asarray(v))).numpy())
    return out


def _unnest(tree, like) -> dict:
    from distributeddeeplearning_tpu_torch.comms_quant import (
        from_jax_layout,
        jax_path,
    )

    out = {}
    for k in like:
        node = tree
        for p in jax_path(k):
            node = node[p]
        out[k] = from_jax_layout(k, torch.from_numpy(
            np.array(node))).contiguous().numpy()
    return out


def jax_collectives(inp) -> dict:
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import comms_hier as ch
    from distributeddeeplearning_tpu import comms_overlap as co
    from distributeddeeplearning_tpu.utils import compat
    from jax.sharding import PartitionSpec as P

    mesh = ds._jax_mesh()
    topo = ch.HierTopology(n=N, dcn=DCN)

    def sm(fn, n_in=1, n_out=1):
        return jax.jit(compat.shard_map(
            fn, mesh=mesh, in_specs=(P("dp"),) * n_in,
            out_specs=P("dp") if n_out == 1 else (P("dp"),) * n_out,
            check_vma=False))

    like = inp["trees"][0]
    trees = jax.tree.map(lambda *x: jnp.stack(x),
                         *[_nest(t) for t in inp["trees"]])
    layout = co.build_bucket_layout(_nest(like), 0.0003, n_members=N,
                                    block_size=BLOCK)
    res = tuple(jnp.stack([r[:p] for r in inp["res"]])
                for p in layout.padded_sizes)
    flat = jnp.asarray(inp["flat"].reshape(-1))
    first = lambda t: jax.tree.map(lambda x: x[0], t)  # noqa: E731
    lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
    rows = lambda x: np.asarray(x).reshape(N, -1)  # noqa: E731
    got = {"psum": rows(sm(lambda f: ch.hier_psum(f, "dp", topo))(flat))}
    scat = sm(lambda f: ch.hier_psum_scatter(f, "dp", topo))(flat)
    got["psum_scatter"] = rows(scat)
    got["all_gather"] = rows(sm(lambda s: ch.hier_all_gather(
        s, "dp", topo))(scat))
    for mode in MODES:
        if mode != "fp32":
            got[f"qar_{mode}"] = rows(sm(
                lambda f: ch.hier_quantized_all_reduce_flat(
                    f, "dp", topo, mode=mode, block_size=BLOCK))(flat))
            got[f"qrs_{mode}"] = rows(sm(
                lambda f: ch.hier_quantized_reduce_scatter_flat(
                    f, "dp", topo, mode=mode, block_size=BLOCK))(flat))

        def bar(g, r):
            s, nr = ch.bucketed_hier_all_reduce(
                first(g), layout, "dp", topo, mode=mode, block_size=BLOCK,
                residuals=[x[0] for x in r])
            return lead(s), tuple(x[None] for x in nr)

        def brs(g, r):
            s, nr = ch.bucketed_hier_reduce_scatter(
                first(g), layout, "dp", topo, mode=mode, block_size=BLOCK,
                residuals=[x[0] for x in r])
            back = ch.hier_all_gather_buckets(s, layout, "dp", topo)
            return s, tuple(x[None] for x in nr), lead(back)

        got[f"bar_{mode}"] = sm(bar, 2, 2)(trees, res)
        got[f"brs_{mode}"] = jax.jit(compat.shard_map(
            brs, mesh=mesh, in_specs=(P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False))(
            trees, res)
    out = {r: {} for r in range(N)}
    member = lambda t, r: jax.tree.map(  # noqa: E731
        lambda x: np.asarray(x)[r], t)
    for r in range(N):
        o = out[r]
        for k in ("psum", "psum_scatter", "all_gather",
                  *(f"q{op}_{m}" for op in ("ar", "rs")
                    for m in ("int8", "bf16"))):
            o[k] = got[k][r]
        for mode in MODES:
            bar, brs = got[f"bar_{mode}"], got[f"brs_{mode}"]
            o[f"bar_{mode}"] = (_unnest(member(bar[0], r), like),
                                tuple(np.asarray(x)[r] for x in bar[1]))
            o[f"brs_{mode}"] = (tuple(rows(s)[r] for s in brs[0]),
                                tuple(np.asarray(x)[r] for x in brs[1]))
            o[f"bag_{mode}"] = _unnest(member(brs[2], r), like)
    return out


def _jax_resnet():
    """(JAX Trainer on one device, tx, init params and statistics as host
    arrays, the dataset) of the tiny ResNet-18 config."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import (
        Trainer,
        get_task,
        make_optimizer,
    )

    cfg = _resnet_cfg()
    o = cfg.optim
    tx = make_optimizer(o.name, o.lr, momentum=o.momentum,
                        weight_decay=o.weight_decay,
                        warmup_steps=o.warmup_steps, schedule=o.schedule,
                        total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    trainer = Trainer(jmodels.get_model(cfg.model.name, **cfg.model.kwargs),
                      tx, get_task("classification", label_smoothing=(
                          cfg.train.label_smoothing)),
                      single_device_mesh(), donate=False)
    dataset = jdata.SyntheticImages(**cfg.data.dataset_kwargs())
    state = trainer.init(0, dataset.batch(0))
    host = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.model_state}))
    return trainer, tx, host, dataset


def _resnet_reference(trainer, tx, host, dataset) -> dict:
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.weights import (
        from_jax_params,
        to_torch_layout,
    )

    rows = 16 // N
    batches = [[{k: v[r * rows:(r + 1) * rows]
                 for k, v in dataset.batch(i).items()} for r in range(N)]
               for i in range(ds.STEPS)]
    out = ds.jax_composed(
        dict(grad_bucket_mb=ds.BUCKET_MB), trainer, tx,
        jax.tree.map(jnp.asarray, host["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray, host["batch_stats"])},
        batches)
    cfg = _resnet_cfg()
    names = {k for k, _ in models.get_model(
        cfg.model.name, **cfg.model.kwargs).named_parameters()}
    return {"losses": out["losses"],
            "params": to_torch_layout(from_jax_params(jax.tree.map(
                np.asarray, out["params"])), names),
            "stats": from_jax_params(jax.tree.map(
                np.asarray, out["model_state"]["batch_stats"]))}


def _launch(tmp):
    """``cli launch --num-processes 2 --device cpu`` of the tiny GPT-2 at
    int8, the children's imports of JAX blocked (a ``sitecustomize`` on
    their path), started: a callable that waits for it and returns what it
    printed."""
    block = pathlib.Path(tmp) / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'distributeddeeplearning_tpu'):\n"
        "    sys.modules[m] = None\n")
    argv = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
            "launch", "--num-processes", "2", "--device", "cpu",
            "--sync-steps", "--config", GPT2]
    for o in LAUNCH + [f"train.log_dir={tmp}/logs"]:
        argv += ["--override", o]
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{ROOT}")
    env.pop("PYTEST_XDIST_WORKER", None)
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=240)
        return {"rc": proc.returncode, "out": out, "err": err}

    return wait


def _parent(inputs, init, resnet, tmp):
    import concurrent.futures

    launch = _launch(tmp)  # runs beside the references
    # ResNet's reference traces and compiles on a thread of its own, beside
    # GPT-2's (XLA compiles outside the GIL).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        resnet_ref = pool.submit(_resnet_reference, *resnet)
        out = {"collectives": jax_collectives(inputs)}
        for name, case in CASES.items():
            out[name] = ds.gpt2_reference(case, init)
        out["fp32_hier_sharded_plain"] = ts.jax_run(
            "gpt2", init, ds.STEPS,
            opt=ds.opt_kw(CASES["fp32_hier_sharded"]))
        out["resnet"] = resnet_ref.result()
    out["launch"] = launch()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs, init = _inputs(), ts.port_init("gpt2")
    resnet = _jax_resnet()
    tmp = tmp_path_factory.mktemp("ms")
    ranks, ref = ts.spawn(_worker, N, tmp, inputs, init, resnet[2],
                          parent=lambda: _parent(inputs, init, resnet, tmp))
    return ranks, ref


# ---------------------------------------------------------------------------
# Hierarchical collectives
# ---------------------------------------------------------------------------


def _same(got, want, exact, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], exact, f"{what}[{k}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, exact, f"{what}[{i}]")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, what
    if exact:
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("op", [
    "psum", "psum_scatter", "all_gather", "qar_int8", "qar_bf16",
    "qrs_int8", "qrs_bf16", "bar_int8", "bar_bf16", "bar_fp32", "brs_int8",
    "brs_bf16", "brs_fp32", "bag_int8", "bag_bf16", "bag_fp32"])
def test_hier_collective_matches_jax(results, op):
    ranks, ref = results
    exact = "int8" in op or "bf16" in op
    for r in range(N):
        _same(ranks[r]["collectives"][op], ref["collectives"][r][op], exact,
              f"rank {r} {op}")


def test_the_mesh_holds_the_hierarchy_groups(results):
    ranks, _ = results
    for r in range(N):
        assert {"dp", "dp_intra", "dp_cross"} <= set(ranks[r]["groups"])


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_matches_the_jax_composition(results, name):
    ranks, ref = results
    for r in range(N):
        got = ranks[r][name]
        np.testing.assert_allclose(got["losses"], ref[name]["losses"],
                                   rtol=1e-5)
        ds.assert_params_close(got["params"], ref[name]["params"])
        for k, p in got["params"].items():
            assert torch.equal(p, ranks[0][name]["params"][k]), k


def test_int8_hier_residuals_match_the_jax_composition(results):
    ranks, ref = results
    for r in range(N):
        got = ranks[r]["int8_hier_sharded"]["residual"]
        want = ds.residual_rows(ref["int8_hier_sharded"]["residual"], got, r)
        assert any(np.any(g.numpy() != 0) for g in got)
        ds.assert_residuals_close([g.numpy() for g in got], want)


def test_fp32_hier_sharded_equals_plain_dp(results):
    ranks, ref = results
    want = ref["fp32_hier_sharded_plain"]
    np.testing.assert_allclose(ranks[0]["fp32_hier_sharded"]["losses"],
                               want["losses"], rtol=1e-5)
    ds.assert_params_close(ranks[0]["fp32_hier_sharded"]["params"],
                           want["params"])


def test_batchnorm_statistics_are_averaged_over_dp(results):
    """ResNet-18, bucketed: each rank normalizes by its own rows' statistics
    (the reference's forward runs per member under ``shard_map``), and the
    running statistics are their mean over dp after each step."""
    ranks, ref = results
    want = ref["resnet"]
    for r in range(N):
        got = ranks[r]["resnet"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        ts.assert_params_close(got["params"], want["params"], rtol=0,
                               atol=2e-5)
        ts.assert_params_close(got["stats"], want["stats"], rtol=1e-5,
                               atol=1e-6)


def _equal_snapshots(a, b, step_too=True):
    if step_too:
        assert a["step"] == b["step"]
    assert a["count"] == b["count"]
    for k, p in a["params"].items():
        assert torch.equal(p, b["params"][k]), k
    for n, tree in a["opt"].items():
        for k, v in tree.items():
            assert torch.equal(v, b["opt"][n][k]), (n, k)
    for x, y in zip(a["residual"], b["residual"]):
        assert torch.equal(x, y)


def test_guard_skips_a_poisoned_sharded_step_exactly(results):
    """The fault and the guard's norm on the flat shards (a psum of their
    squares): the poisoned step is skipped on every rank, leaving the
    params, the flat-shard moments and the residuals bit for bit."""
    ranks, _ = results
    for r in range(N):
        g = ranks[r]["guard"]
        assert g["skipped"] == [0, 1]
        assert np.isfinite(g["grad_norm"][0]) and g["grad_norm"][0] > 0
        assert not np.isfinite(g["grad_norm"][1])
        assert g["after"]["step"] == g["before"]["step"] + 1
        _equal_snapshots(g["before"], g["after"], step_too=False)


def test_two_steps_a_call_equal_two_calls(results):
    ranks, _ = results
    for r in range(N):
        _equal_snapshots(ranks[r]["guard"]["single"],
                         ranks[r]["guard"]["fused"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_sharded_int8_resume_is_bit_exact(results):
    ranks, _ = results
    for r in range(N):
        ck = ranks[r]["checkpoint"]
        a, b = ck["straight"], ck["resumed"]
        assert a["step"] == b["step"] == 4 and a["count"] == b["count"] == 4
        for k, p in a["params"].items():
            assert torch.equal(p, b["params"][k]), k
        for n, tree in a["opt"].items():
            for k, v in tree.items():
                assert torch.equal(v, b["opt"][n][k]), (n, k)
        for x, y in zip(a["residual"], b["residual"]):
            assert torch.equal(x, y)
        assert any(bool((x != 0).any()) for x in a["residual"])


def test_restore_into_another_bucket_layout_is_refused(results):
    ranks, _ = results
    for r in range(N):
        assert "grad_residual" in ranks[r]["checkpoint"]["refused"]
        assert "train.grad_bucket_mb" in ranks[r]["checkpoint"]["refused"]


# ---------------------------------------------------------------------------
# cli launch
# ---------------------------------------------------------------------------


def test_cli_launch_ranks_report_equal_losses(results):
    _, ref = results
    got = ref["launch"]
    assert got["rc"] == 0, got["err"][-2000:]
    lines = [line.split("] ", 1)[1] for line in got["out"].splitlines()
             if line.startswith("[p0] {")]
    end = json.loads(lines[-1])
    assert end["event"] == "train_end" and len(end["ranks"]) == 2
    a, b = (r["losses"] for r in end["ranks"])
    assert len(a) == 2 and a == b and all(np.isfinite(a))
    assert all(r["grad_residual_norm"] > 0 for r in end["ranks"])
    assert end["sync"]["grad_comm"] == "int8"
    assert end["sync"]["grad_buckets"] >= 2


def test_launch_plan_threads_the_rank_env():
    from distributeddeeplearning_tpu_torch import cli

    plan = cli._launch_plan("cfg.py", ["a.b=1"], 2, coordinator_port=12345,
                            base_env={"KEEP": "me"}, device="cpu")
    assert len(plan) == 2
    for pid, (cmd, env) in enumerate(plan):
        assert cmd[:5] == [sys.executable, "-m",
                           "distributeddeeplearning_tpu_torch.cli", "train",
                           "--config"]
        assert "a.b=1" in cmd and "--override" in cmd
        assert cmd[-2:] == ["--device", "cpu"]
        assert env["RANK"] == env["LOCAL_RANK"] == str(pid)
        assert env["WORLD_SIZE"] == env["LOCAL_WORLD_SIZE"] == "2"
        assert env["MASTER_ADDR"] == "localhost"
        assert env["MASTER_PORT"] == "12345"
        assert env["DDL_PROCESS_INDEX"] == str(pid)
        assert env["KEEP"] == "me"
    assert plan[0][0] == plan[1][0]


def test_launch_plan_defaults():
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.mesh import DistEnv

    plan = cli._launch_plan("c.py", [], 3, base_env={})
    ports = {env["MASTER_PORT"] for _, env in plan}
    assert len(ports) == 1 and 0 < int(ports.pop()) < 65536
    assert "--device" not in plan[0][0]  # the card, unless asked
    envs = [DistEnv.from_environ(env) for _, env in plan]
    assert [e.rank for e in envs] == [0, 1, 2]
    assert {e.world_size for e in envs} == {3}


def test_launch_plan_independent_mode():
    from distributeddeeplearning_tpu_torch import cli

    plan = cli._launch_plan(
        "cfg.py", [], 2, base_env={"RANK": "7", "MASTER_PORT": "1",
                                   "WORLD_SIZE": "9"}, independent=True)
    for pid, (_cmd, env) in enumerate(plan):
        assert env["DDL_PROCESS_INDEX"] == str(pid)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            assert k not in env


def test_launch_plan_rejects_single_process():
    from distributeddeeplearning_tpu_torch import cli

    with pytest.raises(ValueError, match="num-processes"):
        cli._launch_plan("c.py", [], 1)


def test_stream_prefixed_attributes_every_line():
    from distributeddeeplearning_tpu_torch import cli

    src = io.StringIO('step 1\n{"event": "save"}\n')
    out = io.StringIO()
    cli._stream_prefixed(src, "[p3] ", out)
    assert out.getvalue() == '[p3] step 1\n[p3] {"event": "save"}\n'


@pytest.mark.parametrize("flag", [["--devices-per-process", "2"],
                                  ["--xla-perf-flags"]])
def test_xla_only_launch_flags_are_refused_by_name(flag):
    from distributeddeeplearning_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.main(["launch", "--num-processes", "2", "--config", GPT2,
                  *flag])


# ---------------------------------------------------------------------------
# The topology and the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dcn", [(4, 2), (8, 2), (8, 4), (6, 3)])
def test_topology_matches_jax(n, dcn):
    from distributeddeeplearning_tpu import comms_hier as jch
    from distributeddeeplearning_tpu_torch import comms_hier as ch

    a, b = ch.HierTopology(n=n, dcn=dcn), jch.HierTopology(n=n, dcn=dcn)
    assert a.ici == b.ici
    assert a.intra_groups() == b.intra_groups()
    assert a.cross_groups() == b.cross_groups()
    assert a.intra_perm() == b.intra_perm()
    assert a.cross_perm() == b.cross_perm()
    assert [a.chunk_index(i) for i in range(n)] == [
        b.chunk_index(i) for i in range(n)]
    for p in (1000.0, 123456.0):
        assert ch.phase_wire_bytes(p, a) == jch.phase_wire_bytes(p, b)


@pytest.mark.parametrize("n,dcn,match", [
    (4, 1, "dcn >= 2"), (6, 4, "not divisible"), (4, 4, "ici_size=1")])
def test_topology_refusals_match_jax(n, dcn, match):
    from distributeddeeplearning_tpu import comms_hier as jch
    from distributeddeeplearning_tpu_torch import comms_hier as ch

    for mod in (ch, jch):
        with pytest.raises(ValueError, match=match):
            mod.HierTopology(n=n, dcn=dcn)


@pytest.mark.parametrize("mode,dcn", [("auto", 1), ("auto", 2),
                                      ("flat", 4), ("hierarchical", 2)])
def test_resolve_hierarchy_matches_jax(mode, dcn):
    from distributeddeeplearning_tpu import comms_hier as jch
    from distributeddeeplearning_tpu_torch import comms_hier as ch

    assert ch.resolve_hierarchy(mode, dcn) is jch.resolve_hierarchy(mode, dcn)


@pytest.mark.parametrize("dcn,match", [(0, "must be >= 1"),
                                       (3, "not divisible by dcn_dp=3")])
def test_mesh_refuses_a_dcn_dp_that_does_not_fit(dcn, match):
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import check_dcn

    with pytest.raises(ValueError, match=match):
        check_dcn(MeshConfig(dp=4, dcn_dp=dcn), {"dp": 4})


def test_flat_dcn_dp_composes_with_every_axis():
    """Under comm_hierarchy='flat', dcn_dp changes nothing but the numbering
    of the dp members: the config fences pass beside tp, fsdp and cp."""
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    cfg = apply_overrides(load_config(str(ROOT / GPT2)), [
        "mesh.dp=2", "mesh.tp=2", "mesh.fsdp=2", "mesh.dcn_dp=2",
        "train.comm_hierarchy=flat"])
    cli.check_train_composition(cfg, world_size=8)


def test_benchmark_sync_fields_match_jax():
    """``benchmark.sync_fields`` of the tiny GPT-2 at dp=4 in 2 slices, int8
    in buckets: the bucket count, each bucket's wire bytes, the bytes by
    phase and across slices, and the flat-ring model, as the JAX package's
    ``benchmark`` computes them."""
    from distributeddeeplearning_tpu import comms_hier as jch
    from distributeddeeplearning_tpu import comms_overlap as jco
    from distributeddeeplearning_tpu.parallel.fsdp import (
        grad_sync_bytes as jax_bytes,
    )
    from distributeddeeplearning_tpu_torch import benchmark, models, train
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    from test_torch_grad_comm import _jax_gpt2_params

    cfg = apply_overrides(load_config(str(ROOT / GPT2)), [
        "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
        "model.kwargs.max_len=64", "mesh.dp=4", "mesh.dcn_dp=2",
        "train.grad_comm=int8", "train.grad_bucket_mb=0.05"])
    mesh = Mesh({"dp": 4})
    model = models.get_model("gpt2", **ts.MODEL, mesh=mesh)
    trainer = train.Trainer(
        model, train.make_optimizer("adamw", 1e-3),
        train.get_task("lm", mesh=mesh), device="cpu", mesh=mesh,
        grad_comm="int8", grad_bucket_mb=0.05, dcn_dp=2)
    state = trainer.init(0)
    got = benchmark.sync_fields(cfg, trainer, state, mesh)
    params = _jax_gpt2_params()
    layout = jco.build_bucket_layout(params, 0.05, n_members=4)
    wire = list(layout.wire_bytes("int8"))
    phases = jch.phase_wire_bytes(sum(wire), jch.HierTopology(n=4, dcn=2))
    assert got == {
        "grad_comm": "int8", "update_sharding": "replicated",
        "grad_bucket_mb": 0.05, "comm_hierarchy": "hierarchical",
        "dcn_dp": 2, "grad_buckets": layout.num_buckets,
        "grad_bucket_wire_bytes": wire, "hier_phase_wire_bytes": phases,
        "dcn_wire_bytes": phases["cross_all_reduce_bytes"],
        "grad_sync_bytes_per_step": jax_bytes(params, mode="int8",
                                              n_members=4)}
