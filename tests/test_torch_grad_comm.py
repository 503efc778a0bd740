"""The port's compressed and bucketed gradient sync against the JAX package.

One spawn of 4 gloo ranks (``torch_sharded.spawn``), with JAX's references
computed in the parent meanwhile:

- **Collectives**: ``quantized_all_reduce_flat``,
  ``quantized_reduce_scatter_flat``, ``ef_compress``,
  ``quantized_tree_all_reduce`` and the bucketed trio
  (``bucketed_all_reduce``, ``bucketed_reduce_scatter``,
  ``all_gather_buckets``) on the same seeded numpy inputs as JAX's under
  ``shard_map`` on 4 CPU devices: int8 and bf16 bit for bit, fp32 within
  1e-6 relative (the sum's order differs). The tree holds a ``block_10``
  beside a ``block_2`` and torch-layout ``weight`` leaves (a conv's OIHW,
  a Dense's [out, in]), whose JAX ``kernel`` order and layout the ravel
  must follow.
- **The Trainer**: 3 steps of the tiny GPT-2 on dp=4 under each mode of
  :data:`CASES` against a reference composed of JAX pieces — per-rank
  ``jax.value_and_grad`` of JAX's GPT-2 loss on that rank's rows, JAX's
  sync function under ``shard_map``, JAX's ``make_optimizer`` update — and
  the fp32 modes also against JAX's plain-dp ``Trainer`` (which the
  reference documents them equal to). The hierarchical cases and the
  BatchNorm model are ``tests/test_torch_multislice.py``'s.
- **ZeRO-1 of SGD's trace** at dp=2 (ranks {0, 1}) against JAX's Trainer
  with ``zero1=True``.
- Single-process: the bucket layout against JAX's ``build_bucket_layout``
  on the tiny GPT-2 leaf for leaf, ``compression_ratio``, ``wire_bytes``,
  and every Trainer and config fence of the reference with its exception
  type and knob.

Tolerances of the Trainer's parity (``torch_dp_sync.assert_close``): the
port's and JAX's gradients agree to fp32 rounding, not bitwise, so a value
on a rounding edge of the codec (an int8 code, a bf16 rounding) or a
gradient element made of rounding alone (Adam turns it into a step of
either sign) can land apart. Losses: 1e-5 relative. Params: 2e-5 absolute
on all but 0.1% of the elements, none further than ``2 * steps * lr`` (what
two Adam runs can move apart). Residuals: 1e-6 absolute plus 1e-3 relative
on all but 1% of the elements, none further than twice the tensor's
largest residual (one quantum: a residual is at most half its block's).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

import torch_dp_sync as ds
import torch_sharded as ts

N = 4
BLOCK = 64
LEN = N * BLOCK * 3
MODES = ("int8", "bf16", "fp32")
BUCKET_MB = 0.0005  # ~131 fp32 elements: several buckets of the test tree
STEPS = 3
LR = 1e-3
# The port's names of the test tree and their shapes (torch layout): a
# level where "block_10" sorts before "block_2", and torch-layout leaves.
TREE = {
    "dense.bias": (7,), "dense.weight": (7, 5),
    "h.block_2.attn.kernel": (6, 9), "h.block_2.ln.scale": (9,),
    "h.block_10.attn.kernel": (6, 9), "h.block_10.ln.scale": (9,),
    "conv.weight": (4, 2, 3, 3), "a_first.embedding": (11, 4),
}


def _tree(rng, scale=1.0) -> dict:
    """One member's port tree: heavy-tailed values, one block of zeros."""
    out = {}
    for k, shape in TREE.items():
        v = rng.standard_t(3, size=shape).astype(np.float32) * scale
        out[k] = v
    out["h.block_2.ln.scale"][:] = 0.0
    return out


def _inputs():
    rng = np.random.default_rng(20)
    flat = rng.standard_normal((N, LEN)).astype(np.float32)
    flat *= rng.uniform(1e-3, 10.0, (N, LEN // BLOCK, 1)).repeat(
        BLOCK, 2).reshape(N, LEN).astype(np.float32)
    flat[:, :BLOCK] = 0.0  # an all-zero block: scale 0
    trees = [_tree(rng) for _ in range(N)]
    residuals = [_tree(rng, 1e-2) for _ in range(N)]
    return {"flat": flat, "trees": trees, "residuals": residuals,
            "bucket_res_seed": 21}


# ---------------------------------------------------------------------------
# The port on the ranks
# ---------------------------------------------------------------------------


def _torch_tree(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            tree.items()}


def _bucket_residuals(layout, rank, seed):
    rng = np.random.default_rng([seed, rank])
    return tuple(torch.from_numpy(
        rng.standard_normal(p).astype(np.float32) * 1e-2)
        for p in layout.padded_sizes)


def _collectives(rank, mesh, inp) -> dict:
    from distributeddeeplearning_tpu_torch import comms_overlap as co
    from distributeddeeplearning_tpu_torch import comms_quant as cq

    out = {}
    flat = torch.from_numpy(inp["flat"][rank])
    tree = _torch_tree(inp["trees"][rank])
    res = _torch_tree(inp["residuals"][rank])
    layout = co.build_bucket_layout(tree, BUCKET_MB, n_members=N,
                                    block_size=BLOCK)
    bres = _bucket_residuals(layout, rank, inp["bucket_res_seed"])
    for mode in MODES:
        out[f"ar_{mode}"] = cq.quantized_all_reduce_flat(
            flat, mesh, mode=mode, block_size=BLOCK)
        out[f"rs_{mode}"] = cq.quantized_reduce_scatter_flat(
            flat, mesh, mode=mode, block_size=BLOCK)
        out[f"ef_{mode}"] = cq.ef_compress(tree, res, mode=mode,
                                           block_size=BLOCK)
        out[f"tree_{mode}"] = cq.quantized_tree_all_reduce(
            tree, mesh, mode=mode, block_size=BLOCK, residual=res)
        out[f"bar_{mode}"] = co.bucketed_all_reduce(
            tree, layout, mesh, mode=mode, block_size=BLOCK, residuals=bres)
        shards, r = co.bucketed_reduce_scatter(
            tree, layout, mesh, mode=mode, block_size=BLOCK, residuals=bres)
        out[f"brs_{mode}"] = (shards, r)
        out[f"bag_{mode}"] = co.all_gather_buckets(shards, layout, mesh)
    return out


# The Trainer's cases on dp=4 (the hierarchical ones are
# tests/test_torch_multislice.py's).
CASES = {
    "int8": dict(grad_comm="int8"),
    "int8_bucketed": dict(grad_comm="int8", grad_bucket_mb=ds.BUCKET_MB),
    "bf16_bucketed_sharded": dict(grad_comm="bf16",
                                  grad_bucket_mb=ds.BUCKET_MB,
                                  update_sharding="sharded"),
    "fp32_bucketed_fused_zero1": dict(grad_bucket_mb=ds.BUCKET_MB,
                                      optim="adamw_fused", zero1=True),
}
FP32 = ("fp32_bucketed_fused_zero1",)


# ZeRO-1 of SGD's trace at dp=2: momentum, weight decay and a clip.
SGD = dict(lr=0.05, momentum=0.9, weight_decay=0.1, grad_clip=0.05)


def _sgd_zero1(rank, init) -> dict:
    """ZeRO-1 of SGD at dp=2 on ranks {0, 1} (and the same job on {2, 3})."""
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch import data, models, train
    from distributeddeeplearning_tpu_torch.comms import DistComm
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroSGDState

    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = groups[rank // 2]
    mesh = Mesh({"dp": 2}, rank % 2,
                comm=DistComm({"world": g, "dp": g}, stage_on_host=True))
    model = models.get_model("gpt2", **ts.MODEL, attn_impl="xla", mesh=mesh)
    tx = train.make_optimizer("sgd", **SGD)
    trainer = train.Trainer(model, tx, train.get_task("lm", mesh=mesh),
                            device="cpu", mesh=mesh, zero1=True)
    state = trainer.init(0)
    ts.load_whole(state, init)
    assert isinstance(state.opt_state, ZeroSGDState)
    losses = []
    for _, batch in zip(range(STEPS), data.sharded_batches(
            data.SyntheticTokens(**ts.DATA).iter_from(0), mesh)):
        state, m = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    opt = state.opt_state
    return {"losses": losses, "params": {k: p.detach().clone() for k, p in
                                         state.params.items()},
            "trace": opt.layout.gather(opt.trace),
            "trace_elements": sum(t.numel() for t in opt.trace.values())}


def _worker(rank, world, port, tmp, inputs, init):
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    mesh = build_mesh(MeshConfig(dp=N))
    out = {"collectives": _collectives(rank, mesh, inputs)}
    for name, case in CASES.items():
        got = ds.port_case(case, mesh, init)
        out[name] = {k: got[k] for k in ("losses", "params", "residual")}
    out["sgd_zero1"] = _sgd_zero1(rank, init)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX's references (the parent)
# ---------------------------------------------------------------------------


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:N]), ("dp",))


def _nest(flat: dict) -> dict:
    """Port names -> JAX's nested tree, torch-layout leaves as kernels in
    JAX's layout."""
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
        node[leaf] = jnp.asarray(
            to_jax_layout(k, torch.from_numpy(np.asarray(v))).numpy())
    return out


def _unnest(tree, like: dict) -> dict:
    """JAX's nested tree -> the port's names and layout (numpy)."""
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


def _stack(trees):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def jax_collectives(inp) -> dict:
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import comms_overlap as co
    from distributeddeeplearning_tpu import comms_quant as cq
    from distributeddeeplearning_tpu.utils import compat
    from jax.sharding import PartitionSpec as P

    mesh = _jax_mesh()

    def sm(fn, n_in=1, n_out=1):
        return jax.jit(compat.shard_map(
            fn, mesh=mesh, in_specs=(P("dp"),) * n_in,
            out_specs=P("dp") if n_out == 1 else (P("dp"),) * n_out,
            check_vma=False))

    like = inp["trees"][0]
    trees = _stack([_nest(t) for t in inp["trees"]])
    res = _stack([_nest(t) for t in inp["residuals"]])
    layout = co.build_bucket_layout(_nest(like), BUCKET_MB, n_members=N,
                                    block_size=BLOCK)
    bres = [[_bucket_residuals(layout, r, inp["bucket_res_seed"])[b].numpy()
             for r in range(N)] for b in range(layout.num_buckets)]
    bres = tuple(jnp.stack(b) for b in bres)
    flat = jnp.asarray(inp["flat"].reshape(-1))
    first = lambda t: jax.tree.map(lambda x: x[0], t)  # noqa: E731
    lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731

    def per_member(stacked, r):
        return jax.tree.map(lambda x: np.asarray(x)[r], stacked)

    out = {r: {} for r in range(N)}
    for mode in MODES:
        ar = sm(lambda f: cq.quantized_all_reduce_flat(
            f, "dp", mode=mode, block_size=BLOCK))(flat)
        rs = sm(lambda f: cq.quantized_reduce_scatter_flat(
            f, "dp", mode=mode, block_size=BLOCK))(flat)
        ef = sm(lambda g, r: tuple(lead(x) for x in cq.ef_compress(
            first(g), first(r), mode=mode, block_size=BLOCK)), 2, 2)(
            trees, res)
        tr = sm(lambda g, r: tuple(lead(x) for x in
                                   cq.quantized_tree_all_reduce(
                                       first(g), "dp", mode=mode,
                                       block_size=BLOCK,
                                       residual=first(r))), 2, 2)(trees, res)

        def bar_fn(g, r):
            s, nr = co.bucketed_all_reduce(
                first(g), layout, "dp", mode=mode, block_size=BLOCK,
                residuals=[x[0] for x in r])
            return lead(s), tuple(x[None] for x in nr)

        def brs_fn(g, r):
            s, nr = co.bucketed_reduce_scatter(
                first(g), layout, "dp", mode=mode, block_size=BLOCK,
                residuals=[x[0] for x in r])
            back = co.all_gather_buckets(s, layout, "dp")
            return s, tuple(x[None] for x in nr), lead(back)

        bar = sm(bar_fn, 2, 2)(trees, bres)
        brs = jax.jit(compat.shard_map(
            brs_fn, mesh=mesh, in_specs=(P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False))(
            trees, bres)
        ar, rs = np.asarray(ar).reshape(N, -1), np.asarray(rs).reshape(N, -1)
        for r in range(N):
            o = out[r]
            o[f"ar_{mode}"], o[f"rs_{mode}"] = ar[r], rs[r]
            o[f"ef_{mode}"] = tuple(_unnest(per_member(x, r), like)
                                    for x in ef)
            o[f"tree_{mode}"] = tuple(_unnest(per_member(x, r), like)
                                      for x in tr)
            o[f"bar_{mode}"] = (_unnest(per_member(bar[0], r), like),
                                tuple(np.asarray(x)[r] for x in bar[1]))
            o[f"brs_{mode}"] = (
                tuple(np.asarray(s).reshape(N, -1)[r] for s in brs[0]),
                tuple(np.asarray(x)[r] for x in brs[1]))
            o[f"bag_{mode}"] = _unnest(per_member(brs[2], r), like)
    return out


def _jax_sgd_zero1(init) -> dict:
    """JAX's Trainer at dp=2 with zero1=True and SGD."""
    import jax
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.config import MeshConfig
    from distributeddeeplearning_tpu.mesh import build_mesh
    from distributeddeeplearning_tpu.train import (
        Trainer,
        get_task,
        make_optimizer,
    )
    from distributeddeeplearning_tpu_torch import weights

    mesh = build_mesh(MeshConfig(dp=2), devices=jax.devices()[:2])
    sgd = dict(SGD)
    trainer = Trainer(jmodels.get_model("gpt2", **ts.MODEL),
                      make_optimizer("sgd", sgd.pop("lr"), **sgd),
                      get_task("lm"), mesh, zero1=True, donate=False)
    dset = jdata.SyntheticTokens(**ts.DATA)
    state = trainer.init(0, dset.batch(0))
    import dataclasses

    state = dataclasses.replace(state, params=ts.jax_tree(init))
    losses = []
    for _, batch in zip(range(STEPS), jdata.sharded_batches(dset, mesh)):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    trace = weights._find_node(jax.tree.map(np.asarray, state.opt_state),
                               ("trace",)).trace
    return {"losses": losses, "params": ts.flat_numpy(state.params),
            "trace": weights.from_jax_params(trace)}


def _parent(inputs, init):
    import concurrent.futures

    # The collectives and the ZeRO-1 SGD run trace and compile on a thread
    # of their own, beside the Trainer's references (XLA compiles outside
    # the GIL).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        side = pool.submit(lambda: (jax_collectives(inputs),
                                    _jax_sgd_zero1(init)))
        out = {}
        for name, case in CASES.items():
            out[name] = ds.gpt2_reference(case, init)
        for name in FP32:
            opt = ds.opt_kw(CASES[name])
            out[f"{name}_plain"] = ts.jax_run("gpt2", init, ds.STEPS,
                                              opt=opt)
        out["collectives"], out["sgd_zero1"] = side.result()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs, init = _inputs(), ts.port_init("gpt2")
    ranks, ref = ts.spawn(_worker, N, tmp_path_factory.mktemp("gc"), inputs,
                          init, parent=lambda: _parent(inputs, init))
    return ranks, ref


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want, mode, what):
    """int8/bf16: bit for bit; fp32: within 1e-6 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], mode, f"{what}[{k}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, mode, f"{what}[{i}]")
        return
    if want is None:
        assert got is None, what
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    if mode == "fp32":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=what)


@pytest.mark.parametrize("op", ["ar", "rs", "ef", "tree", "bar", "brs",
                                "bag"])
@pytest.mark.parametrize("mode", MODES)
def test_collective_matches_jax(results, op, mode):
    ranks, ref = results
    for r in range(N):
        _same(ranks[r]["collectives"][f"{op}_{mode}"],
              ref["collectives"][r][f"{op}_{mode}"], mode, f"rank {r} {op}")


def test_lossy_all_reduce_is_identical_on_every_rank(results):
    ranks, _ = results
    for mode in ("int8", "bf16"):
        first = ranks[0]["collectives"][f"ar_{mode}"]
        for r in range(1, N):
            assert torch.equal(ranks[r]["collectives"][f"ar_{mode}"], first)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_matches_the_jax_composition(results, name):
    ranks, ref = results
    want = ref[name]
    for r in range(N):
        got = ranks[r][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        ds.assert_params_close(got["params"], want["params"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_params_are_bit_equal_across_ranks(results, name):
    ranks, _ = results
    for r in range(1, N):
        for k, p in ranks[r][name]["params"].items():
            assert torch.equal(p, ranks[0][name]["params"][k]), k


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if CASES[n].get("grad_comm")])
def test_residuals_match_the_jax_composition(results, name):
    ranks, ref = results
    for r in range(N):
        got = ranks[r][name]["residual"]
        want = ds.residual_rows(ref[name]["residual"], got, r)
        if isinstance(got, dict):
            assert set(got) == set(want)
            got, want = ([got[k] for k in sorted(got)],
                         [want[k] for k in sorted(got)])
        assert any(np.any(g.numpy() != 0) for g in got)
        ds.assert_residuals_close([g.numpy() for g in got], want)


@pytest.mark.parametrize("name", FP32)
def test_fp32_modes_equal_plain_dp(results, name):
    """The reference documents its fp32 bucketed and sharded paths as plain
    dp: its one-device Trainer on the global batch."""
    ranks, ref = results
    want = ref[f"{name}_plain"]
    np.testing.assert_allclose(ranks[0][name]["losses"], want["losses"],
                               rtol=1e-5)
    ds.assert_params_close(ranks[0][name]["params"], want["params"])


def test_zero1_of_sgd_matches_jax(results):
    """ZeRO-1 of SGD's momentum trace at dp=2 against JAX's Trainer with
    zero1=True: losses, params and the trace gathered whole."""
    ranks, ref = results
    want = ref["sgd_zero1"]
    for r in (0, 2):  # member 0 of each pair
        got = ranks[r]["sgd_zero1"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        ts.assert_params_close(got["params"], want["params"], rtol=0,
                               atol=1e-5)
        ts.assert_params_close(got["trace"], want["trace"], rtol=1e-4,
                               atol=1e-5)
    full = sum(t.numel() for t in want["params"].values())
    for r in range(N):
        n = ranks[r]["sgd_zero1"]["trace_elements"]
        assert full / 2 <= n <= full / 2 + 2 * 8  # two groups' padding


# ---------------------------------------------------------------------------
# Single-process: the layout, the byte models, the fences
# ---------------------------------------------------------------------------


def _jax_gpt2_params():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import models as jmodels

    model = jmodels.get_model("gpt2", **ts.MODEL)
    shapes = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((1, 8), jnp.int32), train=False),
        jax.random.PRNGKey(0))
    return nn.meta.unbox(shapes["params"])


@pytest.mark.parametrize("bucket_mb", [0.0, 0.01, ds.BUCKET_MB, 0.2])
@pytest.mark.parametrize("n,block", [(4, 256), (8, 64)])
def test_bucket_layout_follows_jax_leaf_for_leaf(bucket_mb, n, block):
    """The tiny GPT-2's buckets, leaf for leaf in JAX's flatten order, and
    their padding, against JAX's ``build_bucket_layout`` on its params."""
    import jax
    from distributeddeeplearning_tpu import comms_overlap as jco
    from distributeddeeplearning_tpu_torch import comms_overlap as co
    from distributeddeeplearning_tpu_torch import models

    params = _jax_gpt2_params()
    want = jco.build_bucket_layout(params, bucket_mb, n_members=n,
                                   block_size=block)
    model = models.get_model("gpt2", **ts.MODEL)
    got = co.build_bucket_layout(dict(model.named_parameters()), bucket_mb,
                                 n_members=n, block_size=block)
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(got.names) == paths
    assert got.buckets == want.buckets
    assert got.padded_sizes == want.padded_sizes
    assert got.sizes == want.sizes
    for mode in ("fp32", "bf16", "int8"):
        assert got.wire_bytes(mode, block) == want.wire_bytes(mode, block)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("block", [32, 256])
def test_byte_models_match_jax(mode, block):
    from distributeddeeplearning_tpu import comms_quant as jcq
    from distributeddeeplearning_tpu.parallel.fsdp import (
        grad_sync_bytes as jax_bytes,
    )
    from distributeddeeplearning_tpu_torch import comms_quant as cq
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.parallel.fsdp import (
        grad_sync_bytes,
    )

    assert cq.compression_ratio(mode, block) == jcq.compression_ratio(
        mode, block)
    params = dict(models.get_model("gpt2", **ts.MODEL).named_parameters())
    for n, wire in ((2, None), (4, None), (8, 2)):
        assert grad_sync_bytes(params, mode=mode, block_size=block,
                               n_members=n, wire_elem_bytes=wire) == \
            jax_bytes(_jax_gpt2_params(), mode=mode, block_size=block,
                      n_members=n, wire_elem_bytes=wire)


# id -> (Trainer kwargs, mesh axes, model, what the messages name)
FENCES = {
    "mode": (dict(grad_comm="fp16"), {"dp": 4}, "gpt2", "grad_comm='fp16'"),
    "int8_pipelined": (dict(grad_comm="int8"), {"dp": 1}, "gpt2_pp",
                       "grad_comm='int8' x pipelined model"),
    "int8_tp": (dict(grad_comm="int8"), {"dp": 2, "tp": 2}, "gpt2",
                "grad_comm='int8' is pure-DP in v1 but the mesh has "
                "{'tp': 2}"),
    "int8_accum": (dict(grad_comm="int8", grad_accum=2), {"dp": 4}, "gpt2",
                   "grad_comm='int8' x grad_accum=2"),
    "update_mode": (dict(update_sharding="both"), {"dp": 4}, "gpt2",
                    "update_sharding='both' not in"),
    "bucket_negative": (dict(grad_bucket_mb=-1.0), {"dp": 4}, "gpt2",
                        "grad_bucket_mb=-1.0 must be >= 0"),
    "hier_mode": (dict(comm_hierarchy="fastest"), {"dp": 4}, "gpt2",
                  "train.comm_hierarchy='fastest' not in"),
    "hier_one_slice": (dict(comm_hierarchy="hierarchical"), {"dp": 4},
                       "gpt2", "requires mesh.dcn_dp > 1"),
    "dcn_not_dividing": (dict(dcn_dp=3), {"dp": 4}, "gpt2",
                         "dp=4 not divisible by dcn_dp=3"),
    "ici_one": (dict(dcn_dp=4), {"dp": 4}, "gpt2", "leaves ici_size=1"),
    "bucketed_fsdp": (dict(grad_bucket_mb=1.0), {"dp": 2, "fsdp": 2},
                      "gpt2", "grad_bucket_mb=1.0 is pure-DP in v1"),
    "sharded_accum": (dict(update_sharding="sharded", grad_accum=2),
                      {"dp": 4}, "gpt2",
                      "update_sharding='sharded' x grad_accum=2"),
    "hier_pipelined": (dict(dcn_dp=2), {"dp": 4}, "gpt2_pp",
                       r"comm_hierarchy='auto' \(dcn_dp=2\) x pipelined"),
}
PP_TINY = dict(size="tiny", vocab_size=64, max_len=32, num_microbatches=2)


@pytest.mark.parametrize("fence", sorted(FENCES))
def test_trainer_fences_match_jax(fence):
    """Each of the reference Trainer's fences of the explicit sync: the
    port's Trainer raises the same exception type, naming the knob."""
    import jax
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.config import MeshConfig as JaxMesh
    from distributeddeeplearning_tpu.mesh import build_mesh as jax_mesh
    from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
    from distributeddeeplearning_tpu.train import get_task as jax_task
    from distributeddeeplearning_tpu.train import make_optimizer as jax_opt
    from distributeddeeplearning_tpu_torch import models, train
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    kw, axes, name, match = FENCES[fence]
    model_kw = PP_TINY if name == "gpt2_pp" else ts.MODEL
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh(JaxMesh(**{"dp": 1, **axes}),
                     devices=jax.devices()[:n])
    with pytest.raises(Exception) as jax_err:
        JaxTrainer(jmodels.get_model(name, **model_kw),
                   jax_opt("adamw", 1e-3), jax_task("lm"), jmesh, **kw)
    mesh = Mesh(axes)
    model = models.get_model(name, **model_kw, mesh=mesh)
    with pytest.raises(jax_err.type, match=match):
        train.Trainer(model, train.make_optimizer("adamw", 1e-3),
                      train.get_task("lm", mesh=mesh), device="cpu",
                      mesh=mesh, **kw)
    assert re.search(match, str(jax_err.value)), str(jax_err.value)


@pytest.mark.parametrize("kw", [
    dict(update_sharding="sharded", optim_name="adamw_fused"),
    dict(update_sharding="sharded", optim_name="adamw", weight_decay=0.1),
    dict(update_sharding="sharded", optim_name="adamw", grad_clip=1.0),
    dict(update_sharding="bogus"),
    dict(update_sharding="replicated", grad_bucket_mb=-2.0),
])
def test_config_fences_match_jax(kw):
    """``check_update_sharding_config``, which ``cli`` runs before the
    build: the reference's exception and words."""
    from distributeddeeplearning_tpu import comms_overlap as jco
    from distributeddeeplearning_tpu_torch import comms_overlap as co

    with pytest.raises(Exception) as want:
        jco.check_update_sharding_config(**kw)
    with pytest.raises(want.type) as got:
        co.check_update_sharding_config(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override,exc,match", [
    ("train.grad_comm=int4", ValueError, "grad_comm='int4'"),
    ("train.comm_hierarchy=ring", ValueError, "train.comm_hierarchy="),
    ("mesh.dcn_dp=0", ValueError, "mesh.dcn_dp=0 must be >= 1"),
    ("train.update_sharding=sharded", NotImplementedError,
     "optim.name='adamw_fused'"),
])
def test_cli_refuses_before_the_build(override, exc, match):
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    cfg = apply_overrides(load_config(
        "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"), [override])
    with pytest.raises(exc, match=match):
        cli.check_train_composition(cfg, world_size=4)


def test_fp32_buckets_are_posted_from_the_backward():
    """Under the fp32 bucketed replicated sync every bucket's all-reduce is
    posted by the backward's hooks, each as its last gradient arrives (the
    tied embedding, whose gradient completes at the backward's end, holds
    bucket 0 on GPT-2), and the summed tree equals the bucketed all-reduce
    after the backward."""
    from distributeddeeplearning_tpu_torch import comms_overlap as co
    from distributeddeeplearning_tpu_torch import data, models, train

    model = models.get_model("gpt2", **ts.MODEL)
    trainer = train.Trainer(model, train.make_optimizer("adamw", ts.LR),
                            train.get_task("lm"), device="cpu",
                            grad_bucket_mb=ds.BUCKET_MB)
    state = trainer.init(0)
    batch = {k: torch.from_numpy(v) for k, v in
             data.SyntheticTokens(**ts.DATA).batch(0).items()}
    posted = trainer._posted
    grads, _ = trainer._grads(state, batch, posted)
    # Every bucket posted by the hooks, before finish() is called.
    assert sorted(posted.order) == list(range(posted.layout.num_buckets))
    assert posted.order[-1] == 0  # wte: the embedding's share comes last
    summed = posted.finish(grads)
    want, _ = co.bucketed_all_reduce(grads, trainer.bucket_layout,
                                     trainer._dp_mesh)
    for k, v in want.items():
        assert torch.equal(summed[k], v), k


def test_sharded_update_refuses_the_fused_kernel_in_the_trainer():
    """The reference's ``setup`` refuses a ``FusedAdamWState`` under the
    sharded update for a Trainer built without ``cli``; the port's Trainer
    refuses ``FusedAdamW`` (not its plain subclasses) the same way."""
    from distributeddeeplearning_tpu_torch import models, train
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    mesh = Mesh({"dp": 4})
    for name, refused in (("adamw_fused", True), ("adamw", False)):
        model = models.get_model("gpt2", **ts.MODEL, mesh=mesh)
        make = lambda: train.Trainer(  # noqa: E731
            model, train.make_optimizer(name, 1e-3),
            train.get_task("lm", mesh=mesh), device="cpu", mesh=mesh,
            update_sharding="sharded")
        if refused:
            with pytest.raises(NotImplementedError,
                               match="update_sharding='sharded' x "
                               "adamw_fused"):
                make()
        else:
            assert make().update_sharding == "sharded"
