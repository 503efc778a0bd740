"""The port's pipeline engines (``parallel/pp.py``) across gloo ranks on the
CPU, against the JAX package's engines on the same numbers.

One spawn of 2 ranks (pp=2) and one of 4 (pp=4), each running every case:
- ``gpipe``, ``one_f_one_b`` and ``sequential`` on the JAX tests' toy MLP
  stages (``tanh(y @ w + b)``), output and the gradients of
  ``mean(y ** 2)`` in the stage rows and the input;
- ``interleaved_1f1b``'s (loss, grads) on the JAX tests' embed / stage /
  head problem, with M = 16 > 2S microbatches;
- what the schedules keep: at the end of every tick (each call of the
  transport) the number of tensors autograd holds for a backward, counted
  through ``saved_tensors_hooks``: gpipe keeps its graphs, 1f1b and the
  interleaved schedule none across a tick; the input stash at most M
  (1f1b) and 2S (interleaved);
- ``comms.chain_exchange`` between neighbours, bf16 included, nothing at
  the chain's ends.

Tolerance: fp32, rtol 2e-5 (the JAX package's pp-against-sequential
bound), atol 1e-6 for gradients near zero. The rank workers import torch
and the port only.
"""

import os
import socket
import weakref

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import comms
from distributeddeeplearning_tpu_torch.config import MeshConfig
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed
from distributeddeeplearning_tpu_torch.parallel import pp

torch.set_num_threads(2)

D, B, M = 16, 8, 4  # toy MLP: width, batch, microbatches
IM, MICRO, V = 16, 2, 32  # interleaved: microbatches, rows each, vocab
RTOL, ATOL = 2e-5, 1e-6


def toy(S):
    """The toy MLP problem at S stages, from a numpy seed."""
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((S, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32)}


def interleaved_problem(S):
    rng = np.random.default_rng(1)
    n = IM * MICRO
    return {
        "stacked": {"w": (rng.standard_normal((S, D, D)) * 0.3).astype(
            np.float32), "b": np.zeros((S, D), np.float32)},
        "shared": {"emb": (rng.standard_normal((V, D)) * 0.5).astype(
            np.float32), "head": (rng.standard_normal((D, V)) * 0.5).astype(
            np.float32)},
        "batch": {"tokens": rng.integers(0, V, (n, 4)).astype(np.int32),
                  "labels": rng.integers(0, V, (n,)).astype(np.int32)},
    }


def stage_fn(p, y):
    return torch.tanh(y @ p["w"] + p["b"])


def embed_fn(sh, bm):
    return sh["emb"][bm["tokens"].long()].mean(1)


def head_fn(sh, y, bm):
    return torch.nn.functional.cross_entropy(y @ sh["head"],
                                             bm["labels"].long())


class _Held:
    __slots__ = ("t", "__weakref__")


def _count_saved(fn):
    """fn() under saved_tensors_hooks: (its result, the number of tensors
    saved for a backward and still alive at each transport call)."""
    live, counts = weakref.WeakSet(), []

    def pack(t):
        h = _Held()
        h.t = t
        live.add(h)
        return h

    orig = pp._Chain.exchange

    def spy(self, **kw):
        counts.append(len(live))
        return orig(self, **kw)

    pp._Chain.exchange = spy
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
            out = fn()
    finally:
        pp._Chain.exchange = orig
    return out, counts


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        assert init_distributed("cpu")
    mesh = build_mesh(MeshConfig(dp=1, pp=world))
    s, out = mesh.coords["pp"], {}
    t = {k: torch.from_numpy(v) for k, v in toy(world).items()}
    for name, eng in (("gpipe", pp.gpipe), ("1f1b", pp.one_f_one_b)):
        mine = {"w": t["w"][s:s + 1].clone().requires_grad_(),
                "b": t["b"][s:s + 1].clone().requires_grad_()}
        x = t["x"].clone().requires_grad_()

        def run():
            pp.reset_ticks()
            y = eng(stage_fn, mine, x, mesh=mesh, num_microbatches=M)
            return y, torch.autograd.grad((y ** 2).mean(),
                                          [mine["w"], mine["b"], x])

        (y, g), counts = _count_saved(run)
        out[name] = {"y": y.detach(), "dw": g[0], "db": g[1], "dx": g[2],
                     "saved": counts, "max_stash": pp.TICKS["max_stash"],
                     "ticks": pp.TICKS["train_ticks"]}
    whole = {"w": t["w"].clone().requires_grad_(),
             "b": t["b"].clone().requires_grad_()}
    xs = t["x"].clone().requires_grad_()
    ys = pp.sequential(stage_fn, whole, xs)
    g = torch.autograd.grad((ys ** 2).mean(), [whole["w"], whole["b"], xs])
    out["sequential"] = {"y": ys.detach(), "dw": g[0], "db": g[1],
                         "dx": g[2]}
    prob = interleaved_problem(world)
    to_t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
            for k, d in prob.items()}
    rows = {k: v[s:s + 1] for k, v in to_t["stacked"].items()}

    def run_interleaved():
        pp.reset_ticks()
        return pp.interleaved_1f1b(
            embed_fn, stage_fn, head_fn, rows, to_t["shared"],
            to_t["batch"], mesh=mesh, num_microbatches=IM,
            act=((MICRO, D), torch.float32))

    (loss, (dst, dsh)), counts = _count_saved(run_interleaved)
    out["interleaved"] = {"loss": loss, "dstacked": dst, "dshared": dsh,
                          "saved": counts,
                          "max_stash": pp.TICKS["max_stash"],
                          "ticks": pp.TICKS["train_ticks"]}
    # bf16 compute over fp32 stage params: bf16 activations and
    # cotangents cross the links, the gradients accumulate in fp32.
    def bf16_stage(p, y):
        return torch.tanh(y @ p["w"].bfloat16() + p["b"].bfloat16())

    _, (dst16, _) = pp.interleaved_1f1b(
        lambda sh, bm: embed_fn(sh, bm).bfloat16(), bf16_stage,
        lambda sh, y, bm: head_fn(sh, y.float(), bm), rows, to_t["shared"],
        to_t["batch"], mesh=mesh, num_microbatches=IM,
        act=((MICRO, D), torch.bfloat16))
    out["bf16_grad_dtypes"] = {k: v.dtype for k, v in dst16.items()}
    ex = {}
    for dtype in (torch.float32, torch.bfloat16):
        below, above = comms.chain_exchange(
            mesh, "pp", up=torch.full((3,), float(s), dtype=dtype),
            down=torch.full((3,), 100.0 + s, dtype=dtype),
            from_below=((3,), dtype), from_above=((3,), dtype),
            device=torch.device("cpu"))
        ex[str(dtype)] = (below, above)
    out["exchange"] = ex
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def _spawn(world, tmp_path):
    torch.multiprocessing.spawn(_worker, args=(world, _free_port(),
                                               str(tmp_path)),
                                nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _jax_reference(S):
    """JAX's gpipe / one_f_one_b / sequential (output, grads) and
    interleaved_1f1b (loss, grads) on the same numbers, on a pp=S mesh."""
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu.parallel import pp as jpp

    from helpers import mesh_of

    mesh = mesh_of(pp=S)
    t = toy(S)

    def jstage(p, y):
        return jnp.tanh(y @ p["w"] + p["b"])

    params = {"w": jnp.asarray(t["w"]), "b": jnp.asarray(t["b"])}
    x = jnp.asarray(t["x"])
    out = {}
    for name, eng in (("gpipe", jpp.gpipe), ("1f1b", jpp.one_f_one_b)):
        def f(p, x, eng=eng):
            return eng(jstage, p, x, mesh=mesh, num_microbatches=M)

        y = jax.jit(f)(params, x)
        gp, gx = jax.jit(jax.grad(lambda p, x, f=f: (f(p, x) ** 2).mean(),
                                  argnums=(0, 1)))(params, x)
        out[name] = {"y": y, "dw": gp["w"], "db": gp["b"], "dx": gx}
    ys = jpp.sequential(jstage, params, x)
    gp, gx = jax.grad(lambda p, x: (jpp.sequential(jstage, p, x) ** 2
                                    ).mean(), argnums=(0, 1))(params, x)
    out["sequential"] = {"y": ys, "dw": gp["w"], "db": gp["b"], "dx": gx}
    prob = interleaved_problem(S)

    def jembed(sh, bm):
        return sh["emb"][bm["tokens"]].mean(1)

    def jhead(sh, y, bm):
        logits = y @ sh["head"]
        return -jax.nn.log_softmax(logits)[
            jnp.arange(y.shape[0]), bm["labels"]].mean()

    loss, (dst, dsh) = jax.jit(lambda st, sh, b: jpp.interleaved_1f1b(
        jembed, jstage, jhead, st, sh, b, mesh=mesh,
        num_microbatches=IM))(prob["stacked"], prob["shared"],
                              prob["batch"])
    out["interleaved"] = {"loss": loss, "dstacked": dst, "dshared": dsh}
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def run(request, tmp_path_factory):
    """(S, the S ranks' results, JAX's) for a pp=S spawn."""
    S = request.param
    ranks = _spawn(S, tmp_path_factory.mktemp(f"pp{S}"))
    return S, ranks, _jax_reference(S)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("engine", ["gpipe", "1f1b", "sequential"])
def test_outputs_and_grads_match_jax(run, engine):
    S, ranks, ref = run
    want = ref[engine]
    for s, r in enumerate(ranks):
        got = r[engine]
        _close(got["y"], want["y"], f"{engine} y on stage {s}")
        _close(got["dx"], want["dx"], f"{engine} dx on stage {s}")
        rows = slice(0, S) if engine == "sequential" else slice(s, s + 1)
        _close(got["dw"], want["dw"][rows], f"{engine} dw on stage {s}")
        _close(got["db"], want["db"][rows], f"{engine} db on stage {s}")


def test_interleaved_loss_and_grads_match_jax(run):
    S, ranks, ref = run
    want = ref["interleaved"]
    for s, r in enumerate(ranks):
        got = r["interleaved"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=RTOL)
        for k in ("w", "b"):
            _close(got["dstacked"][k], want["dstacked"][k][s:s + 1],
                   f"dstacked {k} on stage {s}")
        for k in ("emb", "head"):
            _close(got["dshared"][k], want["dshared"][k],
                   f"dshared {k} on stage {s}")


def test_schedules_keep_what_they_define(run):
    """gpipe keeps every microbatch's graph across its ticks; 1f1b keeps no
    graph across a tick and stashes at most M inputs; the interleaved
    schedule keeps no graph across a tick and stashes at most 2S inputs
    (here M = 16 > 2S, so the ring, not M, bounds it)."""
    S, ranks, _ = run
    for s, r in enumerate(ranks):
        assert max(r["gpipe"]["saved"]) > 0
        assert r["gpipe"]["max_stash"] == 0
        assert r["gpipe"]["ticks"] == 2 * (M + S - 1)
        assert max(r["1f1b"]["saved"]) == 0, r["1f1b"]["saved"]
        assert r["1f1b"]["max_stash"] == M
        inter = r["interleaved"]
        assert max(inter["saved"]) == 0, inter["saved"]
        assert inter["ticks"] == IM + 2 * (S - 1)
        assert inter["max_stash"] <= 2 * S
        if s < S - 1:
            assert inter["max_stash"] == 2 * (S - 1 - s) + 1
        # The stage gradients of a bf16 stage accumulate in the params'
        # dtype, fp32, as JAX's interleaved engine's do.
        assert set(r["bf16_grad_dtypes"].values()) == {torch.float32}


def test_chain_exchange_reaches_the_neighbours_only(run):
    S, ranks, _ = run
    for s, r in enumerate(ranks):
        for dtype, (below, above) in r["exchange"].items():
            if s == 0:
                assert below is None
            else:
                assert below.dtype == getattr(torch, dtype.split(".")[1])
                assert torch.equal(below.float(), torch.full((3,), s - 1.0))
            if s == S - 1:
                assert above is None
            else:
                assert torch.equal(above.float(),
                                   torch.full((3,), 101.0 + s))


def test_shape_checks_and_bubble():
    with pytest.raises(ValueError, match="not divisible"):
        pp.check_pipeline_shapes(8, 3, 4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pp.check_pipeline_shapes(8, 2, 5, 4)
    assert pp.gpipe_bubble_fraction(8, 4) == pytest.approx(3 / 11)
    assert pp.gpipe_bubble_fraction(1, 1) == 0.0


def test_one_rank_axis_runs_sequentially():
    t = {k: torch.from_numpy(v) for k, v in toy(4).items()}
    st = {"w": t["w"], "b": t["b"]}
    want = pp.sequential(stage_fn, st, t["x"])
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    for eng in (pp.gpipe, pp.one_f_one_b, pp.forward_only):
        got = eng(stage_fn, st, t["x"], mesh=single_device_mesh(),
                  num_microbatches=2)
        assert torch.equal(got, want)


def test_interleaved_on_one_rank_matches_jax(run):
    """With no pp axis the interleaved engine runs every stage back to
    back, one microbatch's graph at a time: JAX's loss and grads."""
    S, _, ref = run
    prob = interleaved_problem(S)
    to_t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
            for k, d in prob.items()}
    loss, (dst, dsh) = pp.interleaved_1f1b(
        embed_fn, stage_fn, head_fn, to_t["stacked"], to_t["shared"],
        to_t["batch"], mesh=None, num_microbatches=IM,
        act=((MICRO, D), torch.float32))
    want = ref["interleaved"]
    np.testing.assert_allclose(float(loss), want["loss"], rtol=RTOL)
    for k in ("w", "b"):
        _close(dst[k], want["dstacked"][k], f"dstacked {k}")
    for k in ("emb", "head"):
        _close(dsh[k], want["dshared"][k], f"dshared {k}")
