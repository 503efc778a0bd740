"""ZeRO-1 and gradient accumulation of the port, against the JAX package.

- The flat layout (``parallel/zero.py``): shard and gather round trips,
  padding to dp x 4 elements with 16-byte aligned shards, the model's
  masters bound as views, and weight decay taken from the group (a matrix
  leaf's 1-D shard still decays).
- The shard update of ``FusedAdamW`` and ``AdamW``, emulated over 2 and 4
  slices in one process, equals the unsharded update: bit for bit without
  the clip; with it, within fp32 rounding (the global norm is summed in
  another order).
- One spawn of 4 gloo ranks trains the tiny GPT-2 for 5 steps from the JAX
  init's weights: dp2 x cp2 with ZeRO-1 (``attn_impl='ring'``) over the
  world, then two dp=2 jobs side by side on ranks {0, 1} and {2, 3}:
  ZeRO-1 with ``adamw`` and with ``adamw_fused``, then the same with
  ``grad_accum=2``. Each run must equal the port's single-process run and
  the JAX package's ``train_tiny_gpt2`` at the same mesh with ``zero1=True``
  (and ``grad_accum``): losses within 1e-4 relative, params within 1e-5
  (the key biases excepted, as in ``test_torch_context_parallel.py``).
  A third pair of dp=2 jobs adds weight decay 0.1 and a clip far below the
  gradient norm, so the clipped gradient's elements come near Adam's eps
  and a norm that missed the sum over the ranks would show in the
  params; it is held against the single-process run with the same clip
  and decay at the same limits.
- ``grad_accum=2`` equals one batch of twice the microbatch's rows.
"""

import os
import socket

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, train
from distributeddeeplearning_tpu_torch.comms import DistComm
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import (
    Mesh,
    build_mesh,
    init_distributed,
)
from distributeddeeplearning_tpu_torch.ops.fused_adamw import FusedAdamW
from distributeddeeplearning_tpu_torch.parallel.zero import (
    ZeroLayout,
    ZeroState,
)

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
STEPS = 5
# helpers.train_tiny_gpt2's run on gpt2_owt's schema (as in
# test_torch_context_parallel.py), with the config's own zero1=True.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "model.kwargs.chunked_head=False", "data.vocab_size=256",
    "data.seq_len=32", "data.batch_size=16", "data.n_distinct=4",
    "optim.name=adamw", "optim.lr=1e-3", "optim.b2=0.999",
    "optim.weight_decay=0.0", "optim.schedule=constant",
    "optim.warmup_steps=0", "optim.grad_clip=0.0", "train.zero1=True",
    f"train.steps={STEPS}",
]
# Weight decay and a clip below the tiny model's gradient norm (about 1
# at the JAX init), which scales the gradient's elements near Adam's eps
# (1e-8): the update then follows the norm's value.
CLIP = ["optim.weight_decay=0.1", "optim.grad_clip=1e-5"]
# (cp, attn_impl, optimizer, grad_accum) of each multi-rank run.
RUNS = {
    "dp2cp2_ring": (2, "ring", "adamw", 1),
    "dp2_adamw": (1, "flash", "adamw", 1),
    "dp2_adamw_fused": (1, "flash", "adamw_fused", 1),
    "dp2_accum2_adamw": (1, "flash", "adamw", 2),
    "dp2_accum2_adamw_fused": (1, "flash", "adamw_fused", 2),
}
# The same at dp=2 with CLIP, held against the single process only (the
# JAX helper's optimizer has neither).
CLIP_RUNS = {"dp2_clip_adamw": (1, "flash", "adamw", 1),
             "dp2_clip_adamw_fused": (1, "flash", "adamw_fused", 1)}


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def _run_cfg(run):
    cp, impl, opt, accum = {**RUNS, **CLIP_RUNS}[run]
    return _cfg("mesh.dp=2", f"mesh.cp={cp}", f"model.kwargs.attn_impl={impl}",
                f"optim.name={opt}", f"train.grad_accum={accum}",
                *(CLIP if run in CLIP_RUNS else ()))


def _train(cfg, mesh, weights):
    """build_all + fit on this rank from ``weights``: losses, params and
    this rank's moments."""
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(weights, strict=True)
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=cfg.train.steps,
                            log_every=1, log_fn=lambda m: None)
    opt = state.opt_state
    return {"losses": [r["loss"] for r in hist],
            "params": {k: p.detach().clone() for k, p in state.params.items()},
            "sharded": isinstance(opt, ZeroState),
            "moment_elements": sum(m.numel() for m in opt.mu.values())}


def _pair_mesh(rank, groups):
    """dp=2 over ranks {0, 1} or {2, 3} of the 4-rank world."""
    g = groups[rank // 2]
    return Mesh({"dp": 2}, rank % 2,
                comm=DistComm({"world": g, "dp": g}, stage_on_host=True))


def _worker(rank, world, port, weights_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert init_distributed("cpu")
    weights = torch.load(weights_path)
    out = {}
    cfg = _run_cfg("dp2cp2_ring")
    out["dp2cp2_ring"] = _train(cfg, build_mesh(cfg.mesh), weights)
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    for kind in ("", "accum2_", "clip_"):
        run = f"dp2_{kind}" + ("adamw", "adamw_fused")[rank // 2]
        out[run] = _train(_run_cfg(run), _pair_mesh(rank, groups), weights)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init's weights (seed 0) as a state_dict."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    from helpers import train_tiny_gpt2

    _, state = train_tiny_gpt2(single_device_mesh(), n_steps=0)
    return from_jax_params(jax.tree.map(np.asarray,
                                        nn.meta.unbox(state.params)))


@pytest.fixture(scope="module")
def ranks(jax_init, tmp_path_factory):
    """{run: [each rank's result]} of the one 4-rank spawn."""
    tmp = tmp_path_factory.mktemp("zero")
    path = tmp / "weights.pt"
    torch.save(jax_init, path)
    torch.multiprocessing.spawn(
        _worker, args=(4, _free_port(), str(path), str(tmp)), nprocs=4,
        join=True)
    got = [torch.load(tmp / f"rank{r}.pt") for r in range(4)]
    out = {"dp2cp2_ring": [g["dp2cp2_ring"] for g in got]}
    for run in {**RUNS, **CLIP_RUNS}:
        if run != "dp2cp2_ring":
            out[run] = [g[run] for g in got if run in g]
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's train_tiny_gpt2 at each run's mesh, with zero1=True."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    from helpers import mesh_of, train_tiny_gpt2

    out = {}
    for name, axes, impl, accum in (
            ("dp2cp2_ring", {"dp": 2, "cp": 2}, "ring", 1),
            ("dp2", {"dp": 2}, "xla", 1),
            ("dp2_accum2", {"dp": 2}, "xla", 2)):
        losses, state = train_tiny_gpt2(mesh_of(**axes), attn_impl=impl,
                                        n_steps=STEPS, zero1=True,
                                        grad_accum=accum)
        out[name] = (losses, from_jax_params(jax.tree.map(
            np.asarray, nn.meta.unbox(state.params))))
    return out


@pytest.fixture(scope="module")
def singles(jax_init):
    """The port's single-process runs (flash core) from the same weights."""
    return {opt: _train(_cfg("model.kwargs.attn_impl=flash",
                             f"optim.name={opt}"), None, jax_init)
            for opt in ("adamw", "adamw_fused")}


@pytest.fixture(scope="module")
def clipped_singles(jax_init):
    """The single-process runs with CLIP."""
    return {opt: _train(_cfg("model.kwargs.attn_impl=flash",
                             f"optim.name={opt}", *CLIP), None, jax_init)
            for opt in ("adamw", "adamw_fused")}


def _jax_key(run):
    return "dp2_accum2" if "accum2" in run else run.rsplit("_adamw", 1)[0]


def _assert_params_close(got, want):
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("attn.key.bias"):
            assert np.abs(a).max() < 1e-3 and np.abs(b).max() < 1e-3, k
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_losses_match_jax_and_single_process(run, ranks, jax_runs, singles):
    j_losses = jax_runs[_jax_key(run)][0]
    single = singles[RUNS[run][2]]["losses"]
    for res in ranks[run]:
        np.testing.assert_allclose(res["losses"], j_losses, rtol=1e-4)
        np.testing.assert_allclose(res["losses"], single, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_params_match_jax_and_single_process(run, ranks, jax_runs, singles):
    _assert_params_close(ranks[run][0]["params"], jax_runs[_jax_key(run)][1])
    _assert_params_close(ranks[run][0]["params"],
                         singles[RUNS[run][2]]["params"])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_params_are_bit_equal_across_ranks(run, ranks):
    for res in ranks[run][1:]:
        for k, p in res["params"].items():
            assert torch.equal(p, ranks[run][0]["params"][k]), k


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_rank_holds_half_the_moments(run, ranks, singles):
    """Over dp=2 each rank's moments hold half the unsharded elements, plus
    at most the padding of two groups to a multiple of dp x 4."""
    full = singles["adamw"]["moment_elements"]
    assert not singles["adamw"]["sharded"]
    for res in ranks[run]:
        assert res["sharded"]
        assert full / 2 <= res["moment_elements"] <= full / 2 + 2 * 2 * 4


@pytest.mark.parametrize("run", sorted(CLIP_RUNS))
def test_clip_and_decay_over_dp_match_single_process(run, ranks,
                                                      clipped_singles,
                                                      singles):
    """The global norm summed over the ranks, and each group's decay, in
    the sharded step. The clip must change the run, or it tests
    nothing."""
    want = clipped_singles[CLIP_RUNS[run][2]]
    assert want["losses"][-1] != singles[CLIP_RUNS[run][2]]["losses"][-1]
    for res in ranks[run]:
        assert res["sharded"]
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-4)
        _assert_params_close(res["params"], want["params"])
        for k, p in res["params"].items():
            assert torch.equal(p, ranks[run][0]["params"][k]), k


def _tiny_params(seed=0):
    """A tiny GPT-2's parameters, numpy-drawn, by name."""
    from distributeddeeplearning_tpu_torch import models

    m = models.get_model("gpt2", size="tiny", vocab_size=67, max_len=16)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(p.shape)
                                .astype(np.float32))
            for k, p in m.named_parameters()}


@pytest.mark.parametrize("n", [2, 4])
def test_layout_round_trip_padding_and_alignment(n):
    tree = _tiny_params()
    layouts = [ZeroLayout(tree, Mesh({"dp": n}, r)) for r in range(n)]
    lay = layouts[0]
    assert set(lay.names) == {"decay", "no_decay"}
    for g, names in lay.names.items():
        used = sum(tree[k].numel() for k in names)
        assert lay.padded[g] % (n * 4) == 0
        assert 0 <= lay.padded[g] - used < n * 4
        assert lay.shard_size[g] * n == lay.padded[g]
        assert all(lay.shard_slice(g).start * 4 % 16 == 0 for lay in layouts)
    shards = [la.shard(tree) for la in layouts]
    whole = {g: torch.cat([s[g] for s in shards]) for g in lay.names}
    for g, flat in whole.items():
        assert not flat[sum(tree[k].numel() for k in lay.names[g]):].any()
    back = lay.views(whole)
    assert set(back) == set(tree)
    for k, v in tree.items():
        assert torch.equal(back[k], v), k


def test_bind_makes_the_masters_views():
    from distributeddeeplearning_tpu_torch import models

    m = models.get_model("gpt2", size="tiny", vocab_size=67, max_len=16)
    params = dict(m.named_parameters())
    lay = ZeroLayout(params, Mesh({"dp": 2}, 1))
    lay.bind(params)
    tree = _tiny_params(3)
    m.load_state_dict(tree)  # writes through to the flat buffers
    for k, v in lay.views(lay.flats).items():
        assert torch.equal(v, tree[k]) and v.data_ptr() == dict(
            m.named_parameters())[k].data_ptr(), k
    for g, s in lay.param_shards().items():
        assert torch.equal(s, lay.shard(tree)[g])


def _opt(cls, clip):
    return cls(1e-3, b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=clip)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("cls", [FusedAdamW, train.AdamW],
                         ids=["FusedAdamW", "AdamW"])
def test_shard_update_equals_unsharded_update(cls, clip, n):
    """Three steps of the unsharded update against each of n slices'
    shard update with its own moments, the norm summed over the slices."""
    params = _tiny_params(1)
    grads = [{k: v * 2.0 for k, v in _tiny_params(10 + i).items()}
             for i in range(3)]
    tx = _opt(cls, clip)
    full = {k: v.clone() for k, v in params.items()}
    state = tx.init(full)
    layouts = [ZeroLayout(params, Mesh({"dp": n}, r)) for r in range(n)]
    p_shards = [la.shard(params) for la in layouts]
    states = [ZeroState(0, {g: torch.zeros_like(s) for g, s in ps.items()},
                        {g: torch.zeros_like(s) for g, s in ps.items()}, la)
              for la, ps in zip(layouts, p_shards)]
    for g_tree in grads:
        state = tx.update(g_tree, state, full)
        g_shards = [la.shard(g_tree) for la in layouts]
        norm = torch.sqrt(sum((s * s).sum() for gs in g_shards
                              for s in gs.values()))
        states = [tx.update_shard(gs, st, ps, norm) for gs, st, ps in
                  zip(g_shards, states, p_shards)]
    got = layouts[0].views({g: torch.cat([ps[g] for ps in p_shards])
                            for g in layouts[0].names})
    mu = layouts[0].views({g: torch.cat([st.mu[g] for st in states])
                           for g in layouts[0].names})
    assert all(st.count == 3 for st in states) and state.count == 3
    for k in params:
        if clip:
            np.testing.assert_allclose(got[k], full[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        else:
            assert torch.equal(got[k], full[k]), k
            assert torch.equal(mu[k], state.mu[k]), k


@pytest.mark.parametrize("cls", [FusedAdamW, train.AdamW],
                         ids=["FusedAdamW", "AdamW"])
def test_weight_decay_comes_from_the_group(cls):
    """A 1-D shard of the decay group decays; of the no-decay group, not:
    with zero gradients the update is -lr * wd * p and nothing else."""
    tx = _opt(cls, 0.0)
    p = {"decay": torch.full((8,), 2.0), "no_decay": torch.full((8,), 2.0)}
    g = {k: torch.zeros(8) for k in p}
    st = ZeroState(0, {k: torch.zeros(8) for k in p},
                   {k: torch.zeros(8) for k in p}, None)
    tx.update_shard(g, st, p, None)
    np.testing.assert_allclose(p["decay"], 2.0 * (1 - 1e-3 * 0.1),
                               rtol=1e-6)
    assert torch.equal(p["no_decay"], torch.full((8,), 2.0))


def _accum_run(accum, batch_size):
    cfg = _cfg("model.kwargs.attn_impl=flash", f"train.grad_accum={accum}",
               f"data.batch_size={batch_size}", "train.steps=3")
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    state = trainer.init(0)
    state, hist = train.fit(trainer, state, data.prefetch(
        dataset.iter_from(0), "cpu"), steps=3, log_every=1,
        log_fn=lambda m: None)
    return [r["loss"] for r in hist], state.params


def test_grad_accum_equals_one_batch_of_twice_the_rows():
    """Two microbatches of 8 rows a step against one batch of 16."""
    la, pa = _accum_run(2, 16)
    lb, pb = _accum_run(1, 16)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for k in pa:
        if k.endswith("attn.key.bias"):  # moved by rounding noise only
            continue
        np.testing.assert_allclose(pa[k].detach(), pb[k].detach(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_uneven_microbatch_split_is_refused_by_name():
    cfg = _cfg("model.kwargs.attn_impl=flash", "train.grad_accum=3")
    _, trainer, dataset = cli.build_all(cfg, "cpu")
    state = trainer.init(0)
    batch = data.to_device(dataset.batch(0), "cpu")
    with pytest.raises(ValueError, match="grad_accum=3 must divide this "
                       "rank's batch of 16 rows"):
        trainer.train_step(state, batch)
