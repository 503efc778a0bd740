"""ResNet training of the port against the JAX ``Trainer``: five steps of
the tiny ResNet-18 (``configs/resnet18_cifar10.py`` at width 8, 16², batch
16, SGD with momentum, weight decay on the matrices, cosine warmup, label
smoothing 0.1) from the JAX init's state, carried in by
``weights.state_from_jax``:

- at dp=1 (one process) against JAX on one CPU device;
- at dp=2 (two gloo processes) against JAX on two CPU devices, the global
  batch sharded, BatchNorm's statistics global (all-reduced over dp);
- at dp=2 with ``grad_accum=2``: JAX splits the GLOBAL batch into two
  contiguous microbatches, so each rank must hold its share of each of
  them (``data.sharded_batches(..., grad_accum)``), or the BatchNorm
  batches differ.

Losses within 1e-4 relative, params and BatchNorm statistics within 1e-5.
A JAX state after 2 steps (the SGD trace and the statistics moved), carried
in, continues with JAX's losses; a checkpoint of the port's ResNet/SGD
state resumes bit for bit.
One more test holds dp=2's averaged gradients against the single-process
gradient of the global loss: without the backward all-reduce of the
BatchNorm statistics (``comms.psum_differentiable``) the cross-rank terms
are lost and they differ. The padding, the variance and the microbatch
groups are the trouble spots these pin.
"""

import importlib
import os
import socket

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, train, weights
from distributeddeeplearning_tpu_torch.comms import pmean_tensors
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed

from helpers import mesh_of

jax_data = importlib.import_module("distributeddeeplearning_tpu.data")
jax_models = importlib.import_module("distributeddeeplearning_tpu.models")
jax_train = importlib.import_module("distributeddeeplearning_tpu.train")

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/resnet18_cifar10.py"
STEPS = 5
TINY = ["model.kwargs.width=8", "data.batch_size=16", "data.image_size=16",
        "data.n_distinct=4", "optim.lr=0.05", "optim.warmup_steps=2",
        "optim.weight_decay=1e-4", "train.label_smoothing=0.1",
        f"train.steps={STEPS}"]
# (dp, grad_accum) of each run
RUNS = {"dp1": (1, 1), "dp2": (2, 1), "dp2_accum2": (2, 2)}


def _cfg(dp, accum):
    return apply_overrides(load_config(CONFIG), TINY + [
        f"mesh.dp={dp}", f"train.grad_accum={accum}"])


def _jax_trainer(dp, accum):
    cfg = _cfg(dp, accum)
    o = cfg.optim
    tx = jax_train.make_optimizer(
        o.name, o.lr, momentum=o.momentum, weight_decay=o.weight_decay,
        warmup_steps=o.warmup_steps, schedule=o.schedule,
        total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    model = jax_models.get_model(cfg.model.name, **cfg.model.kwargs)
    task = jax_train.get_task("classification",
                              label_smoothing=cfg.train.label_smoothing)
    trainer = jax_train.Trainer(model, tx, task, mesh_of(dp=dp),
                                grad_accum=accum, donate=False)
    ds = jax_data.SyntheticImages(**cfg.data.dataset_kwargs())
    return trainer, ds


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _flat_state(jstate):
    """(params, BatchNorm statistics) of a JAX state in the port's names
    and layouts."""
    names = set(_port_names())
    params = weights.to_torch_layout(
        weights.from_jax_params(_host(jstate.params)), names)
    stats = weights.from_jax_params(_host(
        jstate.model_state["batch_stats"]))
    return params, stats


def _port_names():
    from distributeddeeplearning_tpu_torch import models

    cfg = _cfg(1, 1)
    return [k for k, _ in models.get_model(
        cfg.model.name, **cfg.model.kwargs).named_parameters()]


@pytest.fixture(scope="module")
def jax_runs():
    """{run: (losses, params, stats)} of the JAX Trainer, plus the init
    state (numpy leaves) every port run starts from."""
    out = {}
    for run, (dp, accum) in RUNS.items():
        trainer, ds = _jax_trainer(dp, accum)
        state = trainer.init(0, ds.batch(0))
        if run == "dp1":
            out["init"] = _host(state)
        losses = []
        for i, batch in enumerate(jax_data.sharded_batches(
                ds, trainer.mesh)):
            if i == STEPS:
                break
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
            if run == "dp1" and i == 1:
                out["step2"] = _host(state)
        out[run] = (losses, *_flat_state(state))
    return out


def _fit(cfg, mesh, init, steps=STEPS, ckpt=None):
    """build_all + state_from_jax(init) (or the latest step of ``ckpt``, a
    ``CheckpointManager``) + fit on this rank: losses, params, BatchNorm
    statistics."""
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(cfg.train.seed)
    if ckpt is not None and ckpt.latest_step() is not None:
        state, _ = ckpt.restore(state)
    else:
        state = weights.state_from_jax(init, state)
    batches = data.prefetch(data.sharded_batches(
        dataset.iter_from(state.step), mesh, cfg.train.grad_accum), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=steps,
                            log_every=1, log_fn=lambda m: None, ckpt=ckpt,
                            save_every=0 if ckpt is None else 2)
    if ckpt is not None:
        ckpt.wait()
    return ([r["loss"] for r in hist],
            {k: p.detach().clone() for k, p in state.params.items()},
            {k: b.detach().clone() for k, b in state.model_state.items()})


def _grads(cfg, mesh, init):
    """This rank's gradient of the first batch from ``init`` (JAX's state
    after 2 steps: at the init the zero head sends no gradient below it),
    averaged over the ranks as the trainer's step averages it."""
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = weights.state_from_jax(init, trainer.init(cfg.train.seed))
    batch = data.to_device(next(data.sharded_batches(
        dataset.iter_from(0), mesh)), "cpu")
    grads, _ = trainer._grads(state, batch)
    names = list(grads)
    return dict(zip(names, pmean_tensors([grads[k] for k in names],
                                         trainer.mesh)))


def _worker(rank, port, init_path, step2_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    assert init_distributed("cpu")
    init = torch.load(init_path, weights_only=False)
    out = {}
    for run in ("dp2", "dp2_accum2"):
        cfg = _cfg(*RUNS[run])
        out[run] = _fit(cfg, build_mesh(cfg.mesh), init)
    cfg = _cfg(2, 1)
    out["grads"] = _grads(cfg, build_mesh(cfg.mesh),
                          torch.load(step2_path, weights_only=False))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """{run: [each rank's (losses, params, stats)]}, and the dp=2 ranks'
    gradients."""
    tmp = tmp_path_factory.mktemp("resnet")
    torch.save(jax_runs["init"], tmp / "init.pt")
    torch.save(jax_runs["step2"], tmp / "step2.pt")
    ctx = torch.multiprocessing.spawn(
        _worker, args=(_free_port(), str(tmp / "init.pt"),
                       str(tmp / "step2.pt"), str(tmp)),
        nprocs=2, join=False)
    dp1 = [_fit(_cfg(1, 1), None, jax_runs["init"])]  # while the ranks run
    while not ctx.join():
        pass
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    out = {run: [g[run] for g in got] for run in ("dp2", "dp2_accum2")}
    out["dp1"] = dp1
    out["grads"] = [g["grads"] for g in got]
    return out


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=f"{what} {k}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_losses_match_jax(run, jax_runs, port_runs):
    j_losses = jax_runs[run][0]
    assert j_losses[-1] < j_losses[0]
    for losses, _, _ in port_runs[run]:
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_params_and_batch_stats_match_jax(run, jax_runs, port_runs):
    _, j_params, j_stats = jax_runs[run]
    _, params, stats = port_runs[run][0]
    _close(params, j_params, "param")
    _close(stats, j_stats, "batch_stats")


@pytest.mark.parametrize("run", ["dp2", "dp2_accum2"])
def test_ranks_agree_bit_for_bit(run, port_runs):
    (la, pa, sa), (lb, pb, sb) = port_runs[run]
    assert la == lb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_microbatch_groups_are_jax_s():
    """At dp=2 x grad_accum=2 rank r's rows are its quarter of each global
    half, in order: the reference's microbatch i sharded over dp."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    x = {"image": np.arange(16)}
    rows = [next(data.sharded_batches(iter([x]), Mesh({"dp": 2}, r),
                                      grad_accum=2))["image"].tolist()
            for r in range(2)]
    assert rows == [[0, 1, 2, 3, 8, 9, 10, 11], [4, 5, 6, 7, 12, 13, 14, 15]]
    one = next(data.sharded_batches(iter([x]), Mesh({"dp": 2}, 1)))
    assert one["image"].tolist() == list(range(8, 16))


def test_dp2_gradients_are_the_global_loss_s(jax_runs, port_runs):
    """The mean over 2 ranks of each rank's gradient equals the gradient of
    the whole batch's loss in one process: the BatchNorm statistics'
    all-reduce carries its gradient back to every rank."""
    cfg = _cfg(1, 1)
    want = _grads(cfg, None, jax_runs["step2"])
    assert min(v.abs().max() for v in want.values()) > 0
    for got in port_runs["grads"]:
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_jax_state_continues_with_jax_losses(jax_runs):
    """JAX's state after 2 steps (step 2, the SGD trace, the moved
    statistics) carried in by ``state_from_jax``: the port's steps 3..5
    give JAX's losses."""
    init = jax_runs["step2"]
    assert int(init.step) == 2
    losses, params, stats = _fit(_cfg(1, 1), None, init)
    np.testing.assert_allclose(losses, jax_runs["dp1"][0][2:], rtol=1e-4)
    _close(params, jax_runs["dp1"][1], "param")
    _close(stats, jax_runs["dp1"][2], "batch_stats")


def test_checkpoint_resumes_bit_for_bit(jax_runs, tmp_path):
    """2 steps, a save, a restore into a fresh trainer and 2 more equal 4
    straight steps bit for bit: params, SGD trace and BatchNorm
    statistics all travel."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    cfg = _cfg(1, 1)
    straight = _fit(cfg, None, jax_runs["init"], steps=4)
    with CheckpointManager(str(tmp_path)) as ckpt:
        first = _fit(cfg, None, jax_runs["init"], steps=2, ckpt=ckpt)
    host = torch.load(tmp_path / "2" / "state.pt")
    assert {"trace", "model_state"} <= set(host) and "mu" not in host
    with CheckpointManager(str(tmp_path)) as ckpt:
        second = _fit(cfg, None, None, steps=4, ckpt=ckpt)
    assert first[0] + second[0] == straight[0]
    for got, want in ((second[1], straight[1]), (second[2], straight[2])):
        for k in want:
            assert torch.equal(got[k], want[k]), k
