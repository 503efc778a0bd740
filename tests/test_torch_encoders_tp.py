"""Tensor (with sequence parallelism) and fully sharded parallelism of ViT,
BERT and ResNet across 4 gloo ranks on the CPU, against the JAX package's
Trainer on one device.

The configs as shipped, shrunk and in fp32 (``configs/vit_imagenet21k.py``:
the tiny ViT, 16² images of 4 patches and a CLS token, so 5 tokens, which
sequence parallelism at tp=2 cuts into 3 + 2 with a padding row, 11
classes in 6 + 5 with a padding column, remat 'full', the flash core and
the fused AdamW, which run their plain versions on the CPU; the JAX side
runs the xla core, no remat and optax's AdamW, the same function;
``configs/bert_mlm.py``: the tiny BERT, a vocabulary of 61 words in 31 +
30, rows padded with ``pad_min_len`` so the flash core takes per-row key
limits, the vocab-parallel tied head with its ``mlm_bias`` slice,
``grad_accum=2``; ``configs/resnet18_cifar10.py``: width 8, 16², 11
classes, SGD with momentum and label smoothing 0.1). Every run starts
from JAX's init state (``weights.state_from_jax``, cut to each rank's
blocks) with weight decay 0.1 and the global norm clipped at 0.05, under
which every step clips, so the sharded norm is load-bearing.

One spawn of 4 ranks runs each model at dp2 x tp2, dp2 x fsdp2 and tp2 x
fsdp2 (the encoders with sequence parallelism there), 3 steps: losses
within rtol 2e-5 of JAX's (ResNet 1e-4, as ``test_torch_resnet_train``),
the whole params within rtol 2e-4 / atol 2e-5, the encoders' AdamW
moments (the raw gradients) within rtol 2e-4; ResNet's running
statistics and SGD momentum trace within 1e-5 of JAX's; ``evaluate`` of
the classification task (ViT at tp2 x fsdp2 with SP, ResNet at dp2 x
fsdp2, whose running statistics it reads) against JAX's evaluate of its
own final state, and on one rank from JAX's state. Then ``cli train`` of
the three configs (ResNet-50's) at tp2 x fsdp2, ``cli eval`` of BERT's
checkpoint and ``cli benchmark`` of ResNet-50 at tp2 x fsdp2 against dp2 x
fsdp2 over the same rows a replica: its convolutions, which every tp rank
runs whole, counted once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

import torch_sharded as ts
from distributeddeeplearning_tpu_torch import cli, data, train, weights
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
COMMON = ["model.kwargs.dtype=float32", "optim.schedule=constant",
          "optim.warmup_steps=0", "optim.weight_decay=0.1",
          "optim.grad_clip=0.05", f"train.steps={STEPS}",
          "data.n_distinct=2"]
MODELS = {
    "vit": ("vit_imagenet21k.py", [
        "model.kwargs.size=tiny", "model.kwargs.image_size=16",
        "data.image_size=16", "model.kwargs.num_classes=11",
        "data.num_classes=11", "data.batch_size=8", "optim.lr=1e-4"]),
    "bert": ("bert_mlm.py", [
        "model.kwargs.size=tiny", "model.kwargs.vocab_size=61",
        "data.vocab_size=61", "model.kwargs.max_len=32", "data.seq_len=16",
        "data.batch_size=8", "data.pad_min_len=8", "train.head_chunk=8",
        "train.grad_accum=2", "optim.lr=1e-3"]),
    "resnet": ("resnet18_cifar10.py", [
        "model.kwargs.width=8", "data.image_size=16",
        "model.kwargs.num_classes=11", "data.num_classes=11",
        "data.batch_size=16", "optim.lr=0.05",
        "train.label_smoothing=0.1"]),
}
MESHES = {
    "dp2_tp2": ["mesh.dp=2", "mesh.tp=2"],
    "dp2_fsdp2": ["mesh.dp=2", "mesh.fsdp=2"],
    "tp2_fsdp2": ["mesh.dp=1", "mesh.tp=2", "mesh.fsdp=2",
                  "train.sequence_parallel=true"],
}
JOBS = [(m, mesh) for m in MODELS for mesh in MESHES]
EVALS = {("vit", "tp2_fsdp2"), ("resnet", "dp2_fsdp2")}
EVAL_BATCHES = 2
# cli runs of the configs at tp2 x fsdp2 (``cli.main`` in the ranks)
R50 = ["model.kwargs.width=4", "model.kwargs.num_classes=10",
       "data.num_classes=10", "data.image_size=16", "data.batch_size=4"]
CLI_RUNS = {
    "train_vit": ("train", "vit", MESHES["tp2_fsdp2"]),
    "train_bert": ("train", "bert", MESHES["tp2_fsdp2"]),
    "train_resnet50": ("train", "resnet50", MESHES["tp2_fsdp2"]),
    "benchmark_resnet50": ("benchmark", "resnet50", MESHES["tp2_fsdp2"]),
    "benchmark_resnet50_dp": ("benchmark", "resnet50",
                              MESHES["dp2_fsdp2"] + ["data.batch_size=8"]),
}


def _cfg(model, overrides=()):
    if model == "resnet50":
        path, extra = "resnet50_imagenet.py", R50
    else:
        path, extra = MODELS[model]
    return apply_overrides(
        load_config(f"{ROOT}/distributeddeeplearning_tpu_torch/configs/"
                    f"{path}"), COMMON + extra + list(overrides))


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _whole(tree, shards):
    """A rank's blocks put back together whole on rank 0 (None
    elsewhere)."""
    tree = tree if shards is None else shards.gather(tree)
    return None if tree is None else {k: v.detach().clone()
                                      for k, v in tree.items()}


def _eval(cfg, mesh, trainer, state):
    from distributeddeeplearning_tpu_torch.cli import make_eval_fn

    cfg = apply_overrides(cfg, [f"train.eval_batches={EVAL_BATCHES}"])
    return train.evaluate(trainer, state, make_eval_fn(cfg, mesh, "cpu")())


def _job(model, mesh_name, jax_init):
    from distributeddeeplearning_tpu_torch.mesh import build_mesh
    from distributeddeeplearning_tpu_torch.parallel.fsdp import (
        sharded_fraction,
    )

    cfg = _cfg(model, MESHES[mesh_name])
    mesh = build_mesh(cfg.mesh)
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = weights.state_from_jax(jax_init, trainer.init(0))
    batches = data.sharded_batches(dataset.iter_from(0), mesh,
                                   cfg.train.grad_accum)
    state, hist = train.fit(trainer, state, data.prefetch(batches, "cpu"),
                            steps=STEPS, log_every=1, log_fn=lambda m: None)
    out = {"losses": [r["loss"] for r in hist if "loss" in r],
           "params": _whole(state.params, state.shards),
           "stats": {k: v.clone() for k, v in state.model_state.items()},
           "fraction": {a: sharded_fraction(state.shards, a)
                        for a in ("tp", "fsdp")}}
    if isinstance(state.opt_state, train.SGDState):
        out["trace"] = _whole(state.opt_state.trace, state.shards)
    else:
        out["moments"] = {m: _whole(getattr(state.opt_state, m),
                                    state.shards) for m in ("mu", "nu")}
    if (model, mesh_name) in EVALS:
        out["eval"] = _eval(cfg, mesh, trainer, state)
    return out


def _argv(run, ck):
    cmd, model, overrides = CLI_RUNS[run]
    file = ("resnet50_imagenet.py" if model == "resnet50"
            else MODELS[model][0])
    argv = [cmd, "--config",
            f"{ROOT}/distributeddeeplearning_tpu_torch/configs/{file}",
            "--device", "cpu"]
    if cmd == "benchmark":
        argv += ["--steps", "1", "--latency-steps", "0", "--probe", "1"]
    extra = R50 if model == "resnet50" else MODELS[model][1]
    for o in (COMMON + extra + overrides
              + [f"train.checkpoint_dir={ck}", "train.save_every=2",
                 "train.log_every=1", "train.steps=2"]):
        argv += ["--override", o]
    return argv


def _worker(rank, world, port, tmp, ports):
    import torch.distributed as dist

    ts.join_world(rank, world, port)
    inits = torch.load(os.path.join(tmp, "inits.pt"), weights_only=False)
    out = {f"{m}_{mesh}": _job(m, mesh, inits[m]) for m, mesh in JOBS}
    dist.destroy_process_group()
    for i, run in enumerate(CLI_RUNS):
        os.environ["MASTER_PORT"] = str(ports[i])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(_argv(run, os.path.join(tmp, f"ck_{run}"))) == 0
        out[f"cli_{run}"] = buf.getvalue()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# JAX's Trainer on one device
# ---------------------------------------------------------------------------


def _jax_trainer(model):
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    jmodels = importlib.import_module("distributeddeeplearning_tpu.models")
    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    cfg = _cfg(model)
    kw = {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}
    if "attn_impl" in kw:
        kw["attn_impl"] = "xla"
    o, t = cfg.optim, cfg.train
    tx = jtrain.make_optimizer(
        "adamw" if o.name == "adamw_fused" else o.name, o.lr,
        momentum=o.momentum, b1=o.b1, b2=o.b2, weight_decay=o.weight_decay,
        grad_clip=o.grad_clip)
    task = jtrain.get_task(t.task, head_chunk=t.head_chunk,
                           label_smoothing=t.label_smoothing)
    trainer = jtrain.Trainer(jmodels.get_model(cfg.model.name, **kw), tx,
                             task, single_device_mesh(), donate=False,
                             grad_accum=t.grad_accum)
    return cfg, trainer, jdata


def _jax_init(model):
    """(JAX's trainer and its init state) of ``model``."""
    cfg, trainer, jdata = _jax_trainer(model)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return trainer, trainer.init(0, ds.batch(0))


def _jax_fit(model, trainer, init_state):
    from distributeddeeplearning_tpu import data as jdata

    cfg = _cfg(model)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    state, losses = init_state, []
    for _, batch in zip(range(STEPS),
                        jdata.sharded_batches(ds, trainer.mesh)):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "state": _host(state)}
    if model in ("vit", "resnet"):
        jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
        eds = jdata.make_dataset(cfg.data.kind,
                                 **cfg.data.eval_dataset_kwargs())
        out["eval"] = jtrain.evaluate(trainer, state, (
            b for _, b in zip(range(EVAL_BATCHES),
                              jdata.sharded_batches(eds, trainer.mesh))))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("enc")
    jinits = {m: _jax_init(m) for m in MODELS}
    torch.save({m: _host(s) for m, (_, s) in jinits.items()},
               tmp / "inits.pt")

    def parent():
        # One thread a model: the references trace and compile side by
        # side (XLA compiles outside the GIL).
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(len(jinits)) as pool:
            futs = {m: pool.submit(_jax_fit, m, *ts_)
                    for m, ts_ in jinits.items()}
            return {m: f.result() for m, f in futs.items()}

    ranks, refs = ts.spawn(_worker, 4, tmp, ts.free_ports(len(CLI_RUNS)),
                           parent=parent)
    return ranks, refs, tmp


def _port_names(model):
    return {k for k, _ in cli.build_model(_cfg(model), "cpu")
            .named_parameters()}


def _flat(tree, model):
    return weights.to_torch_layout(weights.from_jax_params(tree),
                                   _port_names(model))


@pytest.mark.parametrize("model,mesh", JOBS)
def test_losses_and_params_match_jax(run, model, mesh):
    ranks, refs, _ = run
    want = refs[model]
    rtol = 1e-4 if model == "resnet" else 2e-5
    for r in ranks:
        np.testing.assert_allclose(r[f"{model}_{mesh}"]["losses"],
                                   want["losses"], rtol=rtol)
    ts.assert_params_close(ranks[0][f"{model}_{mesh}"]["params"],
                           _flat(want["state"].params, model))


@pytest.mark.parametrize("model,mesh", [j for j in JOBS
                                        if j[0] != "resnet"])
def test_adamw_moments_match_jax(run, model, mesh):
    """The AdamW moments after the last step hold the clipped raw
    gradients, which AdamW's update and the losses see only up to a scale
    (ViT's zero head also leaves its encoder no gradient on step 1): a tp
    or fsdp sum doubled or left out shows here. Each leaf within rtol 2e-4
    and an atol of 2e-5 of its largest value, or of a thousandth of the
    tree's largest where that is more (the key biases' gradient is zero
    but for rounding: softmax ignores a shift of every score)."""
    ranks, refs, _ = run
    node = weights._find_adam_moments(refs[model]["state"].opt_state)
    for m in ("mu", "nu"):
        got = ranks[0][f"{model}_{mesh}"]["moments"][m]
        want = {k: v.numpy()
                for k, v in _flat(getattr(node, m), model).items()}
        assert set(got) == set(want)
        floor = 1e-3 * max(np.abs(v).max() for v in want.values())
        for k, v in want.items():
            np.testing.assert_allclose(
                got[k].numpy(), v, rtol=2e-4,
                atol=2e-5 * max(np.abs(v).max(), floor), err_msg=f"{m} {k}")


@pytest.mark.parametrize("model,mesh", JOBS)
def test_the_sharding_is_real(run, model, mesh):
    ranks, _, _ = run
    frac = ranks[0][f"{model}_{mesh}"]["fraction"]
    for axis in ("tp", "fsdp"):
        assert (frac[axis] > 0) == (axis in mesh), frac


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resnet_statistics_and_momentum_match_jax(run, mesh):
    ranks, refs, _ = run
    st = refs["resnet"]["state"]
    stats = weights.from_jax_params(st.model_state["batch_stats"])
    trace = _flat(weights._find_node(st.opt_state, ("trace",)).trace,
                  "resnet")
    for r in ranks:  # every rank holds the same running statistics
        got = r[f"resnet_{mesh}"]["stats"]
        assert set(got) == set(stats)
        for k, v in stats.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    got = ranks[0][f"resnet_{mesh}"]["trace"]
    ts.assert_params_close(got, trace, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,mesh", sorted(EVALS))
def test_classification_evaluate_matches_jax(run, model, mesh):
    ranks, refs, _ = run
    want = refs[model]["eval"]
    for r in ranks:
        got = r[f"{model}_{mesh}"]["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], float(v), rtol=2e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", ["vit", "resnet"])
def test_classification_evaluate_on_one_rank_matches_jax(run, model):
    _, refs, _ = run
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    cfg = _cfg(model)
    mesh = single_device_mesh()
    _, trainer, _ = cli.build_all(cfg, "cpu", mesh)
    state = weights.state_from_jax(refs[model]["state"], trainer.init(0))
    got = _eval(cfg, mesh, trainer, state)
    for k, v in refs[model]["eval"].items():
        np.testing.assert_allclose(got[k], float(v), rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("model", ["vit", "bert", "resnet50"])
def test_cli_train_runs_at_tp2_fsdp2(run, model):
    ranks, _, _ = run
    for r in ranks[:1]:
        losses = [x["loss"] for x in _records(r[f"cli_train_{model}"])
                  if "loss" in x]
        assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_eval_restores_a_tp2_fsdp2_checkpoint_on_one_rank(run):
    _, _, tmp = run
    argv = _argv("train_bert", str(tmp / "ck_train_bert"))
    argv[0] = "eval"
    argv += ["--override", "mesh.tp=1", "--override", "mesh.fsdp=1",
             "--override", "train.eval_batches=1"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    assert "checkpoint at step 2" in buf.getvalue()
    (rec,) = [r for r in _records(buf.getvalue()) if "eval_loss" in r]
    assert np.isfinite(rec["eval_loss"])


def test_cli_benchmark_counts_repeated_convolutions_once(run):
    ranks, _, _ = run
    got = _records(ranks[0]["cli_benchmark_resnet50"])[-1]
    dp = _records(ranks[0]["cli_benchmark_resnet50_dp"])[-1]
    # The head's padding (10 classes in 5 + 5: none) aside, the same work.
    np.testing.assert_allclose(got["model_tflops_per_step"],
                               dp["model_tflops_per_step"], rtol=1e-6)
    assert got["params"] == dp["params"]


def test_vocab_parallel_head_with_a_bias_and_padded_slices():
    """``chunked_xent`` over tp=2 virtual ranks (61 words in 31 + 30, the
    last slice padded) with a bias: the per-token loss and every input's
    gradient equal the one-rank head's."""
    from distributeddeeplearning_tpu_torch.ops.chunked_xent import (
        chunked_xent,
        head_output,
    )
    from distributeddeeplearning_tpu_torch.parallel.tp import VocabShard

    g = torch.Generator().manual_seed(0)
    V, E = 61, 8
    h = torch.randn(2, 6, E, generator=g)
    emb = torch.randn(V, E, generator=g)
    bias = torch.randn(V, generator=g)
    tgt = torch.randint(0, V, (2, 6), generator=g)
    leaves = [t.clone().requires_grad_() for t in (h, emb, bias)]
    want = chunked_xent(head_output(*leaves), tgt, seq_chunk=4)
    want_g = torch.autograd.grad(want.sum(), leaves)

    def fn(mesh):
        shard = VocabShard.of(mesh, V)
        rows = -(-V // 2)

        def cut(t):
            part = t[shard.lo:shard.lo + shard.valid]
            pad = rows - shard.valid
            return torch.cat([part, part.new_zeros((pad, *t.shape[1:]))])

        lv = [h.clone().requires_grad_(), cut(emb).requires_grad_(),
              cut(bias).requires_grad_()]
        out = chunked_xent(head_output(*lv, vocab=shard), tgt, seq_chunk=4)
        return out.detach(), torch.autograd.grad(out.sum(), lv), shard

    ranks = ts.lockstep(2, fn, tp=2)
    # h's gradient on a rank is its slice's share: their sum is the whole
    # (f sums it in a model).
    torch.testing.assert_close(sum(g[0] for _, g, _ in ranks), want_g[0],
                               rtol=1e-5, atol=1e-6)
    for out, grads, shard in ranks:
        torch.testing.assert_close(out, want.detach(), rtol=1e-6, atol=1e-6)
        for got, full in zip(grads[1:], want_g[1:]):
            n = shard.valid
            torch.testing.assert_close(got[:n], full[shard.lo:shard.lo + n],
                                       rtol=1e-6, atol=1e-6)
            assert not got[n:].any()  # the padding stays zero
