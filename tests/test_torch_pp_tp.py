"""Pipeline parallelism composed with tensor and fully sharded parallelism
(``mesh.pp`` x ``mesh.tp`` / ``mesh.fsdp``) across 8 gloo ranks on the
CPU, against the JAX package.

The tiny pipelined models in fp32 (``configs/gpt2_pp.py`` and
``configs/bert_pp.py`` shrunk: 4 layers in 2 stages, 4 heads, width 64, a
vocabulary of 63 words, which tp=2 cuts into 32 + 31 rows; llama_pp's 4
query heads over 2 KV heads, one a tp rank; 2 microbatches; AdamW at a
constant lr 1e-3 with weight decay 0.1 and the global norm clipped at
0.05, which every step's norm exceeds, so the sharded norm is
load-bearing). One spawn of 8 ranks runs these jobs in turn:

- ``grads_*``: one ``pipeline_value_and_grad`` of gpt2_pp and llama_pp
  (interleaved 1F1B) and of bert_pp (1F1B, rows padded with
  ``pad_min_len``) at dp2 x pp2 x tp2 on one batch, each leaf's raw
  gradient put back together whole. Held against ``jax.grad`` of JAX's
  sequential oracle, and gpt2_pp and llama_pp also against JAX's own
  ``pipeline_value_and_grad`` at pp2 x tp2, within JAX's own bounds (rtol
  2e-5, atol 2e-6, ``tests/test_pipeline.py``): a missing or doubled tp
  sum in the stages' f/g bracketing scales a leaf's raw gradient, which
  AdamW's losses hide;
- ``fsdp_zero1``: gpt2_pp at dp2 x pp2 x fsdp2 with ZeRO-1, 3 Trainer
  steps; ``accum``: dp2 x pp2 x tp2 with ``grad_accum=2``, 3 steps, saving
  at step 3; ``bert``: bert_pp at dp2 x pp2 x tp2 on padded rows, 3 steps.
  Losses within rtol 2e-5 of JAX's Trainer on one device (the sequential
  oracle), the whole params within ``torch_sharded``'s rtol 2e-4 / atol
  2e-5;
- every job's embedding tables (and Llama's untied head) cut over tp
  then pp, JAX's ``vocab_pp``: a rank holds its block, not a copy;
- ``restore``: ``accum``'s save (the one-rank layout) restored at dp2 x
  pp2 x fsdp2 (tp=1) and put back together bit for bit; the parent
  restores it at pp=1 on one process, params and moments bit for bit;
- ``cli train`` (with an evaluation and a save) and ``cli benchmark`` of
  gpt2_pp at dp2 x pp2 x tp2 (each ``cli.main`` on its own MASTER_PORT),
  then ``cli eval`` of its checkpoint on one process; the benchmark's
  model FLOPs a step and whole parameter count equal those of dp2 x pp2 x
  fsdp2 over the same rows a replica (each tp rank's share counted
  once).
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_sharded as ts
from distributeddeeplearning_tpu_torch import cli, data, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.parallel.fsdp import sharded_fraction

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"gpt2_pp": "gpt2_pp.py", "llama_pp": "gpt2_pp.py",
           "bert_pp": "bert_pp.py"}
STEPS = 3
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=63",
    "model.kwargs.max_len=32", "model.kwargs.num_microbatches=2",
    "model.kwargs.num_stages=2", "model.kwargs.dtype=float32",
    "data.vocab_size=63", "data.seq_len=16", "data.batch_size=8",
    "data.n_distinct=2", "optim.name=adamw", "optim.schedule=constant",
    "optim.lr=1e-3", "optim.warmup_steps=0", "optim.grad_clip=0.05",
    "optim.weight_decay=0.1", "train.zero1=False", f"train.steps={STEPS}",
]
EXTRA = {
    "gpt2_pp": [],
    "llama_pp": ["model.name=llama_pp"],
    "bert_pp": ["model.kwargs.num_layers=4", "data.pad_min_len=8"],
}
PP_TP = ["mesh.dp=2", "mesh.pp=2", "mesh.tp=2"]
# name -> (model, mesh and knobs)
JOBS = {
    "fsdp_zero1": ("gpt2_pp", ["mesh.dp=2", "mesh.pp=2", "mesh.fsdp=2",
                               "train.zero1=True"]),
    "accum": ("gpt2_pp", PP_TP + ["train.grad_accum=2"]),
    "bert": ("bert_pp", PP_TP),
}
GRAD_RTOL, GRAD_ATOL = 2e-5, 2e-6
# cli runs in the ranks: ``benchmark_fsdp`` runs the rows of a dp replica
# (4 of them, 2 an fsdp rank), the stages and the chunked vocab head as
# ``benchmark`` does, without tp.
CLI_RUNS = {"train": PP_TP, "benchmark": PP_TP,
            "benchmark_fsdp": ["mesh.dp=2", "mesh.pp=2", "mesh.fsdp=2"]}


def _cfg(name, overrides=()):
    path = f"{ROOT}/distributeddeeplearning_tpu_torch/configs/" \
           f"{CONFIGS[name]}"
    return apply_overrides(load_config(path),
                           TINY + EXTRA[name] + list(overrides))


def _whole(tree, model):
    """A rank's blocks of a params-shaped ``tree`` put back together whole
    on rank 0 (None elsewhere): over tp and fsdp, then the stage rows over
    pp, as a save does."""
    if model.shards is not None:
        tree = model.shards.gather(tree)
    if tree is not None and model.pipelined:
        tree = model.stage_rows.gather(tree)
    return None if tree is None else {k: v.detach().clone()
                                      for k, v in tree.items()}


def _load(state, model, whole):
    from distributeddeeplearning_tpu_torch.weights import (
        rank_rows,
        rank_shards,
    )

    local = rank_shards(rank_rows(whole, model.stage_rows), model.shards)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(local[k])


def _grads(name, inits):
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    cfg = _cfg(name, PP_TP)
    mesh = build_mesh(cfg.mesh)
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(0)
    _load(state, model, inits[name])
    batch = {k: torch.from_numpy(v) for k, v in dataset.batch(0).items()}
    loss, grads, _ = model.pipeline_value_and_grad(batch, trainer.task)
    return {"loss": float(loss), "grads": _whole(grads, model),
            "tables": _tables(state, model)}


def _tables(state, model):
    """The shapes of the ``vocab_pp`` tables this rank holds."""
    return {k: tuple(state.params[k].shape) for k in model._pp_tables()}


def _fit(job, inits, ckpt_dir=None):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    name, overrides = JOBS[job]
    cfg = _cfg(name, overrides)
    mesh = build_mesh(cfg.mesh)
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(0)
    _load(state, model, inits[name])
    batches = data.sharded_batches(dataset.iter_from(0), mesh,
                                   cfg.train.grad_accum)
    ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir)
    state, hist = train.fit(trainer, state, data.prefetch(batches, "cpu"),
                            steps=STEPS, log_every=1, log_fn=lambda m: None,
                            ckpt=ckpt, save_every=STEPS if ckpt else 0)
    if ckpt is not None:
        ckpt.close()
    return {"losses": [r["loss"] for r in hist if "loss" in r],
            "params": _whole(state.params, model),
            "fraction": {a: sharded_fraction(trainer.shards, a)
                         for a in ("tp", "fsdp")},
            "coords": dict(mesh.coords), "tables": _tables(state, model)}


def _restore(ckpt_dir):
    """``ckpt_dir``'s latest step restored at dp2 x pp2 x fsdp2 (tp=1) and
    put back together."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    cfg = _cfg("gpt2_pp", ["mesh.dp=2", "mesh.pp=2", "mesh.fsdp=2"])
    mesh = build_mesh(cfg.mesh)
    model, trainer, _ = cli.build_all(cfg, "cpu", mesh)
    with CheckpointManager(ckpt_dir) as ck:
        state, _ = ck.restore(trainer.init(0))
    return {"step": state.step, "params": _whole(state.params, model)}


def _argv(cmd, overrides, ck):
    argv = [cmd, "--config",
            f"{ROOT}/distributeddeeplearning_tpu_torch/configs/gpt2_pp.py",
            "--device", "cpu"]
    if cmd == "benchmark":
        argv += ["--steps", "1", "--latency-steps", "0",
                 "--probe", "1"]
    for o in TINY + overrides + [f"train.checkpoint_dir={ck}",
                                 "train.eval_every=2", "train.save_every=2",
                                 "train.eval_batches=1", "train.log_every=1"]:
        argv += ["--override", o]
    return argv


def _worker(rank, world, port, tmp, ports):
    import torch.distributed as dist

    ts.join_world(rank, world, port)
    inits = torch.load(os.path.join(tmp, "inits.pt"))
    out = {f"grads_{n}": _grads(n, inits)
           for n in ("gpt2_pp", "llama_pp", "bert_pp")}
    for job in JOBS:
        ck = os.path.join(tmp, "ck_accum") if job == "accum" else None
        out[job] = _fit(job, inits, ck)
    out["restore"] = _restore(os.path.join(tmp, "ck_accum"))
    dist.destroy_process_group()
    for i, (run, overrides) in enumerate(CLI_RUNS.items()):
        os.environ["MASTER_PORT"] = str(ports[i])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(_argv(run.split("_")[0], overrides,
                                  os.path.join(tmp, "ck_cli"))) == 0
        out[f"cli_{run}"] = buf.getvalue()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# JAX's references, computed in the parent while the ranks run
# ---------------------------------------------------------------------------


def _init(name):
    """The port's one-rank draw of the tiny ``name`` (seed 0), flat: the
    init both packages start from."""
    return {k: v.detach().clone() for k, v in
            cli.build_model(_cfg(name), "cpu").state_dict().items()}


def _jax_model(name, **kw):
    jmodels = importlib.import_module("distributeddeeplearning_tpu.models")
    cfg = _cfg(name)
    kwargs = {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}
    return jmodels.get_model(cfg.model.name, **{**kwargs, **kw})


def _jax_task(name):
    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    return jtrain.get_task("mlm" if name == "bert_pp" else "lm")


def _jax_batch(name):
    import jax.numpy as jnp

    from distributeddeeplearning_tpu import data as jdata

    cfg = _cfg(name)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return {k: jnp.asarray(v) for k, v in ds.batch(0).items()}


def _jax_grads(name, init, engine: bool):
    """(loss, flat grads) of JAX's sequential oracle, or with ``engine`` of
    its ``pipeline_value_and_grad`` at pp2 x tp2."""
    import jax

    from helpers import mesh_of

    params = ts.jax_tree(init)
    batch = _jax_batch(name)
    if engine:
        mesh = mesh_of(pp=2, tp=2)
        m = _jax_model(name, schedule="1f1b_interleaved", mesh=mesh)
        loss, g = jax.jit(lambda p, b: m.pipeline_value_and_grad(
            p, b, mesh))(params, batch)
    else:
        m, task = _jax_model(name, pipeline=False), _jax_task(name)

        def loss_fn(p):
            out = m.apply({"params": p}, *task.input_fn(batch))
            return task.loss_fn(out, batch)[0]

        loss, g = jax.value_and_grad(loss_fn)(params)
    return float(loss), ts.flat_numpy(g)


def _jax_fit(name):
    """Losses and final flat params of JAX's Trainer on one device (the
    sequential stages) from the port's init, over the job's batches."""
    import dataclasses

    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    cfg = _cfg(name)
    o = cfg.optim
    tx = jtrain.make_optimizer(o.name, o.lr, b1=o.b1, b2=o.b2,
                               weight_decay=o.weight_decay,
                               grad_clip=o.grad_clip)
    mesh = single_device_mesh()
    trainer = jtrain.Trainer(_jax_model(name, pipeline=False), tx,
                             _jax_task(name), mesh, donate=False)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    state = trainer.init(0, ds.batch(0))
    state = dataclasses.replace(state, params=ts.jax_tree(INITS[name]))
    losses = []
    for _, batch in zip(range(STEPS), jdata.sharded_batches(ds, mesh)):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": ts.flat_numpy(state.params)}


INITS: dict = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pptp")
    for name in CONFIGS:
        INITS[name] = _init(name)
    torch.save(dict(INITS), tmp / "inits.pt")

    def parent():
        refs = {}
        for name in CONFIGS:
            refs[f"oracle_{name}"] = _jax_grads(name, INITS[name], False)
        for name in ("gpt2_pp", "llama_pp"):
            refs[f"engine_{name}"] = _jax_grads(name, INITS[name], True)
        for name in ("gpt2_pp", "bert_pp"):
            refs[f"fit_{name}"] = _jax_fit(name)
        return refs

    ranks, refs = ts.spawn(_worker, 8, tmp, ts.free_ports(len(CLI_RUNS)),
                           parent=parent)
    return ranks, refs, tmp


def _close(got: dict, want: dict, rtol, atol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["gpt2_pp", "llama_pp", "bert_pp"])
def test_pp2_tp2_raw_gradients_match_jax_oracle(run, name):
    ranks, refs, _ = run
    loss, want = refs[f"oracle_{name}"]
    got = ranks[0][f"grads_{name}"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _close(got["grads"], want, GRAD_RTOL, GRAD_ATOL)
    for r in ranks:  # every rank reports the same loss
        assert r[f"grads_{name}"]["loss"] == got["loss"]


@pytest.mark.parametrize("name", ["gpt2_pp", "llama_pp"])
def test_pp2_tp2_raw_gradients_match_jax_engine(run, name):
    ranks, refs, _ = run
    loss, want = refs[f"engine_{name}"]
    got = ranks[0][f"grads_{name}"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _close(got["grads"], want, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("job", list(JOBS))
def test_trainer_matches_jax(run, job):
    ranks, refs, _ = run
    want = refs[f"fit_{JOBS[job][0]}"]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=2e-5)
    ts.assert_params_close(ranks[0][job]["params"], want["params"])


@pytest.mark.parametrize("job,axes", [
    ("fsdp_zero1", {"fsdp": True, "tp": False}),
    ("accum", {"tp": True, "fsdp": False}),
])
def test_the_sharding_is_real(run, job, axes):
    ranks, _, _ = run
    frac = ranks[0][job]["fraction"]
    for axis, on in axes.items():
        assert (frac[axis] > 0.3) == on, frac


TABLES = {"gpt2_pp": {"wte.embedding": 0},
          "llama_pp": {"embed.embedding": 0, "lm_head": 1},
          "bert_pp": {"word_embeddings.embedding": 0}}


@pytest.mark.parametrize("job", [*(f"grads_{n}" for n in TABLES), *JOBS])
def test_tables_are_cut_over_pp(run, job):
    """JAX's ``vocab_pp``: each pp rank stores a block of its tp slice of
    the embedding tables (and Llama's untied head), not a copy of it: of
    63 words, 32 a tp rank and 16 a pp rank of those, or 32 a pp rank at
    tp=1."""
    ranks, _, _ = run
    name, overrides = ((job[len("grads_"):], PP_TP)
                       if job.startswith("grads_") else JOBS[job])
    tp = 2 if "mesh.tp=2" in overrides else 1
    rows = -(-(-(-63 // tp)) // 2)
    for r in ranks:
        tables = r[job]["tables"]
        assert set(tables) == set(TABLES[name]), tables
        for k, d in TABLES[name].items():
            assert tables[k][d] == rows, (k, tables[k])


def test_save_holds_the_whole_params_and_restores_at_tp1(run):
    ranks, _, tmp = run
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    with CheckpointManager(str(tmp / "ck_accum")) as ck:
        host, _ = ck._load(ck.latest_step())
    whole = ranks[0]["accum"]["params"]
    assert set(host["params"]) == set(whole)
    for k, v in whole.items():
        assert torch.equal(host["params"][k], v), k
    got = ranks[0]["restore"]
    assert got["step"] == STEPS
    for k, v in whole.items():
        assert torch.equal(got["params"][k], v), k


def test_save_restores_at_pp1_on_one_process(run):
    ranks, _, tmp = run
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    cfg = _cfg("gpt2_pp", ["mesh.dp=1", "mesh.pp=1",
                           "model.kwargs.pipeline=False"])
    _, trainer, _ = cli.build_all(cfg, "cpu", single_device_mesh())
    with CheckpointManager(str(tmp / "ck_accum")) as ck:
        state, _ = ck.restore(trainer.init(0))
        host, _ = ck._load(ck.latest_step())
    for k, v in ranks[0]["accum"]["params"].items():
        assert torch.equal(state.params[k], v), k
    for n in ("mu", "nu"):
        for k, v in getattr(state.opt_state, n).items():
            assert torch.equal(v, host[n][k]), (n, k)


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_cli_train_and_eval_run_at_pp2_tp2(run, tmp_path):
    ranks, _, tmp = run
    recs = _records(ranks[0]["cli_train"])
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert any("eval_loss" in r for r in recs)
    argv = _argv("eval", ["mesh.dp=1", "mesh.pp=1"], str(tmp / "ck_cli"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    (rec,) = [r for r in _records(buf.getvalue()) if "eval_loss" in r]
    assert np.isfinite(rec["eval_loss"])
    assert "checkpoint at step" in buf.getvalue()


def test_cli_benchmark_counts_each_rank_share_once(run):
    ranks, _, _ = run
    got = _records(ranks[0]["cli_benchmark"])[-1]
    tp1 = _records(ranks[0]["cli_benchmark_fsdp"])[-1]
    # Within 1e-3: the last tp rank's vocabulary slice holds a padding row
    # (63 words in 32 + 31), whose logits it computes (3.5e-4 of the
    # count here).
    np.testing.assert_allclose(got["model_tflops_per_step"],
                               tp1["model_tflops_per_step"], rtol=1e-3)
    assert got["params"] == tp1["params"]
    assert 0 < got["mfu" if "mfu" in got else "model_tflops_per_step"]
