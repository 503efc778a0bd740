"""The compositions of dropout, remat 'dots', ``bf16_full``, SGD, the
pipelined models' tables and ViT with the sharded axes, against the JAX
package's Trainer on one device (or, for dropout, the port's own one
process: torch cannot replay JAX's masks).

One spawn of 4 gloo ranks (``tests/torch_sharded.py``'s setting: the tiny
models, AdamW at lr 1e-3 with weight decay 0.1 and the global norm clipped
at 0.05, so the sharded norm is load-bearing), 5 steps of each job (the
pipelines and ViT 3):

- remat 'dots' under fsdp: GPT-2 at fsdp4 and at tp2 x fsdp2 with sequence
  parallelism against JAX's ``remat='dots'`` (the policy saves the
  products' outputs; a block's fsdp leaves are gathered again in its
  recompute). JAX's Llama takes 'none' and 'full' only, so the port's
  does too;
- ``bf16_full`` at tp2 x fsdp2 against JAX's (losses within 2e-4, the
  update within 10% in norm: ``tests/test_torch_precision.py``'s bounds);
  ``LowPrecisionAdamW`` at fp32 compute at tp2 x fsdp2 and at dp2 x fsdp2
  with ZeRO-1 against the port's one process (losses within 1e-5, params
  within 5e-5, the bf16 moments equal but for the few elements a last-bit
  gradient difference moves across a rounding boundary: a rank rounds each
  element with the bits one process draws for it);
- SGD with momentum under ep: gpt2_moe (4 experts at capacity factor 0.5:
  drops in every routed layer) at dp2 x ep2 and ep4 against optax's, the
  momentum trace over a rank's experts gathered whole;
- gpt2_pp and llama_pp (untied head) at pp=4 and at dp2 x pp2, each rank
  holding its block of the tables (JAX's ``vocab_pp`` at pp alone), against
  JAX's sequential stages; the pp=4 save restored at pp=1 in one process
  and at dp2 x tp2 (the stages back to back) bit for bit;
- the tiny ViT at 24² (9 patches and the CLS token: 10 tokens, 5 a cp
  rank, 3 + 2 with a padding row under sequence parallelism) on ``ring``,
  ``ring_pallas``, ``ulysses`` and ``ulysses_flash`` at dp2 x cp2 and
  tp2 x cp2, against JAX's ViT: losses, params and the AdamW moments leaf
  by leaf (the zero head hides the encoder's gradient from the first
  losses);
- dropout at 0.1 against the port's one process with the same seed: GPT-2
  at dp2 x tp2, dp2 x fsdp2, dp2 x tp2 with sequence parallelism and tp2 x
  cp2 on ``ulysses``, gpt2_moe at ep2 x tp2 with sequence parallelism, ViT
  at tp2 x cp2 with sequence parallelism on ``ulysses`` (uneven shards) and
  BERT at dp2 x tp2 with sequence parallelism over 15-token rows (uneven
  shards).

Single process: ``_global_rand`` over each axis gives the block of the
one-rank draw, and the refusals JAX keeps, in JAX's words (attention
dropout on the ring, flash and ``ulysses_flash`` cores; ViT-L/16's 197
tokens under cp).
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

import torch_sharded as ts
from distributeddeeplearning_tpu_torch import cli, data, models, train, weights
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import Mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = f"{ROOT}/distributeddeeplearning_tpu_torch/configs"
MOE = dict(num_experts=4, capacity_factor=0.5)
DROP = dict(dropout_rate=0.1)

# Held against JAX's one-device Trainer: name -> (model, mesh, port_run
# knobs, the JAX reference's key).
JOBS = {
    "gpt2_dots_fsdp4": ("gpt2", dict(dp=1, fsdp=4), {"remat": "dots"},
                        "gpt2_dots"),
    "gpt2_dots_sp_tp2_fsdp2": ("gpt2", dict(dp=1, tp=2, fsdp=2),
                               {"remat": "dots", "sequence_parallel": True},
                               "gpt2_dots"),
    "gpt2_bf16_full_tp2_fsdp2": ("gpt2", dict(dp=1, tp=2, fsdp=2),
                                 {"precision": "bf16_full"},
                                 "gpt2_bf16_full"),
    "gpt2_moe_sgd_dp2_ep2": ("gpt2_moe", dict(dp=2, ep=2),
                             {"optim": "sgd", "model_kw": MOE},
                             "gpt2_moe_sgd"),
    "gpt2_moe_sgd_ep4": ("gpt2_moe", dict(dp=1, ep=4),
                         {"optim": "sgd", "model_kw": MOE}, "gpt2_moe_sgd"),
}
# ``LowPrecisionAdamW`` at fp32 compute against the port's one process.
LP = {
    "lp_tp2_fsdp2": (dict(dp=1, tp=2, fsdp=2), {}),
    "lp_dp2_fsdp2_zero1": (dict(dp=2, fsdp=2), {"zero1": True}),
}
SAVED_LP = "lp_tp2_fsdp2"
# Dropout against the port's one process: name -> (model, mesh, knobs).
DROPS = {
    "gpt2_drop_dp2_tp2": ("gpt2", dict(dp=2, tp=2), {}),
    "gpt2_drop_dp2_fsdp2": ("gpt2", dict(dp=2, fsdp=2), {}),
    "gpt2_drop_sp_dp2_tp2": ("gpt2", dict(dp=2, tp=2),
                             {"sequence_parallel": True}),
    "gpt2_drop_ulysses_tp2_cp2": ("gpt2", dict(dp=1, tp=2, cp=2),
                                  {"attn_impl": "ulysses"}),
    "gpt2_moe_drop_sp_ep2_tp2": ("gpt2_moe", dict(dp=1, ep=2, tp=2),
                                 {"sequence_parallel": True}),
}

# The config-driven jobs (``cli.build_all``): the pipelines, ViT and BERT.
COMMON = ["model.kwargs.dtype=float32", "optim.schedule=constant",
          "optim.warmup_steps=0", "optim.weight_decay=0.1",
          "optim.grad_clip=0.05", "data.n_distinct=2"]
PP_STEPS = VIT_STEPS = 3
PP = COMMON + [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
    "model.kwargs.max_len=32", "model.kwargs.num_layers=4",
    "model.kwargs.num_microbatches=2", "data.vocab_size=64",
    "data.seq_len=16", "data.batch_size=8", "optim.name=adamw",
    "optim.lr=1e-3", "train.zero1=False", f"train.steps={PP_STEPS}"]
PP_JOBS = {
    "gpt2_pp_pp4": ("gpt2_pp", 4, ["mesh.dp=1", "mesh.pp=4"]),
    "gpt2_pp_dp2_pp2": ("gpt2_pp", 2, ["mesh.dp=2", "mesh.pp=2"]),
    "llama_pp_pp4": ("llama_pp", 4, ["mesh.dp=1", "mesh.pp=4"]),
    "llama_pp_dp2_pp2": ("llama_pp", 2, ["mesh.dp=2", "mesh.pp=2"]),
}
SAVED_PP = "gpt2_pp_pp4"
# Each pipelined model's tables -> the dimension pp cuts.
TABLES = {"gpt2_pp": {"wte.embedding": 0},
          "llama_pp": {"embed.embedding": 0, "lm_head": 1}}
VIT = COMMON + [
    "model.kwargs.size=tiny", "model.kwargs.image_size=24",
    "data.image_size=24", "model.kwargs.num_classes=11",
    "data.num_classes=11", "data.batch_size=8", "optim.lr=1e-4",
    "train.zero1=False", f"train.steps={VIT_STEPS}"]
CORES = ("ring", "ring_pallas", "ulysses", "ulysses_flash")
# name -> the job's overrides: each core at dp2 x cp2 and at tp2 x cp2,
# sequence parallelism on the plain cores of each kind.
VIT_JOBS = {
    **{f"vit_{c}_dp2_cp2": ["mesh.dp=2", "mesh.cp=2",
                            f"model.kwargs.attn_impl={c}"] for c in CORES},
    **{f"vit_{c}_tp2_cp2": ["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
                            f"model.kwargs.attn_impl={c}"]
       + (["train.sequence_parallel=true"] if c in ("ring", "ulysses")
          else []) for c in CORES},
}
BERT = COMMON + [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=61",
    "data.vocab_size=61", "model.kwargs.max_len=32", "data.seq_len=15",
    "data.batch_size=8", "data.pad_min_len=8", "train.head_chunk=8",
    "optim.lr=1e-3", f"train.steps={ts.STEPS}",
    "model.kwargs.attn_impl=xla", "model.kwargs.dropout_rate=0.1"]
# Dropout through the configs: name -> (config, overrides, its mesh).
CFG_DROPS = {
    "vit_drop_ulysses_sp_tp2_cp2": (
        "vit", VIT + ["model.kwargs.dropout_rate=0.1"],
        ["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
         "model.kwargs.attn_impl=ulysses", "train.sequence_parallel=true"]),
    "bert_drop_sp_dp2_tp2": (
        "bert", BERT, ["mesh.dp=2", "mesh.tp=2",
                       "train.sequence_parallel=true"]),
}
FILES = {"vit": "vit_imagenet21k.py", "bert": "bert_mlm.py",
         "gpt2_pp": "gpt2_pp.py", "llama_pp": "gpt2_pp.py",
         "gpt2": "gpt2_owt.py", "gpt2_moe": "gpt2_moe.py"}
# ``cli.main`` in the ranks, as torchrun would run it, each on its own
# MASTER_PORT: name -> (command, config, overrides).
GPT2_CLI = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
            "model.kwargs.max_len=64", "data.vocab_size=256",
            "data.seq_len=32", "data.batch_size=8", "optim.warmup_steps=1",
            "train.steps=2", "train.log_every=1", "train.save_every=2"]
MOE_CLI = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
           "model.kwargs.max_len=32", "model.kwargs.num_experts=4",
           "model.kwargs.dtype=float32", "data.vocab_size=64",
           "data.seq_len=16", "data.batch_size=8", "optim.warmup_steps=1",
           "train.steps=2", "train.log_every=1"]
VIT_CLI = VIT + ["train.log_every=1", "train.steps=2"]
VIT_BENCH = ["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
             "model.kwargs.attn_impl=ulysses"]
CLI_RUNS = {
    # dropout, remat 'dots' and bf16_full at tp2 x fsdp2 with SP, saved
    "train_gpt2": ("train", "gpt2", GPT2_CLI + [
        "mesh.dp=1", "mesh.tp=2", "mesh.fsdp=2",
        "train.sequence_parallel=true", "model.kwargs.dropout_rate=0.1",
        "model.kwargs.attn_impl=xla",
        "train.remat=dots", "train.precision.policy=bf16_full",
        "optim.name=adamw"]),
    # ... evaluated at dp2 x fsdp2
    "eval_gpt2": ("eval", "gpt2", GPT2_CLI + [
        "mesh.dp=2", "mesh.fsdp=2", "train.precision.policy=bf16_full",
        "optim.name=adamw"]),
    "train_moe_sgd": ("train", "gpt2_moe", MOE_CLI + [
        "mesh.dp=2", "mesh.ep=2", "optim.name=sgd", "train.zero1=false"]),
    "train_vit": ("train", "vit", VIT_CLI + [
        "mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
        "model.kwargs.attn_impl=ring_pallas"]),
    # 12 classes, which tp divides (a padded class would count too).
    "benchmark_vit": ("benchmark", "vit", VIT_CLI + VIT_BENCH + [
        "model.kwargs.num_classes=12", "data.num_classes=12"]),
}


def _cfg(name, base, overrides=()):
    extra = ["model.name=llama_pp"] if name == "llama_pp" else []
    return apply_overrides(load_config(f"{CONFIGS}/{FILES[name]}"),
                           base + extra + list(overrides))


def _pp_cfg(job, overrides=None):
    name, stages, mesh = PP_JOBS[job]
    return _cfg(name, PP, [f"model.kwargs.num_stages={stages}"]
                + (mesh if overrides is None else overrides))


def _whole(tree, model):
    """A rank's blocks of a params-shaped ``tree`` put back together whole
    on rank 0 (None elsewhere), as a save does."""
    if model.shards is not None:
        tree = model.shards.gather(tree)
    rows = getattr(model, "stage_rows", None)
    if tree is not None and rows is not None and model.pipelined:
        tree = rows.gather(tree)
    return None if tree is None else {k: v.detach().clone()
                                      for k, v in tree.items()}


def _fit_cfg(cfg, state_fn, steps, ckpt_dir=None):
    """``steps`` steps of a config's trainer on its mesh from
    ``state_fn(trainer, model)``: losses, the whole params and optimizer
    trees on rank 0, each rank's blocks of the pp tables."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    mesh = build_mesh(cfg.mesh)
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = state_fn(trainer, model)
    batches = data.sharded_batches(dataset.iter_from(0), mesh,
                                   cfg.train.grad_accum)
    ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir)
    state, hist = train.fit(trainer, state, data.prefetch(batches, "cpu"),
                            steps=steps, log_every=1, log_fn=lambda m: None,
                            ckpt=ckpt, save_every=steps if ckpt else 0)
    if ckpt is not None:
        ckpt.close()
    out = {"losses": [r["loss"] for r in hist if "loss" in r],
           "params": _whole(state.params, model),
           "coords": dict(mesh.coords),
           "tables": {k: tuple(state.params[k].shape)
                      for k, d in (model.shards.dims if model.shards
                                   else {}).items() if "pp" in d}}
    opt = state.opt_state
    if hasattr(opt, "mu") and not hasattr(opt, "layout"):
        out["moments"] = {m: _whole(getattr(opt, m), model)
                          for m in ("mu", "nu")}
    return out


def _load_whole(whole):
    def fn(trainer, model):
        state = trainer.init(0)
        local = weights.rank_shards(weights.rank_rows(
            whole, getattr(model, "stage_rows", None)), model.shards)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(local[k])
        return state
    return fn


def _from_jax(jax_init):
    return lambda trainer, model: weights.state_from_jax(
        jax_init, trainer.init(0))


def _restore_pp(ckpt_dir):
    """The pp=4 save restored at dp2 x tp2, its stages back to back: the
    params put back together."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    cfg = _pp_cfg(SAVED_PP, ["mesh.dp=2", "mesh.tp=2", "mesh.pp=1",
                             "model.kwargs.pipeline=False"])
    mesh = build_mesh(cfg.mesh)
    model, trainer, _ = cli.build_all(cfg, "cpu", mesh)
    with CheckpointManager(ckpt_dir) as ck:
        state, _ = ck.restore(trainer.init(0))
    return {"step": state.step, "params": _whole(state.params, model),
            "moments": {m: _whole(getattr(state.opt_state, m), model)
                        for m in ("mu", "nu")}}


def _lp_tx():
    return train.LowPrecisionAdamW(ts.LR, weight_decay=0.1, grad_clip=0.05)


def _port_job(name, axes, kw, init, ckpt_dir=None):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    mesh = None if axes is None else build_mesh(MeshConfig(**axes))
    r = ts.port_run(name, mesh, init, **kw)
    state = r["state"]
    if ckpt_dir is not None:
        with CheckpointManager(ckpt_dir) as mgr:
            mgr.save(ts.STEPS, state, {"next_index": ts.STEPS})
    out = {k: r[k] for k in ("losses", "metrics", "params", "fraction",
                             "coords")}
    trees = train.opt_state_trees(state.opt_state)
    if hasattr(state.opt_state, "layout"):
        trees = {m: state.opt_state.layout.gather(t)
                 for m, t in trees.items()}
    if state.shards is not None and all(t is not None
                                        for t in trees.values()):
        trees = {m: state.shards.gather(t) for m, t in trees.items()}
    out["opt"] = None if any(t is None for t in trees.values()) else {
        m: {k: v.detach().clone() for k, v in t.items()}
        for m, t in trees.items()}
    return out


def _cli_argv(run, ck, overrides=()):
    cmd, name, base = CLI_RUNS[run]
    argv = [cmd, "--config", f"{CONFIGS}/{FILES[name]}", "--device", "cpu"]
    if cmd == "benchmark":
        argv += ["--steps", "1", "--latency-steps", "0", "--probe", "0"]
    for o in base + list(overrides) + [f"train.checkpoint_dir={ck}"]:
        argv += ["--override", o]
    return argv


def _cli(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def _records(text):
    import json

    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _worker(rank, world, port, tmp, ports):
    import torch.distributed as dist

    ts.join_world(rank, world, port)
    inits = torch.load(os.path.join(tmp, "inits.pt"), weights_only=False)
    out = {}
    for job, (name, axes, kw, _) in JOBS.items():
        out[job] = _port_job(name, axes, kw, inits[name])
    for job, (axes, kw) in LP.items():
        ck = os.path.join(tmp, "ck_lp") if job == SAVED_LP else None
        out[job] = _port_job("gpt2", axes, {**kw, "tx": _lp_tx()},
                             inits["gpt2"], ck)
    for job, (name, axes, kw) in DROPS.items():
        kw = {**kw, "model_kw": {**DROP, **(MOE if "moe" in name else {})}}
        out[job] = _port_job(name, axes, kw, inits[name + "_drop"])
    for job, (name, _, _) in PP_JOBS.items():
        ck = os.path.join(tmp, "ck_pp") if job == SAVED_PP else None
        out[job] = _fit_cfg(_pp_cfg(job), _load_whole(inits[job]),
                            PP_STEPS, ck)
    out["restore_pp"] = _restore_pp(os.path.join(tmp, "ck_pp"))
    for job, overrides in VIT_JOBS.items():
        out[job] = _fit_cfg(_cfg("vit", VIT, overrides),
                            _from_jax(inits["vit"]), VIT_STEPS)
    for job, (name, base, overrides) in CFG_DROPS.items():
        out[job] = _fit_cfg(_cfg(name, base, overrides),
                            _load_whole(inits[job]),
                            VIT_STEPS if name == "vit" else ts.STEPS)
    dist.destroy_process_group()
    for i, run in enumerate(CLI_RUNS):
        os.environ["MASTER_PORT"] = str(ports[i])
        ck = "train_gpt2" if run == "eval_gpt2" else run  # eval its save
        out[f"cli_{run}"] = _cli(_cli_argv(run, os.path.join(tmp,
                                                              f"ck_{ck}")))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# The references, computed in the parent while the ranks run
# ---------------------------------------------------------------------------


def _host(tree):
    import flax.linen as nn
    import jax

    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _jax_vit():
    """(JAX's one-device ViT trainer, its init state, its dataset)."""
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    jmodels = importlib.import_module("distributeddeeplearning_tpu.models")
    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    cfg = _cfg("vit", VIT)
    kw = {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}
    kw["attn_impl"] = "xla"
    o = cfg.optim
    tx = jtrain.make_optimizer("adamw", o.lr, b1=o.b1, b2=o.b2,
                               weight_decay=o.weight_decay,
                               grad_clip=o.grad_clip)
    trainer = jtrain.Trainer(jmodels.get_model("vit", **kw), tx,
                             jtrain.get_task(
                                 "classification",
                                 label_smoothing=cfg.train.label_smoothing),
                             single_device_mesh(), donate=False)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return trainer, trainer.init(0, ds.batch(0)), ds


def _jax_fit(trainer, state, ds, steps):
    from distributeddeeplearning_tpu import data as jdata

    losses = []
    for _, batch in zip(range(steps), jdata.sharded_batches(ds,
                                                            trainer.mesh)):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "state": _host(state)}


def _jax_pp(job, init):
    """JAX's Trainer on one device (the stages back to back) from the
    port's init of the job's model."""
    import dataclasses

    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    cfg = _pp_cfg(job)
    kw = {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}
    o = cfg.optim
    tx = jtrain.make_optimizer(o.name, o.lr, b1=o.b1, b2=o.b2,
                               weight_decay=o.weight_decay,
                               grad_clip=o.grad_clip)
    trainer = jtrain.Trainer(
        jmodels.get_model(cfg.model.name, **{**kw, "pipeline": False}), tx,
        jtrain.get_task("lm"), single_device_mesh(), donate=False)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    state = trainer.init(0, ds.batch(0))
    state = dataclasses.replace(state, params=ts.jax_tree(init))
    out = _jax_fit(trainer, state, ds, PP_STEPS)
    return {"losses": out["losses"],
            "params": ts.flat_numpy(out["state"].params)}


def _port_cfg_one(name, base, init):
    """A config-driven dropout job's reference: one process, the same
    seed and weights, the plain attention core."""
    cfg = _cfg(name, base, ["mesh.dp=1", "model.kwargs.attn_impl=xla"])
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    state = _load_whole(init)(trainer, model)
    batches = data.sharded_batches(dataset.iter_from(0), None,
                                   cfg.train.grad_accum)
    state, hist = train.fit(trainer, state, data.prefetch(batches, "cpu"),
                            steps=cfg.train.steps, log_every=1,
                            log_fn=lambda m: None)
    return {"losses": [r["loss"] for r in hist if "loss" in r],
            "params": {k: v.detach().clone()
                       for k, v in state.params.items()}}


def _cfg_init(name, base):
    return {k: v.detach().clone() for k, v in cli.build_model(
        _cfg(name, base), "cpu").state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compositions")
    inits = {"gpt2": ts.port_init("gpt2"),
             "gpt2_moe": ts.port_init("gpt2_moe", **MOE),
             "gpt2_drop": ts.port_init("gpt2", **DROP),
             "gpt2_moe_drop": ts.port_init("gpt2_moe", **DROP, **MOE)}
    inits.update({job: _cfg_init(PP_JOBS[job][0], PP + [
        f"model.kwargs.num_stages={PP_JOBS[job][1]}"]) for job in PP_JOBS})
    inits.update({job: _cfg_init(name, base)
                  for job, (name, base, _) in CFG_DROPS.items()})
    vit = _jax_vit()
    inits["vit"] = _host(vit[1])
    torch.save(inits, tmp / "inits.pt")

    def parent():
        refs = {
            "gpt2_dots": ts.jax_run("gpt2", inits["gpt2"], remat="dots"),
            "gpt2_bf16_full": ts.jax_run("gpt2", inits["gpt2"],
                                         precision="bf16_full"),
            "gpt2_moe_sgd": ts.jax_run("gpt2_moe", inits["gpt2_moe"],
                                       optim="sgd", **MOE),
            "vit": _jax_fit(*vit, VIT_STEPS),
        }
        refs.update({job: _jax_pp(job, inits[job]) for job in PP_JOBS})
        r = ts.port_run("gpt2", None, inits["gpt2"], tx=_lp_tx())
        refs["lp"] = {"losses": r["losses"], "params": r["params"],
                      "opt": {m: {k: v.clone() for k, v in getattr(
                          r["state"].opt_state, m).items()}
                          for m in ("mu", "nu")}}
        for name in ("gpt2", "gpt2_moe"):
            kw = {**DROP, **(MOE if name == "gpt2_moe" else {})}
            r = ts.port_run(name, None, inits[name + "_drop"], model_kw=kw)
            refs[name + "_drop"] = {"losses": r["losses"],
                                    "params": r["params"]}
        for job, (name, base, _) in CFG_DROPS.items():
            refs[job] = _port_cfg_one(name, base, inits[job])
        refs["bench_vit"] = _records(_cli(_cli_argv(
            "benchmark_vit", tmp / "ck_one", ["mesh.tp=1", "mesh.cp=1"])))
        return refs

    ranks, refs = ts.spawn(_worker, 4, tmp, ts.free_ports(len(CLI_RUNS)),
                           parent=parent)
    return ranks, refs, inits, tmp


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", [j for j in JOBS if "bf16" not in j])
def test_losses_and_params_match_jax(run, job):
    ranks, refs, _, _ = run
    want = refs[JOBS[job][3]]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
    ts.assert_params_close(ranks[0][job]["params"], want["params"])


@pytest.mark.parametrize("job", [j for j in JOBS if "sgd" in j])
def test_sgd_momentum_over_a_rank_s_experts_matches_optax(run, job):
    """The trace of every leaf, the experts' put back together over ep,
    against optax's: the clipped gradients' sum with momentum, so a norm
    that missed an ep, tp or fsdp block shows in every leaf."""
    ranks, refs, _, _ = run
    node = weights._find_node(refs["gpt2_moe_sgd"]["opt_state"], ("trace",))
    want = weights.from_jax_params(node.trace)
    got = ranks[0][job]["opt"]["trace"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=ts.RTOL, atol=ts.ATOL, err_msg=k)
    assert all(m["moe_dropped_frac"] > 0.1
               for m in refs["gpt2_moe_sgd"]["metrics"])
    for r in ranks:
        np.testing.assert_allclose(
            [m["moe_dropped_frac"] for m in r[job]["metrics"]],
            [m["moe_dropped_frac"] for m in refs["gpt2_moe_sgd"]["metrics"]],
            rtol=ts.RTOL, atol=ts.ATOL)


def _update_rel_diff(got, want, init):
    """|| (got - init) - (want - init) || / || want - init ||, the key
    biases left out (their gradient is zero but for rounding in both
    packages)."""
    keys = [k for k in want if not k.endswith("key.bias")]
    num = sum(float((got[k] - want[k]).pow(2).sum()) for k in keys)
    den = sum(float((want[k] - init[k]).pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_bf16_full_under_tp_and_fsdp_matches_jax(run):
    """bf16 compute and bf16 moments at tp2 x fsdp2 against JAX's
    ``bf16_full`` on one device: ``tests/test_torch_precision.py``'s
    bounds (losses 2e-4, the update within 10% in norm)."""
    ranks, refs, inits, _ = run
    job = "gpt2_bf16_full_tp2_fsdp2"
    want = refs["gpt2_bf16_full"]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=2e-4)
    got = ranks[0][job]
    assert all(v.dtype == torch.bfloat16 for v in got["opt"]["mu"].values())
    assert _update_rel_diff(got["params"], want["params"],
                            inits["gpt2"]) < 0.1


@pytest.mark.parametrize("job", list(LP))
def test_low_precision_adamw_over_blocks_equals_one_process(run, job):
    """fp32 compute with the bf16 moments of ``LowPrecisionAdamW`` (the
    bf16 compute's noise left out) against the port's one process on the
    same batches: the losses within 1e-5, the params within 5e-5, and the
    bf16 moments equal but for under 1% of the elements, which a last-bit
    difference of the fp32 gradient's summation order moves across a
    stochastic-rounding boundary (those within one bf16 ulp, or 1% of the
    leaf's largest moment where a first moment near zero moves by more
    than its own size: ``tests/test_torch_precision.py``'s bound; the key
    biases, zero but for rounding, left out). Bits drawn for a rank's
    block instead of its block of the whole leaf's would round far more of
    them apart."""
    ranks, refs, _, _ = run
    want = refs["lp"]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=1e-5)
    got = ranks[0][job]
    for k, p in want["params"].items():
        torch.testing.assert_close(got["params"][k], p, rtol=0, atol=5e-5,
                                   msg=k)
    for m in ("mu", "nu"):
        n = diff = 0
        for k, v in want["opt"][m].items():
            g = got["opt"][m][k]
            assert g.dtype == v.dtype == torch.bfloat16, k
            if k.endswith("key.bias"):
                continue  # zero but for rounding (softmax ignores a shift)
            torch.testing.assert_close(
                g.float(), v.float(), rtol=2 ** -7,
                atol=1e-2 * float(v.float().abs().max()), msg=f"{m} {k}")
            n, diff = n + v.numel(), diff + int((g != v).sum())
        assert diff < 0.01 * n, (m, diff, n)


@pytest.mark.parametrize("job", list(PP_JOBS))
def test_pipelines_match_jax_with_the_tables_cut(run, job):
    """gpt2_pp and llama_pp at pp alone (and beside dp): every rank holds
    ``ceil(64 / pp)`` rows of each table (JAX's ``vocab_pp``), and the
    Trainer matches JAX's sequential stages on one device."""
    ranks, refs, _, _ = run
    name, S, _ = PP_JOBS[job]
    want = refs[job]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=2e-5)
        tables = r[job]["tables"]
        assert set(tables) == set(TABLES[name]), tables
        for k, d in TABLES[name].items():
            assert tables[k][d] == 64 // S, (k, tables[k])
    ts.assert_params_close(ranks[0][job]["params"], want["params"])


def test_pp4_save_restores_at_dp2_tp2_and_at_pp1_bit_for_bit(run):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    ranks, _, _, tmp = run
    whole = ranks[0][SAVED_PP]["params"]
    with CheckpointManager(str(tmp / "ck_pp")) as ck:
        host, _ = ck._load(ck.latest_step())
    assert set(host["params"]) == set(whole)
    for k, v in whole.items():
        assert torch.equal(host["params"][k], v), k
    got = ranks[0]["restore_pp"]
    assert got["step"] == PP_STEPS
    for k, v in whole.items():
        assert torch.equal(got["params"][k], v), k
    for m in ("mu", "nu"):
        for k, v in got["moments"][m].items():
            assert torch.equal(v, host[m][k]), (m, k)
    cfg = _pp_cfg(SAVED_PP, ["mesh.dp=1", "mesh.pp=1",
                             "model.kwargs.pipeline=False"])
    _, trainer, _ = cli.build_all(cfg, "cpu", single_device_mesh())
    with CheckpointManager(str(tmp / "ck_pp")) as ck:
        state, _ = ck.restore(trainer.init(0))
    for k, v in whole.items():
        assert torch.equal(state.params[k], v), k
    for m in ("mu", "nu"):
        for k, v in getattr(state.opt_state, m).items():
            assert torch.equal(v, host[m][k]), (m, k)


def test_bf16_moments_over_blocks_save_and_restore_in_one_process(run):
    """The tp2 x fsdp2 save of ``LowPrecisionAdamW`` holds the one-rank
    layout: restored in one process, its params and bf16 moments equal
    what the ranks held, put back together, bit for bit."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    ranks, _, _, tmp = run
    _, trainer = ts.port_trainer("gpt2", None, tx=_lp_tx())
    with CheckpointManager(str(tmp / "ck_lp")) as mgr:
        state, data_state = mgr.restore(trainer.init(0), step=ts.STEPS)
    assert data_state == {"next_index": ts.STEPS}
    assert state.opt_state.count == ts.STEPS
    got = ranks[0][SAVED_LP]
    for k, v in got["params"].items():
        assert torch.equal(state.params[k].detach(), v), k
    for m in ("mu", "nu"):
        for k, v in got["opt"][m].items():
            t = getattr(state.opt_state, m)[k]
            assert t.dtype == torch.bfloat16 and torch.equal(t, v), (m, k)


def _vit_flat(tree):
    names = {k for k, _ in cli.build_model(_cfg("vit", VIT), "cpu")
             .named_parameters()}
    return weights.to_torch_layout(weights.from_jax_params(tree), names)


@pytest.mark.parametrize("job", list(VIT_JOBS))
def test_vit_under_cp_matches_jax(run, job):
    ranks, refs, _, _ = run
    want = refs["vit"]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want["losses"],
                                   rtol=2e-5)
    ts.assert_params_close(ranks[0][job]["params"],
                           _vit_flat(want["state"].params))


@pytest.mark.parametrize("job", list(VIT_JOBS))
def test_vit_under_cp_adamw_moments_match_jax(run, job):
    """The moments hold the clipped raw gradients leaf by leaf (the zero
    head leaves the encoder no gradient on step 1, so the losses alone
    would miss a wrong CLS cotangent): rtol 2e-4 and an atol of 2e-5 of
    each leaf's largest value, floored at a thousandth of the tree's
    largest (``tests/test_torch_encoders_tp.py``'s bound)."""
    ranks, refs, _, _ = run
    node = weights._find_adam_moments(refs["vit"]["state"].opt_state)
    for m in ("mu", "nu"):
        got = ranks[0][job]["moments"][m]
        want = {k: v.numpy() for k, v in _vit_flat(getattr(node, m)).items()}
        assert set(got) == set(want)
        floor = 1e-3 * max(np.abs(v).max() for v in want.values())
        for k, v in want.items():
            np.testing.assert_allclose(
                got[k].numpy(), v, rtol=2e-4,
                atol=2e-5 * max(np.abs(v).max(), floor), err_msg=f"{m} {k}")


# ---------------------------------------------------------------------------
# Dropout against the port's one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", list(DROPS) + list(CFG_DROPS))
def test_dropout_over_the_mesh_equals_one_process(run, job):
    """Active dropout at 0.1 from the same seed: every rank's masks are its
    blocks of the one-rank masks, so the run equals one process's but for
    float summation order (a mask off by one element moves a loss by far
    more than rtol 2e-4)."""
    ranks, refs, _, _ = run
    ref = refs[job] if job in CFG_DROPS else refs[
        DROPS[job][0] + "_drop"]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], ref["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
    ts.assert_params_close(ranks[0][job]["params"], ref["params"])


def test_dropout_moves_the_losses(run):
    """The dropout jobs' reference differs from the run without dropout:
    the masks are live."""
    _, refs, _, _ = run
    drop, plain = refs["gpt2_drop"]["losses"], refs["lp"]["losses"]
    assert abs(drop[0] - plain[0]) > 1e-3


# ---------------------------------------------------------------------------
# Single process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes,cuts_of", [
    ({"dp": 2}, "act"), ({"fsdp": 2}, "act"), ({"dp": 2, "fsdp": 2}, "act"),
    ({"cp": 2}, "act"), ({"tp": 2}, "act"), ({"cp": 2, "tp": 2}, "sp"),
    ({"tp": 2}, "sp_uneven"), ({"tp": 2}, "heads"),
    ({"tp": 2, "cp": 2}, "ulysses")])
def test_global_rand_is_the_block_of_the_one_rank_draw(axes, cuts_of):
    """Each rank's uniforms are its block of the draw one process makes
    from the same generator: the batch over (dp, fsdp), the sequence over
    cp and under sequence parallelism over (cp, tp), the last shard of an
    uneven one padded with zeros, the heads over tp or (tp, cp)."""
    from distributeddeeplearning_tpu_torch.models import transformer as tr

    B, L, E, H = 4, 12, 3, 4
    seq_len = None
    if cuts_of == "sp_uneven":
        L = 11  # 6 + 5 over tp, the second shard padded
    whole = torch.rand((B, L, E) if cuts_of not in ("heads", "ulysses")
                       else (B, H, L, L),
                       generator=torch.Generator().manual_seed(7))
    n = 1
    for s in axes.values():
        n *= s
    for rank in range(n):
        mesh = Mesh(axes, rank)
        c = mesh.coords
        bn = B // (mesh.shape["dp"] * mesh.shape["fsdp"])
        b0 = (c["dp"] * mesh.shape["fsdp"] + c["fsdp"]) * bn
        if cuts_of in ("heads", "ulysses"):
            heads = ("tp",) if cuts_of == "heads" else ("tp", "cp")
            hn = H // (mesh.shape["tp"] * (mesh.shape["cp"]
                                           if cuts_of == "ulysses" else 1))
            h0 = (c["tp"] * (mesh.shape["cp"] if cuts_of == "ulysses"
                             else 1) + (c["cp"] if cuts_of == "ulysses"
                                        else 0)) * hn
            shape, cuts = (bn, hn, L, L), tr.head_cuts(heads)
            want = whole[b0:b0 + bn, h0:h0 + hn]
        else:
            sp = cuts_of != "act"
            lc = L // mesh.shape["cp"]
            if sp:
                seq_len = lc if cuts_of == "sp_uneven" else None
                ln = -(-lc // mesh.shape["tp"])
                s0 = c["cp"] * lc + c["tp"] * ln
                valid = min(ln, lc - c["tp"] * ln)
            else:
                ln, s0, valid = lc, c["cp"] * lc, lc
            shape = (bn, ln, E)
            cuts = tr.act_cuts(mesh, sp, seq_len)
            want = torch.zeros(shape)
            want[:, :valid] = whole[b0:b0 + bn, s0:s0 + valid]
        got = tr._global_rand(shape, torch.Generator().manual_seed(7),
                              "cpu", mesh, cuts)
        assert torch.equal(got, want), (axes, cuts_of, rank)


def _tiny_gpt2(impl, mesh):
    model = models.get_model("gpt2", size="tiny", vocab_size=32, max_len=16,
                             attn_impl=impl, dropout_rate=0.1, mesh=mesh)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("impl,msg", [
    ("ring", "ring attention supports mask=None and no active "
             "attention-dropout"),
    ("ring_pallas", "ring attention supports mask=None and no active "
                    "attention-dropout"),
    ("ulysses_flash", "ulysses_flash supports mask=None and no active "
                      "attention-dropout"),
    ("flash", "flash attention supports no active attention-dropout")])
def test_attention_dropout_on_a_fused_or_ring_core_is_refused_in_jax_words(
        impl, msg):
    """The reference's refusals stay: those cores take no active attention
    dropout (``models/transformer.py`` of the JAX package)."""
    model = _tiny_gpt2(impl, Mesh({"cp": 1}))
    with pytest.raises(NotImplementedError, match=rf"^{msg}$"):
        model(torch.zeros(1, 4, dtype=torch.long), train=True,
              generator=torch.Generator().manual_seed(0))
    # Deterministic (no generator): the same core runs.
    assert model(torch.zeros(1, 4, dtype=torch.long)).shape == (1, 4, 32)


@pytest.mark.parametrize("impl", CORES)
def test_vit_l16_197_tokens_under_cp_keep_jax_error(impl):
    """ViT-L/16 at 224² has 197 tokens, which cp=2 does not divide: the
    reference's ``seq % cp`` error, while 226 tokens (240²) build."""
    core = "ring" if impl.startswith("ring") else "ulysses"
    with pytest.raises(ValueError, match=rf"^{core}: seq_len=197 not "
                       r"divisible by cp=2$"):
        models.get_model("vit", mesh=Mesh({"cp": 2}), attn_impl=impl,
                         device="meta")
    model = models.get_model("vit", mesh=Mesh({"cp": 2}), attn_impl=impl,
                             image_size=240, device="meta")
    assert model.pos_embed.shape[0] == 226


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


def test_cli_trains_and_evaluates_the_compositions(run):
    """``cli train`` on configs/gpt2_owt.py with dropout, remat 'dots' and
    bf16_full at tp2 x fsdp2 with SP (a save at step 2), ``cli eval`` of it
    at dp2 x fsdp2; gpt2_moe with SGD at dp2 x ep2; ViT at tp2 x cp2 on
    ``ring_pallas``."""
    import math

    ranks, _, _, _ = run
    for name, meshes in (("train_gpt2", ("'tp': 2", "'fsdp': 2")),
                         ("train_moe_sgd", ("'ep': 2",)),
                         ("train_vit", ("'tp': 2", "'cp': 2"))):
        text = ranks[0][f"cli_{name}"]
        assert all(m in text for m in meshes), name
        recs = [r for r in _records(text) if "loss" in r]
        assert [r["step"] for r in recs] == [1, 2], name
        assert all(math.isfinite(r["loss"]) for r in recs), name
    assert "evaluating checkpoint at step 2" in ranks[0]["cli_eval_gpt2"]
    assert math.isfinite(_records(ranks[0]["cli_eval_gpt2"])[-1][
        "eval_loss"])


def test_benchmark_counts_vit_under_cp_once(run):
    """At tp2 x cp2 a cp rank embeds and encodes its block of the tokens
    (its tp rank's heads and units, the patch embedding whole on each tp
    rank) and runs its head's classes on the CLS token every cp rank
    reads: the FLOPs a step summed over the ranks equal one process's on
    the same global batch."""
    ranks, refs, _, _ = run
    rec = _records(ranks[0]["cli_benchmark_vit"])[-1]
    one = refs["bench_vit"][-1]
    assert rec["device_count"] == 4
    assert rec["model_tflops_per_step"] == pytest.approx(
        one["model_tflops_per_step"], rel=1e-9)


@pytest.mark.parametrize("name", ["gpt2", "vit"])
def test_remat_under_mixed_precision_recomputes_on_the_compute_copies(name):
    """A bf16 step differentiates the model's bf16 compute copies; the
    backward recomputes a checkpointed block on those copies, not on the
    fp32 masters swapped back by then, so 'dots' (whose policy matches the
    recompute op for op) and 'full' give 'none''s step exactly."""
    cfg = ["model.kwargs.size=tiny", "train.precision.policy=bf16",
           "optim.name=adamw", "optim.warmup_steps=0", "train.steps=2"]
    if name == "gpt2":
        cfg += ["model.kwargs.vocab_size=64", "model.kwargs.max_len=32",
                "data.vocab_size=64", "data.seq_len=16", "data.batch_size=4",
                "model.kwargs.attn_impl=xla"]
    else:
        cfg += ["model.kwargs.image_size=16", "data.image_size=16",
                "model.kwargs.num_classes=11", "data.num_classes=11",
                "data.batch_size=4"]
    runs = {}
    for remat in ("none", "full", "dots"):
        c = _cfg(name, cfg + [f"train.remat={remat}"])
        _, trainer, dataset = cli.build_all(c, "cpu")
        state = trainer.init(0)
        state, hist = train.fit(trainer, state, data.prefetch(
            dataset.iter_from(0), "cpu"), steps=2, log_every=1,
            log_fn=lambda m: None)
        runs[remat] = ([r["loss"] for r in hist],
                       {k: v.detach().clone()
                        for k, v in state.params.items()})
    for remat in ("full", "dots"):
        assert runs[remat][0] == runs["none"][0], remat
        for k, v in runs["none"][1].items():
            assert torch.equal(runs[remat][1][k], v), (remat, k)
