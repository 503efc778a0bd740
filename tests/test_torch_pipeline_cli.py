"""The pipelined configs through the port's entry points, on the CPU, and
the pipeline's fences, configs, HF restacking and bf16 hold.

- One spawn of 4 gloo ranks runs, as ``torchrun`` would, ``cli train``
  (2 steps, evaluation and a checkpoint at step 2, ``--sync-steps``),
  ``cli eval`` and ``cli benchmark`` on ``configs/gpt2_pp.py`` at pp=4 and
  on ``configs/bert_pp.py`` at pp=2 x dp=2 (padded rows), both shrunk by
  overrides as the JAX package's tests shrink them; then ``cli eval`` in
  one process at pp=1 evaluates the pp=4 checkpoint, as the 4 ranks did.
- Every fence the JAX package puts on pipelined models raises its
  exception type here; the knobs not ported beside ``mesh.pp`` are refused
  naming ROADMAP A13 (``mesh.tp`` and ``mesh.fsdp`` beside it run:
  ``tests/test_torch_pp_tp.py``).
- The two configs are the JAX package's; ``hf_port.to_pipelined`` gives
  JAX's tree on a tiny GPT-2 and a tiny Llama, and ``validate_params``
  takes it for a pipeline rank's model.
- bf16: the port's ``bert_pp`` loss and logits against JAX's bf16
  ``PipelinedBERT`` on the same weights, within two bf16 roundings.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, hf_port, models, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import Mesh
from distributeddeeplearning_tpu_torch.parallel import pp

torch.set_num_threads(2)

GPT2_PP = "distributeddeeplearning_tpu_torch/configs/gpt2_pp.py"
BERT_PP = "distributeddeeplearning_tpu_torch/configs/bert_pp.py"
GPT2_TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
    "model.kwargs.max_len=32", "model.kwargs.num_microbatches=2",
    "data.vocab_size=64", "data.seq_len=16", "data.batch_size=8",
    "optim.warmup_steps=1",
]
BERT_TINY = [
    "model.kwargs.size=tiny", "model.kwargs.max_len=32",
    "model.kwargs.num_layers=4", "model.kwargs.vocab_size=64",
    "model.kwargs.num_microbatches=2", "data.batch_size=8",
    "data.seq_len=16", "data.vocab_size=64", "data.pad_min_len=5",
    "optim.warmup_steps=1",
]
RUNS = {"gpt2": (GPT2_PP, GPT2_TINY + ["mesh.pp=4"]),
        "bert": (BERT_PP, BERT_TINY + ["model.kwargs.num_stages=2",
                                       "mesh.pp=2", "mesh.dp=2"])}
LIFE = ["train.steps=2", "train.log_every=1", "train.eval_every=2",
        "train.eval_batches=1", "train.save_every=2"]


def _argv(cmd, config, overrides, *extra):
    argv = [cmd, "--config", config, "--device", "cpu", *extra]
    for o in overrides:
        argv += ["--override", o]
    return argv


def _worker(rank, world, ports, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost")
    out, i = {}, 0
    for name, (config, overrides) in RUNS.items():
        ck = os.path.join(out_dir, f"{name}_ckpt")
        over = overrides + [f"train.checkpoint_dir={ck}",
                            f"train.log_dir={out_dir}/{name}_logs"]
        for cmd, extra in (("train", ["--sync-steps"]), ("eval", []),
                           ("benchmark", ["--steps", "2", "--latency-steps",
                                          "1", "--probe", "0"])):
            os.environ["MASTER_PORT"] = str(ports[i])
            i += 1
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(_argv(
                    cmd, config, over + (LIFE if cmd == "train" else []),
                    *extra)) == 0
            out[f"{name}_{cmd}"] = buf.getvalue()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for so in socks:
        so.bind(("localhost", 0))
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    return ports


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppcli")
    torch.multiprocessing.spawn(_worker, args=(4, _free_ports(6), str(tmp)),
                                nprocs=4, join=True)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(4)]
    return ranks, tmp


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_train_under_torchrun(runs, name):
    ranks, tmp = runs
    text = ranks[0][f"{name}_train"]
    assert "dist: gloo, 4 ranks on the cpu" in text
    recs = _records(text)
    steps = [r for r in recs if "loss" in r and "eval_loss" not in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in steps)
    if name == "gpt2":
        # The interleaved step reports the reference's metrics: the loss.
        assert "perplexity" not in steps[0]
    else:
        assert "masked_fraction" in steps[0]
    assert [r["step"] for r in recs if "eval_loss" in r] == [2]
    end = next(r for r in recs if r.get("event") == "train_end")
    S = 4 if name == "gpt2" else 2
    M = 2
    for r in end["ranks"]:
        assert r["losses"] == end["ranks"][0]["losses"]
        ticks = r["pipeline"]
        # Training ticks a step (interleaved M + 2(S-1); gpipe / 1f1b's
        # forward and backward M + S - 1 each), then the evaluation's
        # forward (M + S - 1).
        per_step = M + 2 * (S - 1) if name == "gpt2" else 2 * (M + S - 1)
        assert ticks["train_ticks"] == 2 * per_step, ticks
        assert ticks["eval_ticks"] == M + S - 1, ticks
        assert ticks["train_transport_bytes"] > 0
    assert all(r == "" for rk in ranks[1:] for r in [rk[f"{name}_train"]])
    host = torch.load(tmp / f"{name}_ckpt" / "2" / "state.pt",
                      weights_only=True)
    stack = "h" if name == "gpt2" else "encoder"
    leaf = host["params"][f"{stack}.stages.block_0.attn.query.kernel"]
    assert leaf.shape[0] == S


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_eval_and_benchmark_under_torchrun(runs, name):
    ranks, _ = runs
    ev = ranks[0][f"{name}_eval"]
    assert "evaluating checkpoint at step 2" in ev
    (rec,) = _records(ev)
    assert rec["step"] == 2 and np.isfinite(rec["eval_loss"])
    (bench,) = _records(ranks[0][f"{name}_benchmark"])
    config, overrides = RUNS[name]
    cfg = apply_overrides(load_config(config), overrides + ["mesh.pp=1",
                                                            "mesh.dp=1"])
    whole = models.get_model(cfg.model.name, **cfg.model.kwargs)
    assert bench["params"] == sum(p.numel() for p in whole.parameters())
    assert bench["device_count"] == 4 and bench["value"] > 0
    assert bench["model_tflops_per_step"] > 0


def test_cli_eval_at_pp1_restores_the_pp4_checkpoint(runs, capsys):
    ranks, tmp = runs
    over = GPT2_TINY + ["mesh.pp=1", f"train.checkpoint_dir={tmp}/gpt2_ckpt"]
    assert cli.main(_argv("eval", GPT2_PP, over)) == 0
    out = capsys.readouterr().out
    assert "evaluating checkpoint at step 2" in out
    (rec,) = _records(out)
    (want,) = _records(ranks[0]["gpt2_eval"])
    np.testing.assert_allclose(rec["eval_loss"], want["eval_loss"],
                               rtol=1e-5)


# --- fences --------------------------------------------------------------


def _mesh(**axes):
    return Mesh({a: axes.get(a, 1) for a in
                 ("dp", "fsdp", "pp", "tp", "cp", "ep")})


def _tiny(name="gpt2_pp", mesh=None, **kw):
    kw.setdefault("num_stages", 2)
    return models.get_model(name, size="tiny", vocab_size=64, max_len=32,
                            num_microbatches=2, mesh=mesh, **kw)


def _trainer(model, mesh=None, **kw):
    tx = train.make_optimizer("adamw", 1e-3)
    return train.Trainer(model, tx, train.get_task("lm", mesh=mesh),
                         device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("axis", ["cp", "ep"])
def test_pipeline_x_cp_or_ep_is_refused(axis):
    mesh = _mesh(pp=2, **{axis: 2})
    with pytest.raises(NotImplementedError, match=f"pipeline x {axis}"):
        _trainer(_tiny(mesh=mesh), mesh)


def test_mixed_precision_x_pipelined_model_is_refused():
    with pytest.raises(NotImplementedError, match="x pipelined model"):
        _trainer(_tiny(dtype="bfloat16"), precision="bf16")


def test_pp_with_a_model_that_is_not_pipelined_is_refused():
    mesh = _mesh(pp=2)
    model = models.get_model("gpt2", size="tiny", vocab_size=64, max_len=32,
                             mesh=mesh)
    with pytest.raises(ValueError, match="is not pipelined"):
        _trainer(model, mesh)


@pytest.mark.parametrize("override", [
    "train.grad_comm=int8", "train.grad_bucket_mb=4.0",
    "train.update_sharding=sharded", "mesh.dcn_dp=2",
])
def test_unported_knobs_beside_pp_are_refused(override):
    cfg = apply_overrides(load_config(GPT2_PP), GPT2_TINY + [override])
    with pytest.raises(NotImplementedError, match="ROADMAP queue A13"):
        cli.check_train_composition(cfg, world_size=8)


def test_pp_is_accepted():
    cfg = apply_overrides(load_config(GPT2_PP), GPT2_TINY)
    cli.check_train_composition(cfg, world_size=4)


def test_remat_is_refused_on_pipelined_models():
    cfg = apply_overrides(load_config(GPT2_PP),
                          GPT2_TINY + ["mesh.pp=1", "train.remat=full"])
    with pytest.raises(ValueError, match="does not support remat"):
        cli.build_all(cfg, "cpu")


def test_stage_fences():
    x = torch.zeros(2, 8, 64)
    mask = torch.ones(2, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="dropout inside pipeline"):
        pp_stack = _tiny().h.__class__(
            4, 2, 2, 64, 4, 16, 256, dropout_rate=0.1)
        pp_stack(x, train=True)
    with pytest.raises(NotImplementedError, match="gpipe"):
        _tiny(schedule="1f1b_interleaved").h(x, mask)
    with pytest.raises(NotImplementedError, match="gpipe"):
        _tiny("bert_pp", schedule="1f1b_interleaved")
    with pytest.raises(NotImplementedError, match="causal"):
        _tiny("llama_pp").h(x, mask)
    with pytest.raises(ValueError, match="key-padding"):
        _tiny().h(x, mask[:, None])
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        _tiny(schedule="zb")
    with pytest.raises(ValueError, match="mesh pp=4 != num_stages=2"):
        _tiny(mesh=_mesh(pp=4))
    with pytest.raises(ValueError, match="not divisible"):
        _tiny().h(torch.zeros(3, 8, 64))


# --- configs, hf_port, bf16 -----------------------------------------------


@pytest.mark.parametrize("name", ["gpt2_pp", "bert_pp"])
def test_config_is_the_jax_package_s(name):
    from distributeddeeplearning_tpu import config as jax_config

    ours = load_config(f"distributeddeeplearning_tpu_torch/configs/{name}.py")
    theirs = jax_config.load_config(f"configs/{name}.py")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_to_pipelined_is_the_jax_package_s(name):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import hf_port as jhf
    from distributeddeeplearning_tpu import models as jm

    from distributeddeeplearning_tpu_torch.weights import (
        from_jax_params,
        rank_rows,
        rank_shards,
    )

    kw = dict(size="tiny", vocab_size=64, max_len=32)
    if name == "gpt2":
        kw["num_layers"] = 4
    else:
        kw["num_layers"] = 4
    flat = jax.tree.map(np.asarray, nn.meta.unbox(jm.get_model(
        name, **kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
        ["params"]))
    want = jax.tree.map(np.asarray, jhf.to_pipelined(flat, 2))
    got = hf_port.to_pipelined(flat, 2)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # A pipeline rank's model takes the stacked tree and its rows of it.
    for mesh in (None, _mesh(pp=2)):
        model = models.get_model(f"{name}_pp", **kw, num_stages=2,
                                 num_microbatches=2, mesh=mesh)
        hf_port.validate_params(model, got)
        model.load_state_dict(rank_shards(rank_rows(
            from_jax_params(got), model.stage_rows), model.shards),
            strict=True)
    with pytest.raises(ValueError, match="not divisible"):
        hf_port.to_pipelined(flat, 3)
    with pytest.raises(ValueError, match="shape mismatches"):
        hf_port.validate_params(model, hf_port.to_pipelined(flat, 4))


def test_bf16_bert_pp_loss_matches_jax():
    """bf16 compute over the same fp32 weights, at pp=1: both packages
    round the projections, the residual stream and the head's output to
    bf16, so the logits may sit two bf16 roundings apart (rtol 2**-6 plus
    atol 1e-2), and the loss two roundings (rtol 2**-6)."""
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import models as jm
    from distributeddeeplearning_tpu.train import get_task as jget_task

    from test_torch_pipeline_models import global_batch, jax_tree

    kw = dict(size="tiny", vocab_size=64, max_len=32, num_layers=4,
              num_stages=2, num_microbatches=2, dtype="bfloat16")
    model = models.get_model("bert_pp", **kw)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = global_batch("mlm")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    task = train.get_task("mlm")
    with torch.no_grad():
        logits = model(tb["input_tokens"], tb["attention_mask"])
        loss = float(task.loss_fn(logits, tb)[0])
    jmod = jm.get_model("bert_pp", **{**kw, "dtype": jnp.bfloat16})
    params = jax.tree.map(jnp.asarray, jax_tree(
        {k: v.detach() for k, v in model.state_dict().items()}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = jmod.apply({"params": params}, jb["input_tokens"],
                         jb["attention_mask"])
    jloss = float(jget_task("mlm").loss_fn(jlogits, jb)[0])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2 ** -6, atol=1e-2)
    np.testing.assert_allclose(loss, jloss, rtol=2 ** -6)
    # bf16 is load-bearing: the fp32 forward is elsewhere.
    f32 = models.get_model("bert_pp", **{**kw, "dtype": "float32"})
    f32.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert not torch.equal(f32(tb["input_tokens"], tb["attention_mask"]),
                               logits)


def test_rows_gather_is_a_no_op_on_one_rank():
    rows = pp.StageRows({"a"}, 2, 0, 2)
    tree = {"a": torch.ones(2, 3), "b": torch.zeros(4)}
    assert rows.gather(tree) is tree
    assert rows.whole_shape("a", (1, 3)) == (2, 3)
    assert rows.whole_shape("b", (4,)) == (4,)
