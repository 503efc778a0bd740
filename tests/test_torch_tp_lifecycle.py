"""The lifecycle of a model cut over tp and fsdp in the port, against the
JAX package where it has a counterpart (``tests/torch_sharded.py``'s
setting), on 4 gloo ranks spawned once:

- checkpoints: a save at tp2 x fsdp2 (step 2) holds the one-rank layout
  (the keys and shapes of the one-rank model's params and Adam moments,
  which are JAX's); restored at dp2 x tp2 with ZeRO-1 every rank's blocks
  and moment shards are the saved ones bit for bit, and saved again from
  there the file holds the same trees bit for bit; restored on one rank
  (here) the params and moments are the saved ones bit for bit;
- ``evaluate`` at tp = 2 (beside dp = 2) after 5 steps against JAX's
  ``evaluate`` on the same eval batches;
- the bf16 policy at tp = 2: losses within two bf16 roundings (rtol
  2**-6) of JAX's bf16 run;
- ``grad_accum=2`` at tp = 2 against JAX's grad_accum=2;
- the health guard at tp2 x fsdp2: each step's ``grad_norm`` (the whole
  model's, each block and each replicated leaf counted once) against
  JAX's guard, rtol 2e-4, and above the clip of 0.05;
- ``cli train`` under ``torchrun --nproc_per_node 4`` on gpt2_owt at tp2 x
  fsdp2 with sequence parallelism, ``cli benchmark`` on llama_lm at dp2 x
  tp2 (its FLOPs summed over tp: half the one-rank step's), and ``cli
  generate`` and ``cli serve`` restoring the tp2 x fsdp2 save on one
  rank, at the tiny size;
- each composition the port does not hold refused by name (ROADMAP queue
  A13), before anything runs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharded as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVE_AXES = dict(dp=1, tp=2, fsdp=2)
DP_TP = dict(dp=2, tp=2)


def _worker(rank, world, port, tmp, init):
    from distributeddeeplearning_tpu_torch import data, train
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    init = torch.load(init)
    out = {}
    ck = os.path.join(tmp, "ckpt")
    # Save at tp2 x fsdp2 (step 2).
    mesh = build_mesh(MeshConfig(**SAVE_AXES))
    _, trainer = ts.port_trainer("gpt2", mesh)
    state = trainer.init(0)
    ts.load_whole(state, init)
    ds = data.SyntheticTokens(**ts.DATA)
    with CheckpointManager(ck) as mgr:
        state, _ = train.fit(trainer, state, data.prefetch(
            data.sharded_batches(ds.iter_from(0), mesh), "cpu"), steps=2,
            log_every=1, log_fn=lambda m: None, ckpt=mgr, save_every=2)
    # Restored at dp2 x tp2 with ZeRO-1: this rank's blocks and shards.
    mesh = build_mesh(MeshConfig(**DP_TP))
    _, trainer = ts.port_trainer("gpt2", mesh, zero1=True)
    state = trainer.init(0)
    with CheckpointManager(ck) as mgr:
        state, _ = mgr.restore(state, step=2)
    out["restored"] = {
        "step": state.step, "count": state.opt_state.count,
        "params": {k: v.detach().clone() for k, v in state.params.items()},
        "mu": {g: v.clone() for g, v in state.opt_state.mu.items()},
        "coords": mesh.coords}
    # Saved again from dp2 x tp2 with ZeRO-1: the moments gathered over dp,
    # then every tp block put together.
    with CheckpointManager(os.path.join(tmp, "again")) as mgr:
        mgr.save(2, state, {"next_index": 2})
    runs = {"eval": ("gpt2", DP_TP, {}), "bf16": ("gpt2", DP_TP,
                                                  {"precision": "bf16"}),
            "accum": ("gpt2", DP_TP, {"grad_accum": 2}),
            "guard": ("gpt2", SAVE_AXES, {"health": True})}
    for job, (name, axes, kw) in runs.items():
        mesh = build_mesh(MeshConfig(**axes))
        r = ts.port_run(name, mesh, init, **kw)
        out[job] = {k: r[k] for k in ("losses", "metrics")}
        if job == "eval":
            eds = data.SyntheticTokens(**{**ts.DATA, "seed": 1})
            out[job]["eval"] = train.evaluate(r["trainer"], r["state"], (
                {k: torch.from_numpy(v) for k, v in b.items()}
                for _, b in zip(range(2), data.sharded_batches(
                    eds.iter_from(0), mesh))))
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tplife")
    init = ts.port_init("gpt2")
    torch.save(init, tmp / "init.pt")

    def parent():
        return {"fp32": ts.jax_run("gpt2", init, health=True, evals=2),
                "bf16": ts.jax_run("gpt2", init, precision="bf16"),
                "accum": ts.jax_run("gpt2", init, grad_accum=2)}

    ranks, ref = ts.spawn(_worker, 4, tmp, str(tmp / "init.pt"),
                          parent=parent)
    return ranks, ref, tmp


def _one_rank_state():
    _, trainer = ts.port_trainer("gpt2", None)
    return trainer.init(0)


def test_save_at_tp2_fsdp2_is_in_the_one_rank_layout(run):
    _, _, tmp = run
    host = torch.load(tmp / "ckpt" / "2" / "state.pt", weights_only=True)
    one = _one_rank_state()
    for tree in ("params", "mu", "nu"):
        assert {k: tuple(v.shape) for k, v in host[tree].items()} == {
            k: tuple(v.shape) for k, v in one.params.items()}, tree
    assert host["step"] == 2 and host["count"] == 2


def test_restore_at_dp2_tp2_zero1_is_bit_exact(run):
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroLayout
    from distributeddeeplearning_tpu_torch.weights import rank_shards

    ranks, _, tmp = run
    host = torch.load(tmp / "ckpt" / "2" / "state.pt", weights_only=True)
    for rank, r in enumerate(ranks):
        got = r["restored"]
        assert got["step"] == 2 and got["count"] == 2
        mesh = Mesh(DP_TP, rank=rank)  # its shape alone: no transport
        assert mesh.coords == got["coords"]
        model, _ = ts.port_trainer("gpt2", mesh)
        local = rank_shards(host["params"], model.shards)
        for k, v in got["params"].items():
            assert torch.equal(v, local[k]), k
        layout = ZeroLayout(dict(model.named_parameters()), mesh)
        want = layout.shard(rank_shards(host["mu"], model.shards))
        for g, v in got["mu"].items():
            assert torch.equal(v, want[g]), g


def test_save_at_dp2_tp2_zero1_equals_the_restored_save(run):
    _, _, tmp = run
    a = torch.load(tmp / "ckpt" / "2" / "state.pt", weights_only=True)
    b = torch.load(tmp / "again" / "2" / "state.pt", weights_only=True)
    for tree in ("params", "mu", "nu"):
        assert set(a[tree]) == set(b[tree])
        for k, v in a[tree].items():
            assert torch.equal(v, b[tree][k]), (tree, k)


def test_restore_on_one_rank_is_bit_exact(run):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    _, _, tmp = run
    host = torch.load(tmp / "ckpt" / "2" / "state.pt", weights_only=True)
    state = _one_rank_state()
    with CheckpointManager(str(tmp / "ckpt")) as mgr:
        state, data_state = mgr.restore(state, step=2)
    assert data_state == {"next_index": 2} and state.step == 2
    for k, v in host["params"].items():
        assert torch.equal(state.params[k], v), k
        assert torch.equal(state.opt_state.mu[k], host["mu"][k]), k
        assert torch.equal(state.opt_state.nu[k], host["nu"][k]), k


@pytest.mark.parametrize("cmd", ["generate", "serve"])
def test_cli_restores_the_tp2_fsdp2_save_on_one_rank(run, cmd, capsys):
    """``cli generate`` and ``cli serve`` on one rank restore the save of
    the tp2 x fsdp2 run (the tiny model's byte vocabulary), whatever the
    config's mesh says."""
    from distributeddeeplearning_tpu_torch import cli

    _, _, tmp = run
    argv = [cmd, "--config",
            f"{ROOT}/distributeddeeplearning_tpu_torch/configs/gpt2_owt.py",
            "--device", "cpu", "--prompt", "hi", "--max-new-tokens", "2"]
    for o in ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
              "model.kwargs.max_len=64", "model.kwargs.attn_impl=xla",
              "serving.prompt_buckets=(16,32)", "mesh.tp=2", "mesh.fsdp=2",
              "train.sequence_parallel=true",
              f"train.checkpoint_dir={tmp / 'ckpt'}"]:
        argv += ["--override", o]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "from checkpoint at step 2" in out
    assert json.loads(out.strip().splitlines()[-1])["step"] == 2


def test_evaluate_at_tp2_matches_jax(run):
    ranks, ref, _ = run
    want = ref["fp32"]["eval"]
    for r in ranks:
        np.testing.assert_allclose(r["eval"]["losses"], ref["fp32"]["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
        got = r["eval"]["eval"]
        for k in ("eval_loss", "eval_perplexity"):
            np.testing.assert_allclose(got[k], want[k], rtol=ts.RTOL,
                                       atol=ts.ATOL, err_msg=k)


def test_bf16_policy_at_tp2_within_two_bf16_roundings_of_jax(run):
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["bf16"]["losses"], ref["bf16"]["losses"],
                                   rtol=2 ** -6)
        assert r["bf16"]["losses"] == ranks[0]["bf16"]["losses"]
    # bf16 is load-bearing: the fp32 run's losses differ.
    assert ranks[0]["bf16"]["losses"] != ranks[0]["eval"]["losses"]


def test_grad_accum_at_tp2_matches_jax(run):
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["accum"]["losses"],
                                   ref["accum"]["losses"], rtol=ts.RTOL,
                                   atol=ts.ATOL)


def test_guard_norm_at_tp2_fsdp2_matches_jax(run):
    ranks, ref, _ = run
    want = [m["grad_norm"] for m in ref["fp32"]["metrics"]]
    assert min(want) > ts.OPT["grad_clip"]  # every step is clipped
    for r in ranks:
        got = [m["grad_norm"] for m in r["guard"]["metrics"]]
        np.testing.assert_allclose(got, want, rtol=ts.RTOL)
        assert [m["skipped"] for m in r["guard"]["metrics"]] == [0.0] * 5
        np.testing.assert_allclose(r["guard"]["losses"],
                                   ref["fp32"]["losses"], rtol=ts.RTOL,
                                   atol=ts.ATOL)


TINY = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
        "model.kwargs.max_len=64", "data.vocab_size=256", "data.seq_len=32",
        "data.batch_size=8", "optim.warmup_steps=1", "train.steps=2",
        "train.log_every=1"]


def _torchrun(cmd, config, overrides, extra=()):
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "4", "-m",
            "distributeddeeplearning_tpu_torch.cli", cmd, "--config",
            f"distributeddeeplearning_tpu_torch/configs/{config}",
            "--device", "cpu", *extra]
    for o in TINY + overrides:
        args += ["--override", o]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT")}
    proc = subprocess.run(args, cwd=ROOT, env={**env, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


def test_cli_train_under_torchrun_at_tp2_fsdp2_with_sp(tmp_path):
    recs = _torchrun("train", "gpt2_owt.py", [
        "mesh.dp=1", "mesh.tp=2", "mesh.fsdp=2",
        "train.sequence_parallel=true", f"train.log_dir={tmp_path}"],
        ["--sync-steps"])
    losses = [r["loss"] for r in recs if "loss" in r]
    end = next(r for r in recs if r.get("event") == "train_end")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(end["ranks"]) == 4
    for r in end["ranks"]:
        assert r["losses"] == losses
        s = r["shards"]
        assert s["sharded_fraction"]["tp"] > 0.4
        assert s["sharded_fraction"]["fsdp"] > 0.4
        assert s["param_bytes"] < s["whole_param_bytes"] / 3
        assert len(s["transport_s_by_step"]) == 2


def test_cli_benchmark_under_torchrun_on_llama_at_dp2_tp2():
    (rec,) = _torchrun("benchmark", "llama_lm.py", [
        "mesh.dp=2", "mesh.tp=2", "model.kwargs.attn_impl=xla"],
        ["--steps", "2", "--latency-steps", "0", "--probe", "0"])
    assert rec["device_count"] == 4 and np.isfinite(rec["loss"])
    # The whole model's count, and FLOPs summed over the tp ranks.
    from distributeddeeplearning_tpu_torch import models

    whole = sum(p.numel() for p in models.get_model(
        "llama", size="tiny", vocab_size=256, max_len=64).parameters())
    assert rec["params"] == whole
    assert rec["param_bytes_per_member"] < 4 * whole
    # Summed over the tp ranks: the step of one dp replica's rows, half
    # the one-rank step's (its FLOPs, counted the same way).
    import contextlib
    import io

    from distributeddeeplearning_tpu_torch import cli

    argv = ["benchmark", "--config",
            f"{ROOT}/distributeddeeplearning_tpu_torch/configs/llama_lm.py",
            "--device", "cpu", "--steps", "1", "--latency-steps", "0",
            "--probe", "0"]
    for o in TINY + ["model.kwargs.attn_impl=xla"]:
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    np.testing.assert_allclose(rec["model_tflops_per_step"],
                               one["model_tflops_per_step"] / 2, rtol=1e-9)


def _refused(overrides, config="gpt2_owt.py", world=4, tiny=False):
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh, axis_sizes

    cfg = apply_overrides(load_config(
        f"{ROOT}/distributeddeeplearning_tpu_torch/configs/{config}"),
        ([] if tiny else TINY) + list(overrides))
    cli.check_train_composition(cfg, world_size=world)
    mesh = Mesh(axis_sizes(cfg.mesh, world))
    return cli.build_all(cfg, "cpu", mesh)[0]


@pytest.mark.parametrize("config,overrides,match", [
    ("vit_imagenet21k.py", ["mesh.dp=2", "mesh.tp=2"], r"mesh\.tp=2.*vit"),
    ("bert_mlm.py", ["mesh.dp=2", "mesh.fsdp=2"], r"mesh\.fsdp=2.*bert"),
    ("resnet50_imagenet.py", ["mesh.dp=2", "mesh.tp=2"], "resnet"),
    ("gpt2_moe.py", ["mesh.dp=2", "mesh.tp=2"], "gpt2_moe"),
    ("llama_moe.py", ["mesh.dp=2", "mesh.fsdp=2"], "llama_moe"),
    ("gpt2_pp.py", ["mesh.dp=1", "mesh.pp=2", "mesh.tp=2"], "gpt2_pp"),
    ("gpt2_owt.py", ["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
                     "model.kwargs.attn_impl=ring"], r"mesh\.cp=2"),
    ("gpt2_owt.py", ["mesh.dp=2", "mesh.tp=2", "model.kwargs.dropout_rate=0.1"],
     "dropout"),
    ("gpt2_owt.py", ["mesh.dp=2", "mesh.fsdp=2", "train.remat=dots"],
     "remat='dots'"),
    ("gpt2_owt.py", ["mesh.dp=2", "mesh.tp=2", "optim.name=sgd",
                     "train.zero1=false"], "SGD"),
    ("gpt2_owt.py", ["mesh.dp=2", "mesh.tp=2", "optim.name=adamw",
                     "train.precision.policy=bf16_full"], "LowPrecision"),
])
def test_unheld_compositions_are_refused_by_name(config, overrides, match):
    if "_moe" in config:
        # Held since the MoE models were ported over tp and fsdp
        # (``tests/test_torch_ep.py``, ``tests/test_torch_ep8.py``): the
        # composition builds, its experts' hidden units over tp or their
        # ``embed`` dimension over fsdp.
        _refused(overrides, config)
        return
    if (config, match) in HELD:
        # Held since ViT, BERT, ResNet and the pipelined models were ported
        # over tp and fsdp, SGD over a rank's blocks, tp x cp, and dropout,
        # remat 'dots' and bf16_full over a rank's blocks
        # (``tests/test_torch_encoders_tp.py``, ``tests/test_torch_pp_tp.py``,
        # ``tests/test_torch_ulysses.py``,
        # ``tests/test_torch_compositions.py``): the composition builds at
        # the tiny size, its leaves cut.
        model = _refused(HELD[config, match] + overrides, config,
                         tiny=config != "gpt2_owt.py")
        assert model.shards is not None
        return
    with pytest.raises(NotImplementedError, match=rf"{match}.*A13"):
        _refused(overrides, config)


# The tiny overrides of the compositions that now build, by (config,
# match) of the parametrization above.
HELD = {
    ("vit_imagenet21k.py", r"mesh\.tp=2.*vit"): [
        "model.kwargs.size=tiny", "model.kwargs.image_size=16",
        "data.image_size=16", "model.kwargs.num_classes=11",
        "data.num_classes=11", "data.batch_size=8"],
    ("bert_mlm.py", r"mesh\.fsdp=2.*bert"): [
        "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
        "data.vocab_size=64", "model.kwargs.max_len=32", "data.seq_len=16",
        "data.batch_size=8"],
    ("resnet50_imagenet.py", "resnet"): [
        "model.kwargs.width=4", "model.kwargs.num_classes=10",
        "data.num_classes=10", "data.image_size=32", "data.batch_size=8"],
    ("gpt2_pp.py", "gpt2_pp"): [
        "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
        "model.kwargs.max_len=32", "model.kwargs.num_stages=2",
        "data.vocab_size=64", "data.seq_len=16", "data.batch_size=8"],
    ("gpt2_owt.py", "SGD"): [],
    # tp x cp: the ring on a rank's heads (``tests/test_torch_ulysses.py``).
    ("gpt2_owt.py", r"mesh\.cp=2"): [],
    # Each rank's masks its blocks of the one-rank masks, the selective
    # policy around the fsdp gathers, the rounding bits of each rank's
    # blocks (``tests/test_torch_compositions.py``).
    ("gpt2_owt.py", "dropout"): [],
    ("gpt2_owt.py", "remat='dots'"): [],
    ("gpt2_owt.py", "LowPrecision"): [],
}


def test_llama_kv_heads_must_divide_tp():
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by "
                                         "tp=4"):
        models.get_model("llama", size="tiny", mesh=Mesh({"tp": 4}))


def test_decode_under_tp_is_refused_by_name():
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.models.transformer import KVCache

    model = models.get_model("gpt2", **ts.MODEL, mesh=Mesh({"tp": 2}))
    cache = KVCache.empty(2, 1, 8, 4, 16, torch.float32, "cpu")
    with pytest.raises(NotImplementedError,
                       match="the reference decodes on one program"):
        model(torch.zeros(1, 2, dtype=torch.long), cache)
