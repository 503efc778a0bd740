"""Expert parallelism of the port (``mesh.ep``) against the JAX package's
Trainer on one device, on 4 gloo ranks spawned once, in the setting of
``tests/torch_sharded.py`` (weight decay 0.1, clip 0.05) with the tiny MoE
models of JAX's ``tests/test_moe.py`` (4 experts; gpt2_moe routes its
second block, llama_moe both) at capacity factor 0.5, where about half the
assignments of every routed layer are dropped:

- ``dp2_ep2_zero1``: gpt2_moe at dp2 x ep2 with ZeRO-1 of the experts'
  moments, saved at its last step;
- ``ep2_tp2``: gpt2_moe at ep2 x tp2 (the experts' hidden units over tp,
  ``b2`` added once, the router's gradient summed over tp);
- ``ep4``: llama_moe with one expert a rank;
- ``ep2_cp2``: llama_moe at ep2 x cp2 on ``ring_pallas``: each row routed
  across two blocks with the carried counts;
- ``aux1_dp2_ep2``: gpt2_moe at dp2 x ep2 with the aux loss at weight 1.0,
  where an aux gradient counted ep times falls far outside the tolerance;
- ``cp2_dp2``: gpt2_moe at dp2 x cp2 on ``ring`` without ep (the rows'
  routing carried across the cp blocks, every leaf whole).

Each job's losses, final params (gathered whole), ``aux_loss`` and
``moe_dropped_frac`` match JAX's within rtol 2e-4 / atol 2e-5, every rank
logs the same, and a rank holds 1/ep of the experts' elements. Then the
checkpoints: the dp2 x ep2 save restores at ep=1 in one process and at
ep2 x tp2 on the ranks, and a one-process save restores at dp2 x ep2, each
bit for bit. Last, the ranks run ``cli train``, ``cli eval`` and ``cli
benchmark`` on ``configs/gpt2_moe.py`` with ``mesh.ep`` (JAX's
``test_moe_config_trains_via_cli``), and the benchmark's FLOPs a step at
ep=4 equal one process's on the same global batch.

Beside the spawn: routing a row split over cp ranks (threads of one
process) equals routing it whole, bit for bit, drops and ties included;
the aux gradient over cp blocks averaging to the whole row's; and the
fences (``mesh.ep`` over a model without experts is the reference's
``ValueError``; experts that ep does not divide, and SGD under ep, are
refused; pipeline x ep in ``tests/test_torch_pipeline_cli.py``).
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import torch_sharded as ts
from distributeddeeplearning_tpu_torch import cli, models, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import Mesh
from distributeddeeplearning_tpu_torch.parallel import ep

MOE = dict(num_experts=4, capacity_factor=0.5)
JOBS = {
    "dp2_ep2_zero1": ("gpt2_moe", dict(dp=2, ep=2), {"zero1": True}),
    "ep2_tp2": ("gpt2_moe", dict(dp=1, ep=2, tp=2), {}),
    "ep4": ("llama_moe", dict(dp=1, ep=4), {}),
    "ep2_cp2": ("llama_moe", dict(dp=1, ep=2, cp=2),
                {"attn_impl": "ring_pallas"}),
    "aux1_dp2_ep2": ("gpt2_moe", dict(dp=2, ep=2), {"aux": 1.0}),
    "cp2_dp2": ("gpt2_moe", dict(dp=2, cp=2), {"attn_impl": "ring"}),
}
EP_JOBS = [j for j, (_, axes, _) in JOBS.items() if axes.get("ep", 1) > 1]
CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_moe.py"
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
    "model.kwargs.max_len=32", "model.kwargs.num_experts=4",
    "model.kwargs.dtype=float32", "data.vocab_size=64", "data.seq_len=16",
    "data.batch_size=8", "optim.warmup_steps=1", "train.log_every=1",
]
CLI_RUNS = {
    "train": (["mesh.ep=2", "mesh.dp=2", "train.steps=3",
               "train.save_every=3"], ["--sync-steps"]),
    "eval": (["mesh.ep=2", "mesh.dp=2"], []),
    "benchmark": (["mesh.ep=4", "mesh.dp=1"],
                  ["--steps", "1", "--latency-steps", "1", "--probe", "0"]),
}


def _aux_weight(weight):
    def setup(model):
        for m in models.moe.moe_mlps(model):
            m.aux_loss_weight = weight
    return setup


def _jax_aux(name, init, weight):
    """JAX's run with every routed MLP's aux loss at ``weight`` (the
    reference's models take no such argument: its ``MoeMlp`` default is
    patched for the run)."""
    from distributeddeeplearning_tpu.models import moe as jmoe

    base = jmoe.MoeMlp

    class MoeMlp(base):
        aux_loss_weight: float = weight

    jmoe.MoeMlp = MoeMlp
    try:
        return ts.jax_run(name, init, **MOE)
    finally:
        jmoe.MoeMlp = base


def _cli_argv(cmd, overrides, extra, ck=None):
    argv = [cmd, "--config", CONFIG, "--device", "cpu", *extra]
    for o in TINY + overrides + ([f"train.checkpoint_dir={ck}"] if ck
                                 else []):
        argv += ["--override", o]
    return argv


def _expert_elements(state):
    shards = state.shards
    names = [k for k in state.params if "ep" in shards.axes_of(k)]
    return (sum(state.params[k].numel() for k in names),
            sum(math.prod(shards.whole[k]) for k in names))


def _worker(rank, world, port, tmp, ports):
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
        _whole_trees,
    )
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh
    from distributeddeeplearning_tpu_torch.weights import rank_shards

    ts.join_world(rank, world, port)
    inits = torch.load(f"{tmp}/inits.pt")
    out = {}
    for job, (name, axes, kw) in JOBS.items():
        mesh = build_mesh(MeshConfig(**axes))
        kw = dict(kw)
        weight = kw.pop("aux", None)
        r = ts.port_run(name, mesh, inits[name], model_kw=MOE,
                        setup=None if weight is None else _aux_weight(weight),
                        **kw)
        out[job] = {k: r[k] for k in ("losses", "metrics", "params",
                                      "fraction", "coords")}
        if job in EP_JOBS:
            out[job]["experts"] = _expert_elements(r["state"])
        if job == "dp2_ep2_zero1":
            with CheckpointManager(f"{tmp}/ck_ep2") as ck:
                ck.save(ts.STEPS, r["state"])

    def restored(directory, axes, **kw):
        mesh = build_mesh(MeshConfig(**axes))
        _, trainer = ts.port_trainer("gpt2_moe", mesh, model_kw=MOE, **kw)
        state = trainer.init(1)
        with CheckpointManager(directory) as ck:
            state, _ = ck.restore(state)
        return state

    # The dp2 x ep2 save at ep2 x tp2, gathered back whole.
    state = restored(f"{tmp}/ck_ep2", dict(dp=1, ep=2, tp=2))
    params, trees = _whole_trees(state)
    out["ep2_tp2_restore"] = (params, trees)
    # A one-process save at dp2 x ep2 with ZeRO-1: each rank's blocks of
    # the whole params, and the trees gathered back whole.
    state = restored(f"{tmp}/ck_one", dict(dp=2, ep=2), zero1=True)
    whole = torch.load(f"{tmp}/ck_one/1/state.pt")
    want = rank_shards(whole["params"], state.shards)
    out["ep2_from_one"] = {
        "blocks_equal": all(torch.equal(p, want[k])
                            for k, p in state.params.items()),
        "whole": _whole_trees(state)}
    dist.destroy_process_group()
    for i, (cmd, (overrides, extra)) in enumerate(CLI_RUNS.items()):
        os.environ["MASTER_PORT"] = str(ports[i])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(_cli_argv(cmd, overrides, extra,
                                      f"{tmp}/ck_cli")) == 0
        out[f"cli_{cmd}"] = buf.getvalue()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _one_process_save(tmp, init):
    """A one-process gpt2_moe state after one step, saved at step 1."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    r = ts.port_run("gpt2_moe", single_device_mesh(), init, steps=1,
                    model_kw=MOE)
    with CheckpointManager(f"{tmp}/ck_one") as ck:
        ck.save(1, r["state"])


def _one_process_benchmark():
    argv = _cli_argv("benchmark", ["mesh.dp=1"], CLI_RUNS["benchmark"][1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    inits = {n: ts.port_init(n, **MOE) for n in ("gpt2_moe", "llama_moe")}
    torch.save(inits, tmp / "inits.pt")
    _one_process_save(tmp, inits["gpt2_moe"])

    def parent():
        refs = {n: ts.jax_run(n, init, **MOE) for n, init in inits.items()}
        refs["aux1"] = _jax_aux("gpt2_moe", inits["gpt2_moe"], 1.0)
        refs["bench"] = _one_process_benchmark()
        return refs

    ranks, refs = ts.spawn(_worker, 4, tmp, ts.free_ports(3),
                           parent=parent)
    return ranks, refs, tmp


def _ref(refs, job):
    return refs["aux1"] if job.startswith("aux1") else refs[JOBS[job][0]]


@pytest.mark.parametrize("job", list(JOBS))
def test_losses_and_params_match_jax(run, job):
    ranks, refs, _ = run
    ref = _ref(refs, job)
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], ref["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
        assert r[job]["losses"] == ranks[0][job]["losses"]
    ts.assert_params_close(ranks[0][job]["params"], ref["params"])


@pytest.mark.parametrize("job", list(JOBS))
def test_aux_loss_and_dropped_fraction_match_jax(run, job):
    """Both sown values, every step; about half the assignments are
    dropped in every routed layer."""
    ranks, refs, _ = run
    ref = _ref(refs, job)
    for key in ("aux_loss", "moe_dropped_frac"):
        want = [m[key] for m in ref["metrics"]]
        for r in ranks:
            got = [m[key] for m in r[job]["metrics"]]
            np.testing.assert_allclose(got, want, rtol=ts.RTOL,
                                       atol=ts.ATOL, err_msg=key)
    assert all(0.3 < m["moe_dropped_frac"] < 0.7 for m in ref["metrics"])


def test_aux_weight_one_is_load_bearing(run):
    """At weight 1.0 the aux loss is a term of the objective's own size,
    and it moves the router: JAX's final router kernel at weight 1.0 stands
    far outside the params' tolerance from the weight-0.01 run's, so a
    doubled aux gradient could not pass the parity above."""
    _, refs, _ = run
    aux1, base = refs["aux1"], refs["gpt2_moe"]
    assert aux1["metrics"][0]["aux_loss"] > 0.9
    assert aux1["metrics"][0]["aux_loss"] == pytest.approx(
        100 * base["metrics"][0]["aux_loss"], rel=1e-5)
    key = "block_1.moe_mlp.router.kernel"
    moved = (aux1["params"][key] - base["params"][key]).abs().max()
    assert float(moved) > 20 * ts.ATOL


@pytest.mark.parametrize("job", EP_JOBS)
def test_a_rank_holds_1_over_ep_of_the_experts(run, job):
    ranks, _, _ = run
    axes = JOBS[job][1]
    for r in ranks:
        local, whole = r[job]["experts"]
        if axes.get("tp", 1) == 1:
            assert local * axes["ep"] == whole
        else:  # the experts' hidden units over tp too
            assert whole / (axes["ep"] * axes["tp"]) < local < whole / axes[
                "ep"]
        assert r[job]["fraction"]["ep"] > 0.5, r[job]["fraction"]


def test_an_ep2_save_restores_at_ep1_and_at_ep2_tp2_bit_for_bit(run):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import single_device_mesh

    ranks, _, tmp = run
    saved = torch.load(tmp / "ck_ep2" / str(ts.STEPS) / "state.pt")
    for k, v in ranks[0]["dp2_ep2_zero1"]["params"].items():
        assert torch.equal(saved["params"][k], v), k
    # One process, ep=1.
    _, trainer = ts.port_trainer("gpt2_moe", single_device_mesh(),
                                 model_kw=MOE)
    state = trainer.init(1)
    with CheckpointManager(str(tmp / "ck_ep2")) as ck:
        state, _ = ck.restore(state)
    assert state.step == ts.STEPS
    for k, p in state.params.items():
        assert torch.equal(p, saved["params"][k]), k
    for name in ("mu", "nu"):
        tree = getattr(state.opt_state, name)
        for k, t in tree.items():
            assert torch.equal(t, saved[name][k]), (name, k)
    # The ranks at ep2 x tp2: rank 0 gathered the same trees back.
    params, trees = ranks[0]["ep2_tp2_restore"]
    for k, v in saved["params"].items():
        assert torch.equal(params[k], v), k
    for name in ("mu", "nu"):
        for k, v in saved[name].items():
            assert torch.equal(trees[name][k], v), (name, k)


def test_a_one_process_save_restores_at_dp2_ep2_bit_for_bit(run):
    ranks, _, tmp = run
    saved = torch.load(tmp / "ck_one" / "1" / "state.pt")
    for r in ranks:
        assert r["ep2_from_one"]["blocks_equal"]
    params, trees = ranks[0]["ep2_from_one"]["whole"]
    for k, v in saved["params"].items():
        assert torch.equal(params[k], v), k
    for name in ("mu", "nu"):
        for k, v in saved[name].items():
            assert torch.equal(trees[name][k], v), (name, k)


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_cli_train_and_eval_under_ep(run):
    """``cli train`` on configs/gpt2_moe.py with ``mesh.ep=2`` over 4 gloo
    ranks (dp2 x ep2, the config's ZeRO-1), then ``cli eval`` on its
    checkpoint."""
    ranks, _, _ = run
    text = ranks[0]["cli_train"]
    assert "'ep': 2" in text and "'dp': 2" in text
    recs = [r for r in _records(text) if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert all(math.isfinite(r[k]) for k in ("loss", "aux_loss",
                                                  "moe_dropped_frac"))
    end = [r for r in _records(text) if r.get("event") == "train_end"][0]
    for rank in end["ranks"]:
        assert rank["shards"]["sharded_fraction"]["ep"] > 0.5
        assert rank["shards"]["param_bytes"] < rank["shards"][
            "whole_param_bytes"]
    ev = _records(ranks[0]["cli_eval"])[-1]
    assert "evaluating checkpoint at step 3" in ranks[0]["cli_eval"]
    assert math.isfinite(ev["eval_loss"])


def test_benchmark_counts_model_flops_once_under_ep(run):
    """At ep=4 every rank runs the attention, embeddings and head of the
    same rows and a quarter of the experts: the FLOPs a step summed over
    the ep ranks equal one process's on the same global batch."""
    ranks, refs, _ = run
    rec = _records(ranks[0]["cli_benchmark"])[-1]
    one = refs["bench"]
    assert rec["device_count"] == 4
    assert rec["model_tflops_per_step"] == pytest.approx(
        one["model_tflops_per_step"], rel=1e-9)
    assert rec["onehot_tflops_per_step"] == pytest.approx(
        one["onehot_tflops_per_step"], rel=1e-12)


# ---------------------------------------------------------------------------
# Routing a row split over cp ranks, on threads of one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp,k,cf,ties", [
    (2, 2, 0.5, False), (4, 2, 1.0, False), (2, 1, 0.25, False),
    (4, 2, 0.5, True),
])
def test_cp_routing_with_carried_counts_equals_the_whole_row(cp, k, cf,
                                                              ties):
    g, t, e = 3, 32, 4
    rng = np.random.default_rng(cp * 10 + k)
    logits = rng.standard_normal((g, t, e)).astype(np.float32)
    if ties:  # equal probabilities: the lower index first
        logits[:, ::3] = 0.0
    probs = torch.softmax(torch.from_numpy(logits), -1)
    cap = ep.expert_capacity(t, e, k, cf)
    d, c, aux, kept = ep.route_top_k(probs, k, cap)
    assert 0 < int(kept) < g * t * k  # drops present
    n = t // cp

    def block(mesh):
        r = mesh.coords["cp"]
        return ep.route_top_k(probs[:, r * n:(r + 1) * n].clone(), k, cap,
                              mesh=mesh)

    got = ts.lockstep(cp, block, cp=cp)
    assert torch.equal(torch.cat([x[0] for x in got], 1), d)
    assert torch.equal(torch.cat([x[1] for x in got], 1), c)
    for x in got:
        assert int(x[3]) == int(kept)
        np.testing.assert_allclose(float(x[2]), float(aux), rtol=1e-6)


def test_cp_aux_gradient_averages_to_the_whole_rows():
    """Each block's aux gradient, averaged over the cp ranks (the step's
    gradient mean), is the whole row's."""
    g, t, e, cp = 2, 16, 4, 2
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((g, t, e)).astype(
        np.float32))
    cap = ep.expert_capacity(t, e, 2, 1.0)
    whole = logits.clone().requires_grad_(True)
    ep.route_top_k(torch.softmax(whole, -1), 2, cap)[2].backward()
    n = t // cp

    def block(mesh):
        r = mesh.coords["cp"]
        x = logits[:, r * n:(r + 1) * n].clone().requires_grad_(True)
        ep.route_top_k(torch.softmax(x, -1), 2, cap, mesh=mesh)[2].backward()
        return x.grad / cp

    got = ts.lockstep(cp, block, cp=cp)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                               whole.grad.numpy(), rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# Fences
# ---------------------------------------------------------------------------


def test_ep_over_a_model_without_experts_is_the_reference_s_value_error():
    mesh = Mesh({"ep": 2})
    model = models.get_model("gpt2", **ts.MODEL, mesh=mesh)
    with pytest.raises(ValueError,
                       match=r"^mesh ep=2 but model GPT2 has no experts"):
        train.Trainer(model, train.AdamW(1e-3),
                      train.get_task("lm", mesh=mesh), device="cpu",
                      mesh=mesh)
    cfg = apply_overrides(
        load_config("distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"),
        ["mesh.ep=2", "mesh.dp=1"])
    with pytest.raises(ValueError, match="has no experts"):
        cli.check_train_composition(cfg, world_size=2)


@pytest.mark.parametrize("overrides,exc,match", [
    (["mesh.ep=3"], ValueError, "num_experts=4 not divisible by ep=3"),
    (["mesh.ep=2", "optim.name=sgd", "train.zero1=false"],
     NotImplementedError, r"mesh\.ep=2 x SGD"),
])
def test_what_ep_does_not_compose_with_is_refused(overrides, exc, match):
    cfg = apply_overrides(load_config(CONFIG),
                          TINY + ["mesh.dp=1"] + overrides)
    n = int(overrides[0].split("=")[1])
    mesh = Mesh({"ep": n})
    with pytest.raises(exc, match=match):
        cli.build_all(cfg, "cpu", mesh)
