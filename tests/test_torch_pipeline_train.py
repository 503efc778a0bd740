"""The Trainer on a pipelined model across 4 gloo ranks on the CPU, against
the JAX package's Trainer, and the pipeline's checkpoints.

One spawn of 4 ranks runs these jobs in turn (``cli.build_all`` on the
port's ``configs/gpt2_pp.py`` shrunk to the tiny GPT-2 at fp32: 4 layers,
width 64, vocab 64, one batch of 8 x 16, 2 microbatches, the interleaved 1F1B
schedule, AdamW at a constant lr 1e-3 with weight decay 0.1 and the global
norm clipped at 0.05, which every step's norm exceeds):
- ``pp4``: 3 steps at pp=4 (one stage a rank), from JAX's init;
- ``pp2dp2``: 3 steps at pp=2 x dp=2 (2 stages of 2 layers), from JAX's
  init regrouped into 2 stages;
- ``accum``: pp=2 x dp=2 with grad_accum=2 and ZeRO-1 (each rank's moments
  a shard of its stage's leaves over its dp pair), 4 steps, saving at
  step 2;
- ``guard``: pp=2 x dp=2 under the health guard with ``nan:1``: every
  rank skips that step and keeps its params bit for bit;
and draws the tiny gpt2_pp, llama_pp and bert_pp at pp=4, whose rows must
be those of the one-rank draw bit for bit.

JAX's Trainer runs the same config at pp=4 x dp=2 for 3 steps: the three
port runs' losses within rtol 2e-5 of it (grad_accum 2 of equal groups is
the same function of the global batch), params within 1e-5 (the key
biases, whose gradient is zero up to rounding, only small in both). Then
the parent restores the step-2 checkpoint of ``accum`` at pp=1: params and
moments equal the ranks' step-2 state bit for bit, and steps 3-4 from it
agree with the straight run within rtol 2e-5.
"""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, models, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed
from distributeddeeplearning_tpu_torch.weights import rank_rows, rank_shards
from torch_sharded import whole_over_pp

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_pp.py"
STEPS = 3
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
    "model.kwargs.max_len=32", "model.kwargs.num_microbatches=2",
    "model.kwargs.dtype=float32", "data.vocab_size=64", "data.seq_len=16",
    "data.batch_size=8", "data.n_distinct=1", "optim.schedule=constant",
    "optim.lr=1e-3",
    "optim.warmup_steps=0", "optim.grad_clip=0.05",
    "optim.weight_decay=0.1", "train.zero1=False", f"train.steps={STEPS}",
]
PP4 = ["model.kwargs.num_stages=4", "mesh.dp=1", "mesh.pp=4"]
PP2 = ["model.kwargs.num_stages=2", "mesh.dp=2", "mesh.pp=2"]
JOBS = {
    "pp4": PP4,
    "pp2dp2": PP2,
    "accum": PP2 + ["train.grad_accum=2", "train.zero1=True",
                    "train.steps=4"],
    "guard": PP2 + ["health.enabled=true", "train.fault_injection=nan:1",
                    "health.max_consecutive_anomalies=5"],
}
FAULT_STEP = 1
DRAWS = {"gpt2_pp": {}, "llama_pp": {}, "bert_pp": {"num_layers": 4}}


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def restage(flat, S):
    """A flat state_dict's stage leaves (``h.stages.block_j.X``, [S0, ...])
    regrouped into S stages: layer ``s0 * per0 + j`` of the whole stack is
    layer ``s * per + j'`` of the new grouping."""
    layers, heads = {}, set()
    per0 = 1 + max(int(k.split(".stages.block_")[1].split(".")[0])
                   for k in flat if ".stages.block_" in k)
    for k, v in flat.items():
        if ".stages.block_" not in k:
            continue
        head, rest = k.split(".stages.block_")
        j, suffix = rest.split(".", 1)
        heads.add(head)
        for s0 in range(v.shape[0]):
            layers.setdefault(s0 * per0 + int(j), {})[suffix] = v[s0]
    (head,) = heads
    per = len(layers) // S
    out = {k: v for k, v in flat.items() if ".stages.block_" not in k}
    for j in range(per):
        for suffix in layers[0]:
            out[f"{head}.stages.block_{j}.{suffix}"] = torch.stack(
                [layers[s * per + j][suffix] for s in range(S)])
    return out


def _checksum(params):
    return float(sum(p.double().sum() for p in params.values()))


def _job(name, overrides, weights, ckpt_dir):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    cfg = _cfg(*overrides)
    mesh = build_mesh(cfg.mesh)
    fault = train.parse_fault_injection(cfg.train.fault_injection)
    model, trainer, dataset = cli.build_all(
        cfg, "cpu", mesh, fault_nan_step=fault.step if fault else None)
    state = trainer.init(cfg.train.seed)
    S = model.num_stages
    # The tables are cut over pp (``vocab_pp``): a rank loads its block,
    # and what it returns holds them put back together over pp.
    model.load_state_dict(rank_shards(rank_rows(weights if S == 4 else restage(
        weights, S), model.stage_rows), model.shards), strict=True)
    batches = data.sharded_batches(dataset.iter_from(0), mesh,
                                   cfg.train.grad_accum)
    out = {"coords": mesh.coords}
    if name == "guard":
        steps = []
        for _, batch in zip(range(cfg.train.steps), batches):
            before = _checksum(state.params)
            state, m = trainer.train_step(
                state, {k: torch.from_numpy(v) for k, v in batch.items()})
            steps.append((int(m["skipped"]), before == _checksum(
                state.params), float(m["loss"])))
        out["steps"] = steps
        return out
    ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir)
    state, hist = train.fit(
        trainer, state, data.prefetch(batches, "cpu"),
        steps=cfg.train.steps, log_every=1, log_fn=lambda m: None,
        ckpt=ckpt, save_every=2 if ckpt is not None else 0)
    if ckpt is not None:
        ckpt.close()
        layout = state.opt_state.layout  # ZeRO-1: this stage's leaves
        out["moments"] = {n: layout.gather(getattr(state.opt_state, n))
                          for n in ("mu", "nu")}
        if mesh.coords["dp"] == 0:  # whole pp groups: the tables' blocks
            out["moments"] = {n: whole_over_pp(t, model.shards)
                              for n, t in out["moments"].items()}
    out["losses"] = [r["loss"] for r in hist if "loss" in r]
    out["params"] = {k: p.detach().clone() for k, p in whole_over_pp(
        state.params, model.shards).items()}
    out["metric_keys"] = sorted(hist[0])
    return out


def _worker(rank, world, port, path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    with contextlib.redirect_stdout(io.StringIO()):
        assert init_distributed("cpu")
    weights = torch.load(path)
    out = {}
    for name, overrides in JOBS.items():
        ckpt = os.path.join(out_dir, "ckpt") if name == "accum" else None
        out[name] = _job(name, overrides, weights, ckpt)
    mesh = build_mesh(_cfg(*PP4).mesh)
    draws = {}
    for name, kw in DRAWS.items():
        m = models.get_model(name, size="tiny", num_stages=4,
                             num_microbatches=2, mesh=mesh, **kw)
        m.init_weights(torch.Generator().manual_seed(0))
        draws[name] = {k: v.detach().clone() for k, v in
                       whole_over_pp(m.state_dict(), m.shards).items()}
    out["draws"] = draws
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def _jax_trainer():
    """JAX's Trainer on the same config at pp=4 x dp=2: (its init as a flat
    state_dict, a function running STEPS steps -> (losses, final flat
    params))."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu import config as jconfig
    from distributeddeeplearning_tpu.cli import build_all
    from distributeddeeplearning_tpu.data import sharded_batches
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    cfg = jconfig.apply_overrides(
        jconfig.load_config("configs/gpt2_pp.py"),
        TINY + ["model.kwargs.num_stages=4", "mesh.dp=2", "mesh.pp=4"])
    mesh, _, trainer, dataset = build_all(cfg)
    state = trainer.init(cfg.train.seed, dataset.batch(0))

    def flat(tree):
        return from_jax_params(jax.tree.map(np.asarray, nn.meta.unbox(tree)))

    def run():
        s, losses = state, []
        for _, batch in zip(range(STEPS),
                            sharded_batches(dataset.iter_from(0), mesh)):
            s, m = trainer.train_step(s, batch)
            losses.append(float(m["loss"]))
        return losses, flat(s.params), jax.tree.map(np.asarray,
                                                    nn.meta.unbox(s))

    return flat(state.params), run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pptrain")
    init, jax_run = _jax_trainer()
    torch.save(init, tmp / "weights.pt")
    ctx = torch.multiprocessing.spawn(
        _worker, args=(4, _free_port(), str(tmp / "weights.pt"), str(tmp)),
        nprocs=4, join=False)
    j_losses, j_params, j_state = jax_run()
    while not ctx.join():
        pass
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, init, j_losses, j_params, tmp, j_state


def _assert_params_close(got, want, rows):
    for k, v in rows.take(want).items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("attn.key.bias"):
            assert np.abs(a).max() < 1e-3 and np.abs(b).max() < 1e-3, k
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


def _rows(S, s):
    from distributeddeeplearning_tpu_torch.parallel.pp import StageRows

    names = {k for k in restage(_flat_names(), S) if ".stages." in k}
    return StageRows(names, S, s, s + 1)


def _flat_names():
    model = models.get_model("gpt2_pp", size="tiny", vocab_size=64,
                             max_len=32, num_stages=4, num_microbatches=2)
    return {k: v for k, v in model.state_dict().items()}


@pytest.mark.parametrize("job", ["pp4", "pp2dp2", "accum"])
def test_losses_and_params_match_the_jax_trainer(run, job):
    ranks, _, j_losses, j_params, *_ = run
    for r in ranks:
        got = r[job]
        np.testing.assert_allclose(got["losses"][:STEPS], j_losses,
                                   rtol=2e-5)
        if job == "accum":
            continue  # its params are a step further
        S = 4 if job == "pp4" else 2
        want = j_params if S == 4 else restage(j_params, S)
        _assert_params_close(got["params"], want,
                             _rows(S, r[job]["coords"]["pp"]))


def test_ranks_agree_and_the_loss_falls(run):
    ranks, *_ = run
    for job in ("pp4", "pp2dp2", "accum"):
        losses = [r[job]["losses"] for r in ranks]
        assert all(x == losses[0] for x in losses), job
        assert losses[0][-1] < losses[0][0], (job, losses[0])


def test_interleaved_step_reports_the_reference_s_metrics(run):
    ranks, *_ = run
    assert ranks[0]["pp4"]["metric_keys"] == ["loss", "step", "wall_s"]


def test_guard_skips_on_every_rank(run):
    """nan:1 poisons step 1's gradients on every rank; the whole-model
    norm is NaN on all of them, so every rank skips that step, keeps its
    params bit for bit, and updates on the others."""
    ranks, *_ = run
    for r in ranks:
        steps = r["guard"]["steps"]
        assert [s[0] for s in steps] == [int(i == FAULT_STEP)
                                         for i in range(STEPS)]
        assert [s[1] for s in steps] == [i == FAULT_STEP
                                         for i in range(STEPS)]
        assert all(np.isfinite(s[2]) for s in steps[:FAULT_STEP])


def test_init_at_pp4_is_the_one_rank_draw(run):
    ranks, *_ = run
    for name, kw in DRAWS.items():
        m = models.get_model(name, size="tiny", num_stages=4,
                             num_microbatches=2, **kw)
        m.init_weights(torch.Generator().manual_seed(0))
        whole = m.state_dict()
        for r in ranks:
            s = r["pp4"]["coords"]["pp"]
            for k, v in r["draws"][name].items():
                want = whole[k][s:s + 1] if ".stages." in k else whole[k]
                assert torch.equal(v, want), (name, k, s)
        # Each stage's rows differ: no rank drew stage 0's weights.
        k = next(k for k in whole if k.endswith("attn.query.kernel"))
        assert not torch.equal(ranks[0]["draws"][name][k],
                               ranks[1]["draws"][name][k])


def test_checkpoint_at_pp2_restores_at_pp1(run):
    """The accum job's step-2 checkpoint (pp=2 x dp=2, ZeRO-1) holds the
    whole stacked layout: restored at pp=1, its params equal the ranks'
    rows bit for bit, and steps 3-4 from it agree with the straight run."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    ranks, _, _, _, tmp, _ = run
    ckpt_dir = tmp / "ckpt"
    assert sorted(os.listdir(ckpt_dir)) == ["2", "4"]
    host = torch.load(ckpt_dir / "2" / "state.pt", weights_only=True)
    assert host["params"]["h.stages.block_0.attn.query.kernel"].shape[0] == 2
    cfg = _cfg("model.kwargs.num_stages=2", "mesh.pp=1", "mesh.dp=1",
               "train.grad_accum=2", "train.zero1=True", "train.steps=4")
    _, trainer, dataset = cli.build_all(cfg, "cpu")
    state = trainer.init(cfg.train.seed)
    with CheckpointManager(str(ckpt_dir)) as ck:
        state, data_state = ck.restore(state, step=2)
    assert state.step == 2 and data_state == {"next_index": 2}
    for k, v in host["params"].items():
        assert torch.equal(state.params[k], v)
        assert torch.equal(state.opt_state.mu[k], host["mu"][k])
        assert torch.equal(state.opt_state.nu[k], host["nu"][k])
    # The step-4 save against the ranks' final params and moments (each
    # stage's moments gathered over its dp pair): the whole tree.
    host4 = torch.load(ckpt_dir / "4" / "state.pt", weights_only=True)
    for r in ranks:
        s, d = r["accum"]["coords"]["pp"], r["accum"]["coords"]["dp"]
        trees = {"params": r["accum"]["params"]}
        if d == 0:
            trees.update(r["accum"]["moments"])
        for name, tree in trees.items():
            for k, v in tree.items():
                want = host4[name][k]
                want = want[s:s + 1] if ".stages." in k else want
                assert torch.equal(v, want), (name, k, s)
    state, hist = train.fit(
        trainer, state, data.prefetch(data.sharded_batches(
            dataset.iter_from(2), None, 2), "cpu"),
        steps=4, log_every=1, log_fn=lambda m: None)
    resumed = [r["loss"] for r in hist]
    straight = ranks[0]["accum"]["losses"][2:]
    np.testing.assert_allclose(resumed, straight, rtol=2e-5)


@pytest.mark.parametrize("stage", [0, 2])
def test_jax_state_carried_onto_a_stage_s_rows(run, stage):
    """``weights.state_from_jax`` gives a pp=4 rank its rows of JAX's
    stacked params and moments (after JAX's 3 steps), the replicated leaves
    whole, and the step and count."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.weights import (
        from_jax_params,
        state_from_jax,
    )

    *_, j_state = run
    cfg = _cfg(*PP4)
    mesh = Mesh({"pp": 4}, stage)
    _, trainer, _ = cli.build_all(cfg, "cpu", mesh)
    state = state_from_jax(j_state, trainer.init(cfg.train.seed))
    assert state.step == STEPS and state.opt_state.count == STEPS
    node = j_state.opt_state
    want = {"params": from_jax_params(j_state.params)}
    want.update({k: from_jax_params(getattr(
        next(n for n in jax_nodes(node) if hasattr(n, "mu")), k))
        for k in ("mu", "nu")})
    got = {"params": state.params, "mu": state.opt_state.mu,
           "nu": state.opt_state.nu}
    for name, tree in got.items():
        for k, v in tree.items():
            w = want[name][k]
            w = w[stage:stage + 1] if ".stages." in k else w
            if k == "wte.embedding":  # the stage's block of the table
                w = w[stage * 16:(stage + 1) * 16]
            assert torch.equal(v.detach(), w), (name, k)


def jax_nodes(node):
    """The nodes of a JAX optimizer state's chain, depth first."""
    yield node
    if isinstance(node, (tuple, list)):
        for item in node:
            yield from jax_nodes(item)
