"""The port's training health guard (``health.py``, ``Trainer(health=,
fault_nan_step=)``, ``fit``'s rollback and ``cli train``'s restart loop)
against the JAX package's.

The contract is SKIP-UPDATE PARITY: an anomalous step leaves the model
bit-identical to never having run it (params, moments, the optimizer's
count, BatchNorm's running statistics) while the step counter advances. As
in JAX's ``tests/test_health.py`` the oracle runs the same trainer and skips
the faulted step on the host, so the comparison is exact equality.

- the guard's decisions and its ``HealthState`` sequence (counters and the
  fp32 EMA, bit for bit) equal JAX's ``guard_step`` on the same losses:
  non-finite losses, a consecutive run, an EMA spike, the warm-up;
- the tiny GPT-2 under ``nan:2``: skip parity with ``adamw``,
  ``adamw_fused`` and ``LowPrecisionAdamW``, under ``steps_per_call=2``
  and ZeRO-1 at dp=2 (two gloo ranks decide alike); the per-step
  ``skipped``/``anomalies`` stream and the losses against the JAX Trainer's
  under the same fault;
- ResNet-18's BatchNorm statistics kept on a skipped step;
- ``fit`` raising ``HealthRollback`` one logging interval late, after a
  ``health_rollback`` event; ``TrainState.health`` is None and absent from
  checkpoints when the guard is off, and round-trips when on;
- ``cli train``: ``nan:K`` detected, a ``rollback_restart`` from the last
  checkpoint that ends at the last step, and ``rollback_give_up``.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.config import HealthConfig as JaxHealth
from distributeddeeplearning_tpu.health import guard_step as jax_guard
from distributeddeeplearning_tpu.health import (
    init_health_state as jax_init_health,
)
from distributeddeeplearning_tpu.train import TrainState as JaxState
from distributeddeeplearning_tpu_torch import cli, data, train
from distributeddeeplearning_tpu_torch.checkpoint import CheckpointManager
from distributeddeeplearning_tpu_torch.config import (
    HealthConfig,
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.health import (
    HealthState,
    guard_step,
    init_health_state,
)
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
# helpers.train_tiny_gpt2's run on gpt2_owt's schema, with the guard on.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "model.kwargs.chunked_head=False", "model.kwargs.attn_impl=xla",
    "data.vocab_size=256", "data.seq_len=32", "data.batch_size=16",
    "data.n_distinct=4", "optim.name=adamw", "optim.lr=1e-3",
    "optim.b2=0.999", "optim.weight_decay=0.0", "optim.schedule=constant",
    "optim.warmup_steps=0", "optim.grad_clip=0.0", "train.zero1=False",
    "health.enabled=True", "train.steps=5",
]
FAULT = 2


# ---------------------------------------------------------------------------
# the guard on a counting step, against JAX's
# ---------------------------------------------------------------------------


def _jax_counting(state, batch):
    return (state.replace(step=state.step + 1,
                          params={"w": state.params["w"] + 1.0}),
            {"loss": jnp.asarray(batch["loss"], jnp.float32)})


def _jax_sequence(losses, cfg):
    g = jax_guard(_jax_counting, cfg)
    state = JaxState(step=jnp.zeros((), jnp.int32),
                     params={"w": jnp.zeros((), jnp.float32)}, opt_state=(),
                     model_state={}, rng=jax.random.PRNGKey(0),
                     health=jax_init_health())
    out = []
    for loss in losses:
        state, m = g(state, {"loss": loss})
        h = state.health
        out.append((int(h.anomaly_count), int(h.consecutive),
                    np.float32(h.loss_ema), int(h.ema_steps),
                    int(m["skipped"]), int(m["consecutive_anomalies"])))
    return out, float(state.params["w"]), int(state.step)


@dataclasses.dataclass
class _Unit:
    step: int
    w: float
    model_state: dict
    health: HealthState


def _staged_counting(state, batch):
    def commit():
        return dataclasses.replace(state, step=state.step + 1,
                                   w=state.w + 1.0)

    return {"loss": torch.tensor(batch["loss"])}, commit


def _port_sequence(losses, cfg):
    g = guard_step(_staged_counting, cfg)
    state = _Unit(0, 0.0, {}, init_health_state())
    out = []
    for loss in losses:
        state, m = g(state, {"loss": loss})
        h = state.health
        out.append((h.anomaly_count, h.consecutive, h.loss_ema, h.ema_steps,
                    int(m["skipped"]), int(m["consecutive_anomalies"])))
    return out, state.w, state.step


NAN, INF = float("nan"), float("inf")
SEQUENCES = {
    "nonfinite": ([1.0, NAN, INF, 1.0], {}),
    "consecutive": ([1.0, NAN, NAN, NAN, 1.0], {}),
    "spike": ([1.0, 1.0, 1.0, 10.0, 1.0],
              dict(ema_beta=0.5, spike_factor=2.0, ema_warmup_steps=2)),
    "warmup": ([1.0, 10.0, 1.0],
               dict(ema_beta=0.5, spike_factor=2.0, ema_warmup_steps=10)),
    "ema": ([2.3, 2.1, 1.97, -INF, 1.93, 1.88, 5.0, 1.8],
            dict(ema_beta=0.98, spike_factor=2.5, ema_warmup_steps=3)),
}


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_health_state_sequence_equals_jax(case):
    losses, kw = SEQUENCES[case]
    want, jw, jstep = _jax_sequence(losses, JaxHealth(enabled=True, **kw))
    got, w, step = _port_sequence(losses, HealthConfig(enabled=True, **kw))
    assert [g[:2] + g[3:] for g in got] == [x[:2] + x[3:] for x in want]
    for g, x in zip(got, want):  # the fp32 EMA, bit for bit
        assert np.asarray(g[2], np.float32).tobytes() == x[2].tobytes()
    assert (w, step) == (jw, jstep)


def test_guard_cases_of_the_reference():
    """JAX's unit cases, restated on the port's guard."""
    seq, w, step = _port_sequence([1.0, NAN, INF, 1.0],
                                  HealthConfig(enabled=True))
    assert [s[4] for s in seq] == [0, 1, 1, 0] and (w, step) == (2.0, 4)
    assert seq[-1][0] == 2 and np.isfinite(seq[-1][2]) and seq[-1][3] == 2
    seq, _, _ = _port_sequence([1.0, NAN, NAN, NAN, 1.0],
                               HealthConfig(enabled=True))
    assert [s[5] for s in seq] == [0, 1, 2, 3, 0]
    cfg = HealthConfig(enabled=True, ema_beta=0.5, spike_factor=2.0,
                       ema_warmup_steps=2)
    seq, w, _ = _port_sequence([1.0, 1.0, 1.0, 10.0, 1.0], cfg)
    assert [s[4] for s in seq] == [0, 0, 0, 1, 0] and w == 4.0
    cfg = dataclasses.replace(cfg, ema_warmup_steps=10)
    seq, _, _ = _port_sequence([1.0, 10.0, 1.0], cfg)
    assert seq[-1][0] == 0


# ---------------------------------------------------------------------------
# the Trainer: skip parity
# ---------------------------------------------------------------------------


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def _trainer(*overrides, fault=FAULT, mesh=None):
    cfg = _cfg(*overrides)
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh,
                                        fault_nan_step=fault)
    return cfg, trainer, dataset


def _batches(dataset, n, mesh=None, k=1):
    placed = data.sharded_batches(dataset.iter_from(0), mesh)
    if k > 1:
        placed = data.stacked_batches(placed, k)
    return [b for _, b in zip(range(n), data.prefetch(placed, "cpu"))]


def _snapshot(state):
    opt = state.opt_state
    return {"params": {k: p.detach().clone() for k, p in state.params.items()},
            "mu": {k: v.clone() for k, v in opt.mu.items()},
            "nu": {k: v.clone() for k, v in opt.nu.items()},
            "count": opt.count, "step": state.step,
            "model_state": {k: v.clone()
                            for k, v in state.model_state.items()}}


def _assert_equal(a, b):
    assert a["count"] == b["count"] and a["step"] == b["step"]
    for tree in ("params", "mu", "nu", "model_state"):
        for k, v in a[tree].items():
            assert torch.equal(v, b[tree][k]), (tree, k)


def _faulted_and_oracle(*overrides, steps=5, k=1):
    """(the guarded run under nan:FAULT, the oracle that skips that step on
    the host), as snapshots, and the faulted run's metrics."""
    cfg, trainer, dataset = _trainer(*overrides)
    batches = _batches(dataset, steps // k, k=k)
    state = trainer.init(cfg.train.seed)
    step = trainer.fused_train_step(k)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(m)
    faulted = _snapshot(state)
    _, oracle_tr, _ = _trainer(*overrides, fault=None)
    state = oracle_tr.init(cfg.train.seed)
    for i, b in enumerate(_batches(dataset, steps)):
        if i == FAULT:
            # Skip the step but keep the clock: the step counter (and with
            # it the dropout seed and the data cursor) advances.
            state = dataclasses.replace(state, step=state.step + 1)
            continue
        state, _ = oracle_tr.train_step(state, b)
    return faulted, _snapshot(state), metrics


@pytest.mark.parametrize("opt", ["adamw", "adamw_fused", "bf16_full"])
def test_skip_update_parity_bitwise(opt):
    extra = (["optim.name=adamw", "train.precision.policy=bf16_full",
              "model.kwargs.dtype=bfloat16"] if opt == "bf16_full"
             else [f"optim.name={opt}"])
    faulted, oracle, metrics = _faulted_and_oracle(*extra)
    _assert_equal(faulted, oracle)
    assert faulted["step"] == 5 and faulted["count"] == 4
    assert [int(m["skipped"]) for m in metrics] == [0, 0, 1, 0, 0]
    assert [int(m["anomalies"]) for m in metrics] == [0, 0, 1, 1, 1]
    assert [int(m["consecutive_anomalies"]) for m in metrics] == [
        0, 0, 1, 0, 0]
    assert not np.isfinite(float(metrics[FAULT]["grad_norm"]))


def test_guard_under_fused_dispatch():
    """steps_per_call=2 with the fault at scan index 0 of call 2: the same
    state as the unfused guarded run, the skip visible mid-call."""
    faulted, oracle, metrics = _faulted_and_oracle(steps=4, k=2)
    unfused, _, _ = _faulted_and_oracle(steps=4)
    _assert_equal(faulted, unfused)
    assert metrics[1]["skipped"].tolist() == [1, 0]


def test_resnet_batchnorm_statistics_kept_on_a_skip():
    """ResNet-18's forward updates its running statistics in place: a
    skipped step restores them, so the faulted run equals the oracle's
    statistics too, and the skipped step's own statistics equal the
    previous step's."""
    rn = ["model.name=resnet18", "model.kwargs={'num_classes': 10, "
          "'width': 8}", "data.kind=synthetic_image", "data.batch_size=8",
          "data.image_size=16", "data.num_classes=10", "optim.name=sgd",
          "optim.lr=0.05", "train.task=classification"]
    cfg, trainer, dataset = _trainer(*rn)
    batches = _batches(dataset, 4)
    state = trainer.init(cfg.train.seed)
    seen = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        seen.append({k: v.clone() for k, v in state.model_state.items()})
    assert state.model_state and int(m["anomalies"]) == 1
    for k in seen[0]:
        assert torch.equal(seen[FAULT][k], seen[FAULT - 1][k]), k
        assert not torch.equal(seen[FAULT + 1][k], seen[FAULT][k]) or (
            k.endswith("num_batches_tracked")), k
    _, oracle_tr, _ = _trainer(*rn, fault=None)
    ostate = oracle_tr.init(cfg.train.seed)
    for i, b in enumerate(batches):
        if i == FAULT:
            ostate = dataclasses.replace(ostate, step=ostate.step + 1)
            continue
        ostate, _ = oracle_tr.train_step(ostate, b)
    for k, v in ostate.model_state.items():
        assert torch.equal(v, state.model_state[k]), k
    for k, p in ostate.params.items():
        assert torch.equal(p, state.params[k]), k


def test_metrics_stream_and_losses_match_the_jax_trainer():
    """The JAX Trainer with the same guard and fault on the same init:
    the per-step guard metrics equal, the losses within 1e-5 relative."""
    import flax.linen as nn

    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    from helpers import train_tiny_gpt2

    mesh = single_device_mesh()
    j_losses, jstate = train_tiny_gpt2(
        mesh, n_steps=0, health=JaxHealth(enabled=True),
        fault_nan_step=FAULT)
    init = from_jax_params(jax.tree.map(np.asarray,
                                        nn.meta.unbox(jstate.params)))
    from distributeddeeplearning_tpu import data as jax_data
    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu import train as jax_train

    jt = jax_train.Trainer(
        jax_models.get_model("gpt2", size="tiny", vocab_size=256,
                             max_len=64, dropout_rate=0.0),
        jax_train.make_optimizer("adamw", 1e-3), jax_train.get_task("lm"),
        mesh, donate=False, health=JaxHealth(enabled=True),
        fault_nan_step=FAULT)
    ds = jax_data.SyntheticTokens(batch_size=16, seq_len=32, vocab_size=256,
                                  seed=0, n_distinct=4)
    js, want = jt.init(0, ds.batch(0)), []
    for i, b in enumerate(jax_data.sharded_batches(ds, mesh)):
        if i == 5:
            break
        js, m = jt.train_step(js, b)
        want.append({k: float(m[k]) for k in (
            "loss", "skipped", "anomalies", "consecutive_anomalies")})
    cfg, trainer, dataset = _trainer()
    model = trainer.model
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(init, strict=True)
    got = []
    for b in _batches(dataset, 5):
        state, m = trainer.train_step(state, b)
        got.append({k: float(m[k]) for k in want[0]})
    for g, w in zip(got, want):
        assert {k: g[k] for k in w if k != "loss"} == {
            k: w[k] for k in w if k != "loss"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    assert state.health.anomaly_count == int(js.health.anomaly_count) == 1
    assert (state.health.ema_steps == int(js.health.ema_steps) == 4)


# ---------------------------------------------------------------------------
# fit, schema, checkpoints
# ---------------------------------------------------------------------------


def test_fit_raises_health_rollback():
    """A streak reaching max_consecutive_anomalies, read from the LOGGED
    metric stream (one interval of deferred lag), becomes HealthRollback
    after a health_rollback event."""
    cfg, trainer, dataset = _trainer()
    lines = []
    with pytest.raises(train.HealthRollback) as ei:
        train.fit(trainer, trainer.init(0), _batches(dataset, 8), steps=8,
                  log_every=1, log_fn=lines.append,
                  health=HealthConfig(enabled=True,
                                      max_consecutive_anomalies=1))
    assert ei.value.step == 3 and ei.value.consecutive == 1
    assert lines[-1] == {"event": "health_rollback", "step": 3,
                         "consecutive": 1}
    assert [r["step"] for r in lines[:-1]] == [1, 2, 3]


def test_trainstate_schema_unchanged_when_guard_off(tmp_path):
    cfg, trainer, dataset = _trainer("health.enabled=False", fault=None)
    state = trainer.init(0)
    assert state.health is None
    state, m = trainer.train_step(state, _batches(dataset, 1)[0])
    assert "skipped" not in m and "grad_norm" not in m
    with CheckpointManager(str(tmp_path)) as ckpt:
        assert ckpt.save(1, state)
        ckpt.wait()
        assert "health" not in ckpt._load(1)[0]


def test_health_state_round_trips_through_a_checkpoint(tmp_path):
    cfg, trainer, dataset = _trainer()
    state = trainer.init(0)
    for b in _batches(dataset, 3):
        state, _ = trainer.train_step(state, b)
    assert state.health.anomaly_count == 1
    with CheckpointManager(str(tmp_path)) as ckpt:
        assert ckpt.save(3, state)
    _, tr2, _ = _trainer()
    with CheckpointManager(str(tmp_path)) as ckpt:
        restored, _ = ckpt.restore(tr2.init(1))
    assert restored.health == state.health


def test_fault_injection_parser_follows_the_reference():
    from distributeddeeplearning_tpu.train import (
        parse_fault_injection as jax_parse,
    )

    for spec in ("", "nan:3", "step:0", "hang:12", "corrupt:4"):
        want = jax_parse(spec)
        got = train.parse_fault_injection(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(got) == tuple(want)
    for bad in ("nan", "nan:x", "boom:3"):
        with pytest.raises(ValueError, match="expected one of"):
            train.parse_fault_injection(bad)


# ---------------------------------------------------------------------------
# ZeRO-1 at dp=2: every rank decides the same
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert init_distributed("cpu")
    cfg = _cfg("mesh.dp=2", "train.zero1=True", "train.grad_accum=2")
    mesh = build_mesh(cfg.mesh)
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh,
                                        fault_nan_step=FAULT)
    state = trainer.init(cfg.train.seed)
    skipped = []
    for b in _batches(dataset, 5, mesh):
        state, m = trainer.train_step(state, b)
        skipped.append(int(m["skipped"]))
    torch.save({"skipped": skipped, "count": state.opt_state.count,
                "params": {k: p.detach().clone()
                           for k, p in state.params.items()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_zero1_dp2_ranks_skip_together(tmp_path):
    torch.multiprocessing.spawn(_worker, args=(2, _free_port(),
                                               str(tmp_path)),
                                nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in ranks:
        assert r["skipped"] == [0, 0, 1, 0, 0] and r["count"] == 4
    for k, p in ranks[0]["params"].items():
        assert torch.isfinite(p).all() and torch.equal(p,
                                                       ranks[1]["params"][k])


# ---------------------------------------------------------------------------
# cli train: nan:K, rollback, give-up
# ---------------------------------------------------------------------------


def _cli(tmp_path, *overrides):
    argv = ["train", "--config", CONFIG, "--device", "cpu"]
    for o in TINY + ["train.log_every=1", "train.steps=6",
                     f"train.checkpoint_dir={tmp_path}/ckpt",
                     "train.save_every=2", *overrides]:
        argv += ["--override", o]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    recs = [json.loads(x) for x in out.getvalue().splitlines()
            if x.startswith("{")]
    return rc, recs, out.getvalue(), err.getvalue()


def test_cli_train_detects_nan_and_rolls_back(tmp_path):
    rc, recs, text, _ = _cli(tmp_path, "train.fault_injection=nan:2",
                             "health.max_consecutive_anomalies=1")
    assert rc == 0
    events = [r["event"] for r in recs if "event" in r]
    assert events == ["health_rollback", "rollback_restart"]
    restart = next(r for r in recs if r.get("event") == "rollback_restart")
    assert restart == {"event": "rollback_restart", "rollbacks": 1,
                       "step": 3, "consecutive": 1}
    assert "resumed from step 2" in text
    steps = [r["step"] for r in recs if "event" not in r]
    assert steps == [1, 2, 3, 3, 4, 5, 6]
    # The replay from the checkpoint runs with the fault disarmed.
    assert [r["skipped"] for r in recs if "event" not in r] == [
        0, 0, 1, 0, 0, 0, 0]


def test_cli_train_gives_up_after_max_rollbacks(tmp_path):
    rc, recs, _, err = _cli(tmp_path, "train.fault_injection=nan:2",
                            "health.max_consecutive_anomalies=1",
                            "health.max_rollbacks=0")
    assert rc == 1
    give_up = json.loads(err.strip().splitlines()[-1])
    assert give_up == {"event": "rollback_give_up", "rollbacks": 0,
                       "max_rollbacks": 0, "step": 3}


def test_cli_train_guard_without_rollback_skips_and_finishes(tmp_path):
    rc, recs, _, _ = _cli(tmp_path, "train.fault_injection=nan:3")
    assert rc == 0
    train_recs = [r for r in recs if "event" not in r]
    assert [r["skipped"] for r in train_recs] == [0, 0, 0, 1, 0, 0]
    assert [r["anomalies"] for r in train_recs] == [0, 0, 0, 1, 1, 1]
