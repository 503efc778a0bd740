"""Evaluation, multi-step dispatch and the metrics writer of the port,
after the JAX package's ``tests/test_eval.py``, ``tests/test_fused_steps.py``
and ``tests/test_observability.py``.

- ``evaluate`` equals JAX's ``evaluate`` on the same weights and batches
  (1e-5 relative), in fp32 under the bf16 policy too;
- ``fit(eval_every=...)`` emits ``eval_*`` records at the cadence and after
  the last step; ``cli eval`` reports the same numbers;
- ``steps_per_call=1`` is today's step loop bit for bit, and
  ``steps_per_call=4`` equals 4 unfused steps bit for bit (also with
  ``grad_accum=2``);
- the cadence fences raise JAX's messages, before any batch is drawn;
  ``stacked_batches`` stacks and drops the tail as JAX's;
- ``<log_dir>/metrics.jsonl`` has JAX's line schema, and disk trouble does
  not stop the run; a profiler window on the CPU writes a Chrome trace.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, metrics, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=32", "data.batch_size=8",
    "data.n_distinct=4", "optim.lr=1e-2", "optim.warmup_steps=2",
    "train.head_chunk=16", "train.steps=8", "data.eval_seed=7",
    "train.eval_batches=3",
]


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def _cli(*overrides, cmd="train"):
    argv = [cmd, "--config", CONFIG, "--device", "cpu"]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue().strip().splitlines()


def _records(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


@pytest.fixture(scope="module")
def jax_eval():
    """JAX's evaluate over 3 eval batches (eval_seed 7) at the JAX init,
    and that init's weights for the port."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu import data as jax_data
    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
    from distributeddeeplearning_tpu.train import evaluate as jax_evaluate
    from distributeddeeplearning_tpu.train import get_task as jax_get_task
    from distributeddeeplearning_tpu.train import (
        make_optimizer as jax_make_opt,
    )
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    mesh = single_device_mesh()
    jm = jax_models.get_model("gpt2", size="tiny", vocab_size=256,
                              max_len=64, attn_impl="flash",
                              chunked_head=True)
    jtrainer = JaxTrainer(jm, jax_make_opt("adamw", 1e-3),
                          jax_get_task("lm", head_chunk=16), mesh,
                          donate=False)
    ds = jax_data.SyntheticTokens(batch_size=8, seq_len=32, vocab_size=256,
                                  n_distinct=4, seed=7)
    jstate = jtrainer.init(0, ds.batch(0))
    got = jax_evaluate(jtrainer, jstate, jax_data.sharded_batches(
        (ds.batch(i) for i in range(3)), mesh))
    return got, from_jax_params(jax.tree.map(np.asarray,
                                             nn.meta.unbox(jstate.params)))


def _port(*overrides, weights=None):
    cfg = _cfg(*overrides)
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    state = trainer.init(cfg.train.seed)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return cfg, trainer, dataset, state


def test_evaluate_matches_jax(jax_eval):
    want, weights = jax_eval
    cfg, trainer, _, state = _port(weights=weights)
    got = train.evaluate(trainer, state,
                         cli.make_eval_fn(cfg, trainer.mesh, "cpu")())
    assert set(got) == set(want) == {"eval_loss", "eval_perplexity"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["eval_perplexity"] == math.exp(got["eval_loss"])


def test_eval_metrics_are_fp32_under_bf16_compute():
    cfg, trainer, dataset, state = _port("model.kwargs.dtype=bfloat16",
                                         "train.precision.policy=bf16")
    m = trainer.eval_step(state, data.to_device(dataset.batch(0), "cpu"))
    assert all(v.dtype == torch.float32 for v in m.values())


def test_evaluate_refuses_an_empty_pass():
    _, trainer, _, state = _port()
    with pytest.raises(ValueError, match="empty batch iterable"):
        train.evaluate(trainer, state, [])


def test_fit_emits_eval_records_at_the_cadence_and_the_end():
    lines = _cli("train.steps=5", "train.log_every=1", "train.eval_every=2")
    evals = [r for r in _records(lines) if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 4, 5]
    trains = [r["step"] for r in _records(lines) if "loss" in r]
    assert trains == [1, 2, 3, 4, 5]
    assert all(set(r) == {"eval_loss", "eval_perplexity", "step"}
               for r in evals)


def test_fit_refuses_eval_every_without_eval_fn():
    _, trainer, dataset, state = _port()
    with pytest.raises(ValueError, match="eval_every > 0 requires eval_fn"):
        train.fit(trainer, state, [], steps=2, eval_every=1)


def test_cmd_eval_reports_evaluate():
    cfg, trainer, _, state = _port()
    want = train.evaluate(trainer, state,
                          cli.make_eval_fn(cfg, trainer.mesh, "cpu")())
    lines = _cli(cmd="eval")
    assert lines[0] == ("no checkpoint found — evaluating freshly "
                        "initialized params")
    (rec,) = _records(lines)
    assert rec == {**want, "step": 0}


def _loop(*overrides, steps=8, k=1, log_every=4):
    cfg, trainer, dataset, state = _port(*overrides)
    placed = data.sharded_batches(dataset.iter_from(0), None)
    if k > 1:
        placed = data.stacked_batches(placed, k)
    state, hist = train.fit(trainer, state, data.prefetch(placed, "cpu"),
                            steps=steps, log_every=log_every,
                            steps_per_call=k, log_fn=lambda m: None)
    return [r["loss"] for r in hist], state


def _assert_same_state(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
    assert a.opt_state.count == b.opt_state.count and a.step == b.step


def test_steps_per_call_1_is_todays_step_loop():
    cfg, trainer, dataset, state = _port()
    assert trainer.fused_train_step(1) == trainer.train_step
    losses = []
    for i in range(8):
        state, m = trainer.train_step(
            state, data.to_device(dataset.batch(i), "cpu"))
        losses.append(float(m["loss"]))
    got, fit_state = _loop(log_every=1)
    assert got == losses
    _assert_same_state(fit_state, state)


@pytest.mark.parametrize("accum", [1, 2])
def test_steps_per_call_4_equals_4_unfused_steps(accum):
    extra = f"train.grad_accum={accum}"
    fused, s_fused = _loop(extra, k=4)
    plain, s_plain = _loop(extra, k=1)
    assert fused == plain and len(fused) == 2
    _assert_same_state(s_fused, s_plain)


def test_fused_step_returns_metrics_stacked_over_the_steps():
    _, trainer, dataset, state = _port()
    sb = next(data.stacked_batches(dataset.iter_from(0), 4))
    state, m = trainer.fused_train_step(4)(state, data.to_device(sb, "cpu"))
    assert state.step == 4 and m["loss"].shape == (4,)
    with pytest.raises(ValueError, match="superbatch of 4 steps"):
        trainer.fused_train_step(2)(state, data.to_device(sb, "cpu"))


CADENCES = [
    dict(steps=7), dict(steps=8, log_every=3), dict(steps=8, eval_every=5),
    dict(steps=8, save_every=5), dict(steps=8, start=3),
]


@pytest.mark.parametrize("k,kwargs", [(2, kw) for kw in CADENCES]
                         + [(0, dict(steps=8))])
def test_fusion_cadence_fences_match_jax(k, kwargs):
    from distributeddeeplearning_tpu.train import (
        check_fusion_cadences as jax_check,
    )

    with pytest.raises(ValueError) as want:
        jax_check(k, **kwargs)
    with pytest.raises(ValueError) as got:
        train.check_fusion_cadences(k, **kwargs)
    assert str(got.value) == str(want.value)


def test_fit_refuses_a_bad_cadence_before_drawing_a_batch():
    class Boom:
        def __iter__(self):
            raise AssertionError("batches drawn despite the fence")

    state = train.TrainState(step=0, params={}, opt_state=None, rng=0)
    with pytest.raises(ValueError, match="divide log_every"):
        train.fit(None, state, Boom(), steps=8, log_every=3,
                  steps_per_call=2)


def test_cli_fences_a_bad_steps_per_call_before_the_build():
    with pytest.raises(ValueError, match="divide steps=10"):
        cli.cmd_train(_cfg("train.steps=10", "train.steps_per_call=4"),
                      device="cpu")


def test_stacked_batches_match_jax_shapes_and_tail():
    from distributeddeeplearning_tpu import data as jax_data

    ds = data.SyntheticTokens(batch_size=4, seq_len=8)
    got = list(data.stacked_batches((ds.batch(i) for i in range(7)), 3))
    want = list(jax_data.stacked_batches((ds.batch(i) for i in range(7)),
                                         3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["tokens"].shape == (3, 4, 9)
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    with pytest.raises(ValueError, match="steps_per_call=0"):
        next(data.stacked_batches(iter([]), 0))


def test_metrics_jsonl_schema(tmp_path, capsys):
    logdir = tmp_path / "logs"
    _cli("train.steps=4", "train.log_every=2", "train.eval_every=4",
         f"train.log_dir={logdir}")
    lines = [json.loads(x) for x in
             (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["schema"], r["step"]) for r in lines] == [(1, 2), (1, 4),
                                                        (1, 4)]
    assert set(lines[0]) == {"schema", "step", "loss", "perplexity",
                             "wall_s"}
    assert set(lines[2]) == {"schema", "step", "eval_loss",
                             "eval_perplexity"}
    assert capsys.readouterr().err.count("TensorBoard sink not ported") == 1


def test_metrics_jsonl_line_is_jaxs(tmp_path):
    from distributeddeeplearning_tpu.metrics import MetricWriter as JaxWriter

    for cls, name in ((metrics.MetricWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / name))
        w.write(3, {"loss": 1.5, "wall_s": 0.25})
        w.close()
    assert ((tmp_path / "port" / "metrics.jsonl").read_text()
            == (tmp_path / "jax" / "metrics.jsonl").read_text())


def test_metric_writer_survives_disk_trouble(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    w = metrics.MetricWriter(str(blocker / "logs"))  # cannot be made
    w.write(1, {"loss": 1.0})
    w.flush()
    w.close()


@pytest.mark.parametrize("spec", ["", "12:20", "3", "5:5"])
def test_profile_window_parsing_matches_jax(spec):
    from distributeddeeplearning_tpu.metrics import (
        parse_profile_window as jax_parse,
    )

    try:
        want = jax_parse(spec)
    except ValueError:
        with pytest.raises(ValueError, match="stop must be > start"):
            metrics.parse_profile_window(spec)
        return
    assert metrics.parse_profile_window(spec) == want


def test_profiler_window_writes_a_trace_on_the_cpu(tmp_path):
    _cli("train.steps=4", "train.profile_steps=1:3",
         f"train.log_dir={tmp_path}")
    trace = json.loads((tmp_path / "trace_1_3.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
