"""The port's telemetry (``distributeddeeplearning_tpu_torch/telemetry.py``,
its own copy of the JAX package's stdlib-only module): JAX's
``tests/test_telemetry.py`` cases on the port's copy — the span tracer's
ring, nesting and Chrome-trace validity, the goodput ledger's accounting on
a fake clock, the registry, the flight recorder, the metric writer — and,
where JAX's cases drive its Trainer, CLI report or supervisor (not ported),
cases of the port's serving engine and of the two modules side by side on
the same inputs.
"""

import json
import os
import types

import numpy as np
import pytest

from distributeddeeplearning_tpu import telemetry as jax_tel
from distributeddeeplearning_tpu_torch import telemetry as tel_mod
from distributeddeeplearning_tpu_torch.config import ServingConfig
from distributeddeeplearning_tpu_torch.metrics import (
    DeferredMetrics,
    MetricWriter,
    event_record,
)
from distributeddeeplearning_tpu_torch.telemetry import (
    NULL_SPAN,
    NULL_TELEMETRY,
    DeviceRegistry,
    GoodputLedger,
    LatencyHistogram,
    SpanTracer,
    Telemetry,
    dump_flight,
    memory_analysis_dict,
    read_goodput,
    record_backoff,
    resolve_dir,
    summarize_goodput,
    validate_chrome_trace,
)


class Clock:
    """Advancable fake clock for ledger/tracer determinism."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s
        return self.t


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


def test_span_nesting_depth_and_args():
    clk = Clock()
    tr = SpanTracer(clock=clk)
    with tr.span("step", step=3):
        clk.advance(1.0)
        with tr.span("dispatch", step=3, k=2):
            clk.advance(2.0)
        clk.advance(0.5)
    assert [s.name for s in tr.spans] == ["dispatch", "step"]
    dispatch, step = tr.spans
    assert dispatch.depth == 1 and step.depth == 0
    assert dispatch.args == {"step": 3, "k": 2}
    assert step.t_start < dispatch.t_start < dispatch.t_end < step.t_end


def test_span_ring_bounded_keeps_most_recent():
    tr = SpanTracer(ring_size=8, clock=Clock())
    for i in range(50):
        with tr.span("step", step=i):
            pass
    assert len(tr) == 8
    assert [s.args["step"] for s in tr.spans] == list(range(42, 50))


def test_disabled_tracer_and_null_telemetry_are_noops():
    tr = SpanTracer(enabled=False)
    cm = tr.span("step", step=0)
    assert cm is NULL_SPAN
    with cm:
        pass
    assert len(tr) == 0
    assert NULL_TELEMETRY.span("step") is NULL_SPAN
    assert NULL_TELEMETRY.ledger is None
    assert NULL_TELEMETRY.flight_dump("x") is None
    assert NULL_TELEMETRY.write_trace() is None
    assert NULL_TELEMETRY.trace_path is None
    NULL_TELEMETRY.note_event({"event": "x"})
    NULL_TELEMETRY.record_exe("x", None)
    assert len(NULL_TELEMETRY.registry) == 0


def test_timestamps_fenced_strictly_monotonic():
    tr = SpanTracer(clock=lambda: 5.0)
    for _ in range(4):
        with tr.span("step"):
            pass
    ts = [t for s in tr.spans for t in (s.t_start, s.t_end)]
    assert all(b > a for a, b in zip(ts, ts[1:]))


def test_chrome_trace_valid_and_json_roundtrip():
    clk = Clock()
    tr = SpanTracer(clock=clk)
    for i in range(5):
        with tr.span("step", step=i):
            clk.advance(0.001)
            with tr.span("dispatch", step=i):
                clk.advance(0.003)
            clk.advance(0.0005)
    trace = json.loads(json.dumps(tr.chrome_trace()))
    assert validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    assert len(evs) == 20
    assert sum(e["ph"] == "B" for e in evs) == sum(e["ph"] == "E" for e in evs)
    assert all(b["ts"] <= a["ts"] for b, a in zip(evs, evs[1:]))
    b0 = next(e for e in evs if e["ph"] == "B" and e["name"] == "dispatch")
    assert b0["args"]["step"] == 0


def test_chrome_trace_valid_after_ring_eviction():
    clk = Clock()
    tr = SpanTracer(ring_size=5, clock=clk)
    for i in range(20):
        with tr.span("step", step=i):
            clk.advance(0.001)
            with tr.span("dispatch", step=i):
                clk.advance(0.001)
    assert validate_chrome_trace(tr.chrome_trace()) == []


def test_validate_chrome_trace_rejects_malformed():
    assert validate_chrome_trace({"nope": 1}) == ["no traceEvents list"]
    bad_pair = {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0},
        {"name": "b", "ph": "E", "ts": 1},
    ]}
    assert any("does not match" in p for p in validate_chrome_trace(bad_pair))
    unclosed = {"traceEvents": [{"name": "a", "ph": "B", "ts": 0}]}
    assert any("unclosed" in p for p in validate_chrome_trace(unclosed))
    backwards = {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 5},
        {"name": "a", "ph": "E", "ts": 3},
    ]}
    assert any("<" in p for p in validate_chrome_trace(backwards))


def test_event_records_shape(tmp_path):
    clk = Clock()
    tr = SpanTracer(clock=clk)
    with tr.span("checkpoint", step=7, forced=True):
        clk.advance(0.25)
    (rec,) = tr.to_event_records()
    assert rec["event"] == "span" and rec["span"] == "checkpoint"
    assert rec["step"] == 7 and rec["forced"] is True
    assert rec["dur_ms"] == pytest.approx(250.0)
    path = tr.write_jsonl(str(tmp_path / "spans.jsonl"))
    with open(path) as f:
        assert json.loads(f.readline())["span"] == "checkpoint"


# ---------------------------------------------------------------------------
# goodput ledger (fake clock: exact accounting)
# ---------------------------------------------------------------------------


def test_goodput_two_attempts_replay_backoff_and_summary(tmp_path):
    path = str(tmp_path / "goodput.jsonl")
    clk = Clock()
    led0 = GoodputLedger(path, attempt=0, clock=clk)
    led0.open(0)
    clk.advance(1.0)
    led0.add("compile", 1.0)
    for i in range(4):
        clk.advance(0.5)
        led0.step_time(0.5, i + 1)
    clk.advance(0.3)
    led0.add("checkpoint_stall", 0.3)
    rec0 = led0.close(4)
    assert rec0["wall_s"] == pytest.approx(3.3)
    assert rec0["categories"]["productive_step"] == pytest.approx(2.0)
    assert rec0["categories"]["other"] == pytest.approx(0.0)
    assert sum(rec0["categories"].values()) == pytest.approx(rec0["wall_s"])
    assert rec0["steps_productive"] == 4 and rec0["steps_replayed"] == 0
    assert rec0["max_step"] == 4
    record_backoff(path, 1, 2.0)
    led1 = GoodputLedger(path, attempt=1, clock=clk)
    led1.open(2)
    for end in (3, 4, 5, 6):
        clk.advance(0.5)
        led1.step_time(0.5, end)
    rec1 = led1.close(6)
    assert rec1["steps_replayed"] == 2 and rec1["steps_productive"] == 2
    assert rec1["categories"]["rollback_replay"] == pytest.approx(1.0)
    s = summarize_goodput(path)
    assert s["attempts"] == 2
    assert s["wall_s"] == pytest.approx(3.3 + 2.0 + 2.0)
    assert s["categories"]["restart_backoff"] == pytest.approx(2.0)
    assert sum(s["categories"].values()) == pytest.approx(s["wall_s"])
    assert s["goodput_fraction"] == pytest.approx(3.0 / 7.3)
    assert s["steps_productive"] == 6 and s["steps_replayed"] == 2


def test_goodput_reader_skips_torn_trailing_line(tmp_path):
    path = str(tmp_path / "goodput.jsonl")
    led = GoodputLedger(path, clock=Clock())
    led.open(0)
    led.close(0)
    with open(path, "a") as f:
        f.write('{"record": "attempt", "wall_s": 1.0, "cat')
    assert len(read_goodput(path)) == 1
    summarize_goodput(path)  # never raises
    assert summarize_goodput(str(tmp_path / "absent.jsonl")) is None


# ---------------------------------------------------------------------------
# registry, flight recorder, directories, metrics
# ---------------------------------------------------------------------------


def test_device_registry_counts_recompiles():
    reg = DeviceRegistry()
    reg.record("train_step", None, compile_s=1.5, donated_args=2)
    assert "train_step" in reg and len(reg) == 1
    e = reg.get("train_step")
    assert e["compiles"] == 1 and e["recompiles"] == 0
    assert e["compile_s"] == pytest.approx(1.5)
    assert e["donated_args"] == 2 and e["memory_analysis"] is None
    reg.record("train_step", None, compile_s=1.0)
    assert e["recompiles"] == 1 and e["compile_s"] == pytest.approx(2.5)
    assert set(reg.to_dict()["executables"]) == {"train_step"}


def test_dump_flight_truncates_and_carries_context(tmp_path):
    clk = Clock()
    tr = SpanTracer(clock=clk)
    for i in range(10):
        with tr.span("step", step=i):
            clk.advance(0.01)
    path = str(tmp_path / "flight_test.json")
    out = dump_flight(
        path, reason="fault_kill", tracer=tr,
        events=[{"event": "e", "step": i} for i in range(10)],
        last=4, step=9, phase="fault",
    )
    assert out == path
    with open(path) as f:
        rec = json.load(f)
    assert rec["reason"] == "fault_kill"
    assert rec["step"] == 9 and rec["phase"] == "fault"
    assert len(rec["spans"]) == 4 and len(rec["events"]) == 4
    assert rec["spans"][-1]["step"] == 9


def test_bundle_paths_anchor_and_process_index(tmp_path):
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), attempt=2,
                    process_index=3)
    assert tel.trace_path.endswith("trace_p3_a2.json")
    assert tel.spans_path.endswith("spans_p3_a2.jsonl")
    with open(tel.anchor_path) as f:
        anchor = json.load(f)
    assert anchor["record"] == "anchor" and anchor["process_index"] == 3
    assert tel_mod.resolve_process_index({"DDL_PROCESS_INDEX": "5"}) == 5
    assert tel_mod.resolve_process_index({"PROCESS_ID": "x"}) == 0
    assert tel_mod.stamped("trace.json", 1) == "trace_p1.json"


def test_counters_and_the_event_ring(tmp_path):
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), flight_last=3)
    for i in range(5):
        tel.note_event({"event": "e", "i": i})
    tel.count("worker_restarts")
    tel.count("worker_restarts", 2)
    assert [e["i"] for e in tel.events] == [2, 3, 4]
    assert tel.stats_dict()["counters"] == {"worker_restarts": 3}
    NULL_TELEMETRY.count("x")
    assert NULL_TELEMETRY.counters == {}


def test_resolve_dir_precedence():
    def cfg(tdir, ckpt):
        return types.SimpleNamespace(
            telemetry=types.SimpleNamespace(dir=tdir),
            train=types.SimpleNamespace(checkpoint_dir=ckpt),
        )

    assert resolve_dir(cfg("/x/tel", "/x/ckpt")) == "/x/tel"
    assert resolve_dir(cfg("", "/x/ckpt")) == "/x/ckpt/telemetry"
    assert resolve_dir(cfg("", "")).endswith("ddl_telemetry")


def test_deferred_metrics_lag_one_interval_then_flush():
    history = []
    d = DeferredMetrics(history.append)
    d.push(2, {"loss": np.float32(1.5)})
    assert history == []  # pending, not emitted
    d.push(4, {"loss": np.float32(1.25)})
    d.flush()
    assert [(h["step"], h["loss"]) for h in history] == [(2, 1.5), (4, 1.25)]
    d.push(6, {"loss": 1.0})
    d.discard()
    d.flush()
    assert len(history) == 2
    assert event_record("fault_kill", 4)["event"] == "fault_kill"


def test_metric_writer_jsonl_lines(tmp_path):
    logdir = str(tmp_path / "tb")
    w = MetricWriter(logdir)
    w.write(1, {"loss": 2.5})
    w.write(2, {"loss": 1.25, "lr": 0.001})
    w.close()
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == [
        {"schema": 1, "step": 1, "loss": 2.5},
        {"schema": 1, "step": 2, "loss": 1.25, "lr": 0.001},
    ]


def test_memory_analysis_of_a_reporting_program():
    ma = types.SimpleNamespace(
        argument_size_in_bytes=2 * 64 * 64 * 4, output_size_in_bytes=4,
        temp_size_in_bytes=16, generated_code_size_in_bytes=0)
    got = memory_analysis_dict(types.SimpleNamespace(memory_analysis=lambda: ma))
    assert got == {"argument_bytes": 32768, "output_bytes": 4,
                   "temp_bytes": 16, "generated_code_bytes": 0,
                   "alias_bytes": 0}
    assert memory_analysis_dict(object()) is None  # never raises
    reg = DeviceRegistry()
    reg.record("p", types.SimpleNamespace(memory_analysis=lambda: ma))
    assert reg.get("p")["memory_analysis"]["output_bytes"] == 4


# ---------------------------------------------------------------------------
# the two modules side by side
# ---------------------------------------------------------------------------


def _spans(mod):
    clk = Clock()
    tr = mod.SpanTracer(ring_size=6, clock=clk)
    for i in range(5):
        with tr.span("schedule", step=i) as sp:
            clk.advance(0.002)
            sp.set(request_ids=[i])
        with tr.span("decode", step=i, batch=2):
            clk.advance(0.004 + i * 1e-4)
    return tr.chrome_trace(), tr.to_event_records()


def test_tracer_output_equals_jax(tmp_path):
    assert _spans(tel_mod) == _spans(jax_tel)


def test_histograms_equal_jax_and_merge_as_union():
    rng = np.random.default_rng(0)
    a, b = rng.lognormal(-5, 2, 500), rng.lognormal(-3, 1, 300)
    port, ref = LatencyHistogram(), jax_tel.LatencyHistogram()
    for x in a:
        port.record(float(x))
        ref.record(float(x))
    assert port.to_dict() == ref.to_dict()
    assert port.summary() == ref.summary()
    other = LatencyHistogram()
    for x in b:
        other.record(float(x))
    merged = LatencyHistogram.from_dict(port.to_dict()).merge(other)
    union = LatencyHistogram()
    for x in np.concatenate([a, b]):
        union.record(float(x))
    got, want = merged.to_dict(), union.to_dict()
    assert got.pop("sum") == pytest.approx(want.pop("sum"), abs=1e-8)
    assert got == want
    assert merged.percentile(50) == union.percentile(50)


def test_stats_record_and_gauges_equal_jax(tmp_path):
    recs = []
    for mod, d in ((tel_mod, "port"), (jax_tel, "jax")):
        t = mod.Telemetry(enabled=True, out_dir=str(tmp_path / d),
                          span_clock=Clock(), wall_clock=Clock(),
                          epoch_clock=Clock(1.0))
        t.note_gauges({"pending": 3, "free_blocks": 10, "role": "unified"})
        t.note_gauges({"pending": 1, "free_blocks": 12, "role": "unified"})
        t.count("requests_retried", 2)
        t.hist("ttft").record(0.25)
        t.record_exe("serving_decode", None, compile_s=0.5)
        recs.append(t.stats_dict())
        assert t.write_trace() == t.trace_path
    assert recs[0] == recs[1]


# ---------------------------------------------------------------------------
# serving: gauges, spans, registry, flight record
# ---------------------------------------------------------------------------


def test_serving_gauges_spans_and_registry(tmp_path):
    import torch

    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.serving import (
        Request,
        ServingEngine,
    )

    torch.manual_seed(0)
    model = models.get_model("gpt2", size="tiny", vocab_size=97, max_len=64)
    cfg = ServingConfig(slots=2, block_size=8, hbm_budget_mb=8,
                        max_seq_len=48, prompt_buckets=(8,), gauge_every=2,
                        attn_kernel="pallas")
    tel = Telemetry(enabled=True, out_dir=str(tmp_path / "tel"))
    eng = ServingEngine(model, cfg, telemetry=tel, device="cpu")
    rng = np.random.default_rng(0)
    for n in (5, 7, 3):
        eng.submit(Request(prompt=list(map(int, rng.integers(1, 97, n))),
                           max_new_tokens=6))
    assert len(eng.run()) == 3
    gauges = [e for e in eng.events if e.get("event") == "serving_gauges"]
    assert gauges
    for g in gauges:
        assert g["step"] % 2 == 0
        for k in ("pending", "active", "free_blocks", "used_blocks"):
            assert isinstance(g[k], int) and g[k] >= 0
    reg = tel.registry.to_dict()["executables"]
    assert set(reg) == {"serving_decode", "serving_prefill_8"}
    assert all(e["recompiles"] == 0 and e["compile_s"] > 0
               for e in reg.values())
    assert {"schedule", "prefill", "decode"} <= {s.name
                                                for s in tel.tracer.spans}
    assert {"schedule", "prefill", "decode", "ttft", "queue_wait"} <= set(
        tel.hists)
    assert tel.hists["ttft"].count == 3
    assert validate_chrome_trace(tel.tracer.chrome_trace()) == []
    assert any(e.get("event") == "serving_gauges" for e in tel.events)
    path = tel.flight_dump("unit_test", step=eng.step_count)
    with open(path) as f:
        rec = json.load(f)
    assert rec["events"][-1]["event"] == "request_completed"
    assert rec["spans"][-1]["span"] in ("decode", "schedule")
