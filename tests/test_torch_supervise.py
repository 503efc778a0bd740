"""``cli supervise`` and the restart supervisor of the port against the JAX
package's (``tests/test_supervisor.py``, the slow ``test_supervised_*``
cases of ``tests/test_fault_tolerance.py``, ``tests/test_telemetry.py``):

- the port's ``Supervisor`` and JAX's over the same scripted children (a
  fault then a clean exit, a give-up, a hang with no heartbeat, a
  heartbeat that resets the timer, SIGTERM forwarded, SIGTERM's grace
  escalated to a kill) under one injected clock: the same event streams,
  results, backoffs and children's environments;
- ``tools/torch_chaos_run.py``'s default matrix (``nan:5 hang:7
  corrupt:6``) through ``cli supervise`` on the tiny GPT-2, the three runs
  side by side, with the asserts of JAX's ``test_supervised_*``;
- the same runs with ``--telemetry``: span names, goodput categories and
  flight-record keys are JAX's, one goodput record per attempt plus the
  backoff, and a ``goodput_summary`` at the end.
"""

import importlib.util
import json
import math
import os
import random
import threading

import pytest

from distributeddeeplearning_tpu_torch import supervisor as port_sup
from distributeddeeplearning_tpu_torch.config import (
    SupervisorConfig as PortSupervisorConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the state machine over scripted children
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeChild:
    """Exits with ``rc`` after ``run_s`` of fake time; ``rc=None`` never
    exits until killed; ``deaf`` ignores SIGTERM."""

    def __init__(self, clock, rc, run_s=0.0, deaf=False, preempted=21):
        self._clock = clock
        self._deadline = clock() + run_s
        self._rc = rc
        self._deaf = deaf
        self._preempted = preempted
        self.signals = []

    def poll(self):
        if self._rc is None or self._clock() < self._deadline:
            return None
        return self._rc

    def wait(self):
        return self._rc if self._rc is not None else -9

    def kill(self):
        if self._rc is None:
            self._rc = -9
        self._deadline = self._clock()

    def send_signal(self, sig):
        self.signals.append(int(sig))
        if not self._deaf:  # saves and exits EXIT_PREEMPTED
            self._rc = self._preempted
            self._deadline = self._clock()


def _scenario(name):
    """(config kwargs, child script, hooks) of one scenario."""
    base = dict(backoff_base_s=1.0, backoff_jitter=0.5, poll_interval_s=1.0,
                max_restarts=5)
    if name == "fault_then_clean":
        return base, [(17, 0.0), (1, 2.0), (0, 3.0)], None
    if name == "give_up":
        return {**base, "max_restarts": 2}, [(3, 1.0)] * 3, None
    if name == "hang_without_heartbeat":
        return ({**base, "hang_timeout_s": 10.0},
                [(None, 0.0), (0, 1.0)], None)
    if name == "heartbeat_resets_the_timer":
        return ({**base, "hang_timeout_s": 10.0, "poll_interval_s": 4.0},
                [(0, 30.0)], "beat")
    if name == "sigterm_forwarded":
        return base, [(None, 0.0)], "term"
    if name == "sigterm_grace_escalates":
        return ({**base, "preempt_grace_s": 10.0},
                [(None, 0.0, True)], "term")
    raise KeyError(name)


def _supervise(mod, config_cls, name, tmp_path):
    kw, script, hook = _scenario(name)
    cfg = config_cls(heartbeat_file=str(tmp_path / f"hb_{mod.__name__}"),
                     **kw)
    clock = FakeClock()
    spawned, envs, events = [], [], []
    mtime = [0.0]
    script = list(script)

    def popen(cmd, env=None, cwd=None):
        rc, run_s, *deaf = script.pop(0)
        child = FakeChild(clock, rc, run_s, deaf=bool(deaf),
                          preempted=mod.EXIT_PREEMPTED)
        spawned.append(child)
        envs.append({k: v for k, v in env.items() if k.startswith("DDL_")})
        return child

    class Rng(random.Random):
        def random(self):
            return 0.25

    holder = {}

    def sleep(s):
        clock.sleep(s)
        if hook == "beat":
            mtime[0] += 1.0  # the child touched the heartbeat
        elif hook == "term" and clock() >= 3.0:
            holder["sup"].request_shutdown()  # the SIGTERM handler's body

    sup = mod.Supervisor(["train"], cfg, env={}, popen=popen, clock=clock,
                         sleep=sleep, jitter_rng=Rng(),
                         log_fn=events.append, mtime=lambda p: mtime[0])
    holder["sup"] = sup
    res = sup.run()
    for e in events:  # the heartbeat path is each package's own file
        e.pop("cmd", None)
    hb = {e.pop("DDL_HEARTBEAT_FILE") for e in envs}
    assert hb == {cfg.heartbeat_file}
    return {
        "exit_code": res.exit_code, "restarts": res.restarts,
        "attempts": [(a.index, a.kind, a.returncode, a.backoff_s)
                     for a in res.attempts],
        "events": events, "envs": envs, "clock": clock(),
        "signals": [c.signals for c in spawned],
    }


SCENARIOS = ["fault_then_clean", "give_up", "hang_without_heartbeat",
             "heartbeat_resets_the_timer", "sigterm_forwarded",
             "sigterm_grace_escalates"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_state_machine_equals_the_reference(name, tmp_path):
    from distributeddeeplearning_tpu import supervisor as jax_sup
    from distributeddeeplearning_tpu.config import (
        SupervisorConfig as JaxSupervisorConfig,
    )

    want = _supervise(jax_sup, JaxSupervisorConfig, name, tmp_path)
    got = _supervise(port_sup, PortSupervisorConfig, name, tmp_path)
    assert got == want
    kinds = [a[1] for a in got["attempts"]]
    assert kinds == {
        "fault_then_clean": ["fault", "crash", "clean"],
        "give_up": ["crash"] * 3,
        "hang_without_heartbeat": ["hang", "clean"],
        "heartbeat_resets_the_timer": ["clean"],
        "sigterm_forwarded": ["preempted"],
        "sigterm_grace_escalates": ["crash"],
    }[name]


def test_exit_contract_equals_the_reference():
    from distributeddeeplearning_tpu import supervisor as jax_sup

    for name in ("EXIT_FAULT", "EXIT_PREEMPTED", "ATTEMPT_ENV",
                 "HEARTBEAT_ENV", "CLEAN", "PREEMPTED", "FAULT", "CRASH",
                 "HANG"):
        assert getattr(port_sup, name) == getattr(jax_sup, name), name
    for rc in (0, 1, 17, 21, -9, -15):
        assert port_sup.classify_exit(rc) == jax_sup.classify_exit(rc)


# ---------------------------------------------------------------------------
# the chaos matrix through cli supervise
# ---------------------------------------------------------------------------


TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "data.vocab_size=256", "data.seq_len=32",
    "data.batch_size=4", "optim.warmup_steps=0",
]
# Over 3x the longest gap between two heartbeats of a healthy attempt on
# a loaded host: spawn to its first record (start, first step) took up to
# 5.3 s beside five other test files on 8 cores.
HANG_TIMEOUT_S = 20


def _chaos_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_chaos_run", os.path.join(REPO, "tools", "torch_chaos_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The tool's default matrix, the three supervised runs side by side,
    each writing its telemetry beside its checkpoints."""
    tool = _chaos_tool()
    tmp = tmp_path_factory.mktemp("chaos")
    overrides = [x for o in TINY + ["telemetry.enabled=True"]
                 for x in ("--override", o)]
    args = tool.parser().parse_args([
        "--config", os.path.join(REPO, "distributeddeeplearning_tpu_torch",
                                 "configs", "gpt2_owt.py"),
        "--device", "cpu", "--hang-timeout", str(HANG_TIMEOUT_S),
        "--timeout", "240", "--out", str(tmp / "status.json"), *overrides])
    results = {}

    def run(i, fault):
        workdir = tmp / f"run{i}"
        workdir.mkdir()
        results[fault] = tool.run_one(args, fault, str(workdir))
        results[fault]["workdir"] = workdir

    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the children's
    try:
        threads = [threading.Thread(target=run, args=(i, f))
                   for i, f in enumerate(tool.DEFAULT_FAULTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    assert tool.DEFAULT_FAULTS == ["nan:5", "hang:7", "corrupt:6"]
    return results


def _max_gap(run):
    """The longest wait between two records of one attempt (a bound on
    its heartbeat gaps), in seconds."""
    ts = [t for t, rec in run["timeline"]
          if "loss" in rec or rec.get("event") == "supervisor_spawn"]
    return max(b - a for a, b in zip(ts, ts[1:]))


def _recs(run):
    return [rec for _, rec in run["timeline"]]


def _events(run):
    return [r["event"] for r in _recs(run) if "event" in r]


def test_supervised_nan_skips_in_place(chaos):
    run = chaos["nan:5"]
    assert run["ok"] and run["exit_code"] == 0, run["stderr_tail"]
    losses = [r for r in _recs(run) if "loss" in r]
    assert [r["skipped"] for r in losses] == [0.0] * 5 + [1.0] + [0.0] * 2
    assert "supervisor_restart" not in _events(run)
    assert run["final_step"] == 8 and run["restarts"] == 0
    assert len(losses) == 8 and all(math.isfinite(r["loss"])
                                    for r in losses)


def test_supervised_hang_is_killed_and_restarted(chaos):
    run = chaos["hang:7"]
    assert run["ok"] and run["exit_code"] == 0, run["stderr_tail"]
    ev = _events(run)
    for name in ("fault_hang", "supervisor_hang_kill", "supervisor_restart",
                 "fault_disarmed"):
        assert name in ev, name
    assert ev.index("fault_hang") < ev.index("supervisor_hang_kill")
    (kill,) = [r for r in _recs(run)
               if r.get("event") == "supervisor_hang_kill"]
    assert kill["hb_step"] == 7 and kill["phase"] == "log"
    assert run["final_step"] == 8 and run["restarts"] == 1


def test_supervised_corrupt_falls_back_and_restarts(chaos):
    run = chaos["corrupt:6"]
    assert run["ok"] and run["exit_code"] == 0, run["stderr_tail"]
    ev = _events(run)
    for name in ("fault_corrupt", "supervisor_restart", "fault_disarmed"):
        assert name in ev, name
    (bad,) = [r for r in _recs(run) if r.get("event") == "fault_corrupt"]
    assert bad == {"event": "fault_corrupt", "step": 6, "corrupted_step": 6}
    assert "falling back" in run["stderr_tail"]  # the restore's fallback
    assert (run["workdir"] / "ckpt" / "6.corrupt").is_dir()
    assert run["final_step"] == 8 and run["restarts"] == 1


def test_supervised_telemetry_names_are_the_references(chaos, tmp_path):
    from distributeddeeplearning_tpu import telemetry as jax_tel

    run = chaos["corrupt:6"]
    tdir = run["workdir"] / "ckpt" / "telemetry"
    ledger = [json.loads(x) for x in
              (tdir / "goodput_p0.jsonl").read_text().splitlines()]
    # One record per attempt, and the supervisor's backoff between them.
    assert [(r["record"], r["attempt"]) for r in ledger] == [
        ("attempt", 0), ("backoff", 1), ("attempt", 1)]
    cats = set().union(*(r["categories"] for r in ledger
                         if r["record"] == "attempt"))
    assert cats <= set(jax_tel.GOODPUT_CATEGORIES)
    assert {"compile", "productive_step", "checkpoint_stall", "data_wait",
            "rollback_replay", "other"} <= cats
    # The restart resumes at 4: step 5 is its first (cold) call, classed
    # compile; step 6 is replayed ground; 7 and 8 are new.
    assert (ledger[2]["steps_replayed"], ledger[2]["steps_productive"]) == (
        1, 2)
    spans = {json.loads(x)["span"] for a in (0, 1) for x in
             (tdir / f"spans_p0_a{a}.jsonl").read_text().splitlines()}
    assert spans == {"step", "data_wait", "dispatch", "device_wait",
                     "checkpoint"}
    assert spans <= set(jax_tel.SPAN_NAMES)
    flight = json.loads(
        (tdir / "flight_fault_corrupt_p0_attempt0.json").read_text())
    want = json.loads(open(jax_tel.Telemetry(
        enabled=True, out_dir=str(tmp_path)).flight_dump(
            "fault_corrupt", step=6, phase="fault")).read())
    assert set(flight) == set(want)
    assert (flight["reason"], flight["step"], flight["phase"]) == (
        "fault_corrupt", 6, "fault")
    assert flight["events"][-1]["event"] == "fault_corrupt"
    (summary,) = [r for r in _recs(run)
                  if r.get("event") == "goodput_summary"]
    assert summary["attempts"] == 2
    assert summary["categories"]["restart_backoff"] > 0
    assert 0 < summary["goodput_fraction"] < 1


def test_supervise_refuses_xla_flags_and_a_cache_over_the_build():
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.ops._build import BUILD_DIR

    config = os.path.join(REPO, "distributeddeeplearning_tpu_torch",
                          "configs", "gpt2_owt.py")
    with pytest.raises(NotImplementedError, match="--xla-perf-flags"):
        cli.main(["supervise", "--config", config, "--xla-perf-flags"])
    # The port has no persistent compile cache: a cache directory, here
    # one over the kernels' build, is refused before any child starts.
    cache = f"train.compile_cache_dir={os.path.dirname(BUILD_DIR)}"
    with pytest.raises(NotImplementedError,
                       match="no persistent compile cache"):
        cli.main(["supervise", "--config", config, "--override", cache])
    with pytest.raises(NotImplementedError,
                       match="no persistent compile cache"):
        cli.check_train_composition(
            cli.apply_overrides(cli.load_config(config), [cache]))


def test_cli_report_is_refused_by_name():
    from distributeddeeplearning_tpu_torch import cli

    with pytest.raises(NotImplementedError,
                       match=r"cli report: .*ROADMAP queue A14"):
        cli.main(["report", "--dir", "/nonexistent"])
