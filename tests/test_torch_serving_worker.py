"""The port's fleet worker (``serving/worker.py``) and socket transport
(``SocketReplica``) against the JAX package's, over socketpairs, with
injected clocks (``tests/torch_fleet.py``): the JAX worker and the port's
get the same op sequence, and every frame they push — ``hello`` (but its
pid), ``admitted``, ``result``, ``heartbeat`` with its gauges, digests and
``num_compiles`` — must be equal. Each scenario runs once per module on
each side (``_run``).

Covered: a socket fleet's greedy parity and compile pin, pushed digests,
poll streaming, drain, shutdown, an unknown op, the router's EOF, SIGTERM's
drain to ``EXIT_PREEMPTED``, the staleness sweep (quarantine and reroute;
pause-aware), the role split over sockets with a multi-part handoff, the
pure ``_fleet_plan`` and ``read_worker_ready``, and one real
``cli serve --fleet 2 --device cpu`` in subprocesses.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.cli import _fleet_plan as jax_fleet_plan
from distributeddeeplearning_tpu_torch.cli import (
    _fleet_plan,
    read_worker_ready,
)
from distributeddeeplearning_tpu_torch.supervisor import EXIT_PREEMPTED
from torch_fleet import (
    cell_clock,
    drive,
    share_jax_programs,
    sides,
    submit_all,
)
from torch_fleet import tokens as tokens_of
from torch_serving import prompts

torch.set_num_threads(2)

_MAX_NEW = 9
_TRACE = prompts((5, 9, 3, 12, 7, 4))
_FLEET = dict(heartbeat_interval_s=0.5, heartbeat_timeout_s=2.0)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"


@pytest.fixture(scope="module")
def both():
    undo = share_jax_programs()
    yield sides()
    undo()


def _frame(msg):
    """A pushed frame as compared: a hello without its pid, a goodbye's
    engine stats without the port's ``device`` (the JAX engine has none),
    a KV frame as its meta and body size."""
    if not isinstance(msg, dict):
        return {"kv": msg.meta, "body": len(msg.body)}
    out = {k: v for k, v in msg.items() if k != "pid"}
    if out.get("type") == "goodbye":
        out["stats"] = {k: v for k, v in out["stats"].items()
                        if k != "device"}
    return out


def _record_frames(transport, log):
    """Log every frame the worker pushes (the handshake's hello first),
    before the transport folds it."""
    orig = transport._handle
    log.append(_frame(transport.hello))

    def handle(msg):
        log.append(_frame(msg))
        return orig(msg)

    transport._handle = handle


def _fleet(side, cfg, clock, n=2, **kw):
    workers, router = side.socket_fleet(n, cfg, clock, **kw)
    logs = [[] for _ in router.replicas]
    for r, log in zip(router.replicas, logs):
        _record_frames(r, log)
    return workers, router, logs


def _beat(router, workers, t, cfg):
    """One heartbeat interval more: every worker pushes its gauges."""
    t[0] += cfg.heartbeat_interval_s + 0.01
    for w in workers:
        w.pump()
    router.step()


def _router_view(router):
    st = router.stats()
    per = st.pop("per_replica")
    return {"routes": dict(router.routes),
            "tokens": tokens_of(router.finished()),
            "stats": st,
            "heartbeats": [p["heartbeat_seq"] for p in per],
            "events": [{k: v for k, v in e.items() if k != "error"}
                       for e in router.events]}


def _parity(side):
    t, clock = cell_clock()
    cfg = side.cfg(**_FLEET)
    workers, router, logs = _fleet(side, cfg, clock)
    submit_all(router, side, _TRACE, _MAX_NEW)
    drive(router, workers, t)
    _beat(router, workers, t, cfg)
    out = _router_view(router)
    out["frames"] = logs
    out["worker_compiles"] = [w.engine.num_compiles for w in workers]
    return out


def _digests(side):
    t, clock = cell_clock()
    cfg = side.cfg(prefix_cache=True, suffix_buckets=(4,), **_FLEET)
    workers, router, logs = _fleet(side, cfg, clock, n=1)
    prompt = _TRACE[3]
    router.submit(side.Request(prompt=list(prompt), max_new_tokens=6,
                               request_id=0))
    drive(router, workers, t)
    t[0] += cfg.heartbeat_interval_s + 0.01
    workers[0].pump()
    router.step()
    workers[0].pump()
    (sr,) = router.replicas
    probe = side.serving.chain_digests(prompt + [1, 2, 3], cfg.block_size)
    out = _router_view(router)
    out.update(frames=logs, match=sr.match_digests(probe),
               gauges=sr.load_gauges(t[0]), ack=workers[0].last_ack_seq,
               seq=sr.heartbeat_seq)
    return out


def _raw(side, ops):
    """A lone worker with the test as its router: ``ops`` is a list of
    frames to send (``None`` = advance the clock and pump once). Returns
    every frame the worker sent, and the worker."""
    import socket

    t, clock = cell_clock()
    cfg = side.cfg(**_FLEET)
    rs, ws = socket.socketpair()
    rs.setblocking(False)
    ws.setblocking(False)
    w = side.worker_mod.ReplicaWorker(
        side.engine(cfg, clock), ws, clock=clock, sleep=lambda s: None,
        heartbeat_interval_s=cfg.heartbeat_interval_s)
    w.start()
    dec, got = side.net.FrameDecoder(), []

    def recv():
        got.extend(_frame(m) for m in side.net.recv_available(rs, dec)
                   or [])

    for op in ops:
        if op == "close":
            rs.close()
            for _ in range(40):
                t[0] += 0.01
                w.pump()
                if w.exit_code is not None:
                    break
            continue
        if op is None:
            t[0] += 0.01
            w.pump()
        else:
            side.net.send_frame(rs, op)
            w.pump()
        recv()
    return got, w


def _submit_op(rid, prompt, new, t0=100.0):
    return {"op": "submit", "arrival_s": t0, "request": {
        "prompt": list(prompt), "max_new_tokens": new, "request_id": rid}}


def _ops(side):
    ops = [_submit_op(0, [1, 2, 3, 4, 5], 8)]
    for _ in range(12):
        ops += [None, {"op": "poll"}]
    ops += [{"op": "frobnicate"}, {"op": "drain"}, {"op": "shutdown"},
            None, None]
    got, w = _raw(side, ops)
    return {"frames": got, "exit": w.exit_code,
            "final": [list(s.generated) for s in w.engine.scheduler.finished]}


def _eof(side):
    got, w = _raw(side, [_submit_op(0, [1, 2, 3], 4), None, "close"])
    return {"frames": got, "exit": w.exit_code, "draining": w.engine.draining,
            "final": [list(s.generated) for s in w.engine.scheduler.finished]}


def _sigterm(side, tmp):
    t, clock = cell_clock()
    cfg = side.cfg(**_FLEET)
    tel = side.Telemetry(enabled=True, out_dir=tmp, process_index=0)
    workers, router, logs = _fleet(side, cfg, clock, n=1,
                                   telemetry=tel)
    (w,), (sr,) = workers, router.replicas
    submit_all(router, side, _TRACE[:2], _MAX_NEW)
    w.pump()
    router.step()
    w.on_sigterm()
    for _ in range(2000):
        if w.exit_code is not None and router.idle:
            break
        t[0] += 0.01
        w.pump()
        router.step()
    return {"exit": w.exit_code, "goodbye": sr.goodbye["exit"],
            "tokens": tokens_of(router.finished()),
            "files": sorted(os.listdir(tmp)),
            "frames": [f for f in logs[0] if f.get("type") != "goodbye"]}


def _stale(side):
    t, clock = cell_clock()
    cfg = side.cfg(router_policy="round_robin", slots=1, **_FLEET)
    workers, router, logs = _fleet(side, cfg, clock)
    submit_all(router, side, _TRACE[:4], _MAX_NEW)
    drive(router, workers, t, dt=0.25, pump=workers[1:])
    out = _router_view(router)
    out["frames"] = logs
    return out


def _pause(side):
    t, clock = cell_clock()
    cfg = side.cfg(**_FLEET)
    workers, router, _ = _fleet(side, cfg, clock)
    t[0] += 0.01
    for w in workers:
        w.pump()
    router.step()
    t[0] += 5.0 * cfg.heartbeat_timeout_s  # the router's own blackout
    router.step()
    after_pause = [r.quarantined for r in router.replicas]
    for _ in range(6):
        t[0] += cfg.heartbeat_timeout_s / 4.0
        router.step()
    return {"after_pause": after_pause,
            "after_silence": [r.quarantined for r in router.replicas],
            "errors": [r.error for r in router.replicas]}


def _split(side, per_frame):
    t, clock = cell_clock()
    cfg = side.cfg(prefix_cache=True, suffix_buckets=(4,),
                   router_policy="prefix_affinity", heartbeat_interval_s=0.05,
                   heartbeat_timeout_s=0.0, handoff_blocks_per_frame=per_frame)
    workers, router, logs = _fleet(side, cfg, clock, n=3,
                                   roles=["prefill", "decode", "decode"])
    trace = _split_trace()
    submit_all(router, side, trace, _MAX_NEW)
    drive(router, workers, t)
    out = _router_view(router)
    out["handoff"] = [w.engine.stats().get("handoff") for w in workers]
    out["kv_frames"] = [f["kv"] for f in logs[0] if "kv" in f]
    return out


def _split_trace():
    rng = np.random.default_rng(3)
    prefix = list(map(int, rng.integers(1, 97, 8)))
    out = [prefix + list(map(int, rng.integers(1, 97, 2 + i % 5)))
           for i in range(6)]
    return out + [list(out[0])]


def _one_engine(side, trace, **kw):
    t, clock = cell_clock()
    eng = side.engine(side.cfg(**kw), clock)
    submit_all(eng, side, trace, _MAX_NEW)
    return tokens_of(eng.run())


_SCENARIOS = {
    "parity": _parity,
    "digests": _digests,
    "ops": _ops,
    "eof": _eof,
    "stale": _stale,
    "pause": _pause,
    "split": lambda s: _split(s, 64),
    "split_multipart": lambda s: _split(s, 1),
    "one_engine": lambda s: _one_engine(s, _TRACE),
    "one_engine_split": lambda s: _one_engine(
        s, _split_trace(), prefix_cache=True, suffix_buckets=(4,)),
}
_CACHE = {}


def _run(both, name):
    if name not in _CACHE:
        _CACHE[name] = tuple(_SCENARIOS[name](side) for side in both)
    return _CACHE[name]


@pytest.mark.parametrize("name", ["parity", "digests", "ops", "eof",
                                  "stale", "pause", "split",
                                  "split_multipart"])
def test_worker_matches_jax(both, name):
    jx, pt = _run(both, name)
    assert pt == jx


def test_socket_fleet_tokens_and_compile_pin(both):
    _, pt = _run(both, "parity")
    _, one = _run(both, "one_engine")
    assert pt["tokens"] == one
    assert sorted(set(pt["routes"].values())) == [0, 1]
    pin = len((8, 16)) + 1  # warmed workers: every width and decode
    assert pt["worker_compiles"] == [pin, pin]
    assert pt["stats"]["num_compiles"] == 2 * pin
    kinds = {f.get("type") for log in pt["frames"] for f in log}
    assert {"hello", "heartbeat", "admitted", "result"} <= kinds


def test_heartbeat_pushes_digests_and_acks(both):
    _, pt = _run(both, "digests")
    beats = [f for f in pt["frames"][0] if f.get("type") == "heartbeat"]
    assert beats[-1]["digests"] and pt["match"] > 0
    assert beats[-1]["num_compiles"] == 2 + 1 + 1
    assert pt["gauges"]["pending"] == 0 and pt["gauges"]["used_blocks"] == 0
    assert pt["ack"] >= 1 and pt["seq"] == beats[-1]["seq"]


def test_poll_streams_deltas_unknown_op_and_shutdown(both):
    _, pt = _run(both, "ops")
    streamed = [t for f in pt["frames"] if f.get("type") == "poll_reply"
                for t in f["deltas"].get("0", [])]
    (final,) = pt["final"]
    assert streamed and streamed == final[:len(streamed)]
    (err,) = [f for f in pt["frames"] if f.get("type") == "error"]
    assert "frobnicate" in err["error"]
    assert any(f.get("type") == "drained" for f in pt["frames"])
    (bye,) = [f for f in pt["frames"] if f.get("type") == "goodbye"]
    assert bye["exit"] == 0 == pt["exit"]


def test_router_eof_is_a_clean_shutdown(both):
    _, pt = _run(both, "eof")
    assert pt["exit"] == 0 and pt["draining"]
    assert len(pt["final"][0]) == 4


def test_sigterm_drains_pushes_results_and_exits_preempted(both, tmp_path):
    jx, pt = (_sigterm(side, str(tmp_path / side.name)) for side in both)
    assert pt["exit"] == pt["goodbye"] == EXIT_PREEMPTED
    assert pt["tokens"] == jx["tokens"] and len(pt["tokens"]) == 2
    assert pt["frames"] == jx["frames"]
    assert any("trace" in f for f in pt["files"])


def test_stale_heartbeat_quarantines_and_reroutes(both):
    _, pt = _run(both, "stale")
    _, one = _run(both, "one_engine")
    assert pt["tokens"] == {k: one[k] for k in range(4)}
    st = pt["stats"]
    assert st["rerouted"] == 2 and st["failed"] == 0
    (q,) = st["quarantined"]
    assert q["replica"] == 0 and "StaleHeartbeat" in q["error"]
    assert all(v == 1 for v in pt["routes"].values())


def test_staleness_sweep_is_pause_aware(both):
    _, pt = _run(both, "pause")
    assert pt["after_pause"] == [False, False]
    assert pt["after_silence"] == [True, True]
    assert all("StaleHeartbeat" in e for e in pt["errors"])


@pytest.mark.parametrize("name", ["split", "split_multipart"])
def test_role_split_over_sockets_equals_unified(both, name):
    jx, pt = _run(both, name)
    _, one = _run(both, "one_engine_split")
    assert pt["tokens"] == one
    assert pt["handoff"] == jx["handoff"]
    st = pt["stats"]
    assert st["handoffs"] == 7
    if name == "split_multipart":
        assert st["handoff_parts"] > st["handoffs"]
        assert all(len(k["sizes"]) == 1 for k in pt["kv_frames"])


def test_fleet_plan_is_pure_and_matches_jax():
    base = {"PATH": "/bin", "RANK": "3", "WORLD_SIZE": "8",
            "MASTER_PORT": "29500", "COORDINATOR_ADDRESS": "h:1"}
    plan = _fleet_plan("cfg.py", ["serving.slots=4"], 3, host="10.0.0.5",
                       port_base=7000, telemetry_dir="/tmp/tel",
                       spill_dir="/tmp/sp", base_env=dict(base),
                       roles=["prefill", "decode", "decode"], device="cpu")
    jplan = jax_fleet_plan("cfg.py", ["serving.slots=4"], 3,
                           host="10.0.0.5", port_base=7000,
                           telemetry_dir="/tmp/tel", spill_dir="/tmp/sp",
                           base_env=dict(base),
                           roles=["prefill", "decode", "decode"])
    assert len(plan) == 3
    for i, ((cmd, env), (jcmd, _)) in enumerate(zip(plan, jplan)):
        assert cmd[:3] == [sys.executable, "-m",
                           "distributeddeeplearning_tpu_torch.serving.worker"]
        # JAX's worker argv, then the port's --device.
        assert cmd[3:] == jcmd[3:] + ["--device", "cpu"]
        overrides = [cmd[j + 1] for j, a in enumerate(cmd)
                     if a == "--override"]
        assert overrides[-2:] == [
            f"serving.role={'prefill' if i == 0 else 'decode'}",
            "serving.prefill_replicas=0"]
        assert env["DDL_PROCESS_INDEX"] == str(i)
        assert not {"RANK", "WORLD_SIZE", "MASTER_PORT"} & set(env)
        assert env["PATH"] == "/bin"
    plan0 = _fleet_plan("cfg.py", [], 2, base_env=dict(base))
    assert all(cmd[cmd.index("--port") + 1] == "0" for cmd, _ in plan0)
    assert all("--override" not in cmd and "--device" not in cmd
               for cmd, _ in plan0)
    assert base["RANK"] == "3"  # pure


def test_read_worker_ready_skips_noise_and_errors_on_eof():
    ready = {"event": "worker_ready", "host": "127.0.0.1", "port": 41234}
    noise = []
    stream = io.StringIO("some warning line\n" + json.dumps(
        {"event": "other"}) + "\n" + json.dumps(ready) + "\n")
    assert read_worker_ready(stream, echo=noise.append) == ready
    assert len(noise) == 2
    with pytest.raises(RuntimeError, match="worker_ready"):
        read_worker_ready(io.StringIO("crashed\n"))


def test_cli_serve_fleet_of_two_worker_processes_on_cpu():
    """``cli serve --fleet 2 --device cpu``: two worker processes behind
    the router; tokens equal to the in-process single engine's and every
    exit code 0, with each worker's launch report."""
    argv = ["serve", "--config", _CONFIG, "--device", "cpu",
            "--prompt", "hello", "--prompt", "paged attention",
            "--prompt", "a fleet of two", "--max-new-tokens", "6"]
    for o in ("model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
              "model.kwargs.max_len=64", "model.kwargs.attn_impl=xla",
              "serving.prompt_buckets=(16,32)", "serving.attn_kernel=pallas"):
        argv += ["--override", o]
    env = {**os.environ, "PYTHONPATH": _ROOT}
    outs = []
    for extra in ([], ["--fleet", "2"]):
        p = subprocess.run(
            [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
             *argv, *extra], cwd=_ROOT, env=env, capture_output=True,
            text=True, timeout=240)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        outs.append(p.stdout.strip().splitlines())
    one = json.loads(outs[0][-1])
    fleet = json.loads(outs[1][-1])
    assert [r["generated"] for r in fleet["results"]] == [
        r["generated"] for r in one["results"]]
    assert fleet["worker_exit_codes"] == [0, 0]
    assert fleet["stats"]["duplicate_deliveries"] == 0
    assert fleet["stats"]["num_compiles"] == 2 * (2 + 1)
    reports = [json.loads(line.split(" ", 1)[1]) for line in outs[1]
               if line.startswith("[w") and "worker_launches" in line]
    assert sorted(r["replica"] for r in reports) == [0, 1]
    assert sum(r["calls"]["decode"] for r in reports) > 0
    assert all(r["device"] == "cpu" for r in reports)
    assert all(r["handoff"]["adopt_fallbacks"] == 0 for r in reports)


def test_worker_without_device_cpu_needs_the_card():
    """A worker started without ``--device cpu`` runs on the card or
    fails before it reports ready: no quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("asserts the refusal on a host without CUDA")
    spec = {"model": {"name": "gpt2", "kwargs": {
        "size": "tiny", "vocab_size": 97, "max_len": 64}},
        "serving": {"slots": 2, "block_size": 4, "hbm_budget_mb": 8,
                    "max_seq_len": 48, "prompt_buckets": [8]}}
    p = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serving."
         "worker", "--spec-json", json.dumps(spec)], cwd=_ROOT,
        env={**os.environ, "PYTHONPATH": _ROOT}, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert "worker_ready" not in p.stdout
    assert "torch.cuda.is_available() is False" in p.stderr
