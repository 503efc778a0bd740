"""The port's serving chaos harness (``tools/torch_serve_chaos.py``) against
the JAX package's (``tools/serve_chaos.py``, ``tests/test_serve_chaos.py``):

- ``check_status`` on JAX's green status and each of its mutations: the
  same failures, word for word; the tool's ``--validate`` mode (JAX's
  ``--check``) on a status file;
- the trace builders and ``_spec`` equal JAX's;
- the worker's ``--dwell-s`` and ``--constrain-pool``, each on in a real
  worker process;
- one live ``worker_crash`` run of real worker processes on the CPU (no
  exhaustion run): exactly once, token parity with the oracle, the
  restarted worker re-warmed from its spill checkpoint.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the dataclasses of the module look it up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return (_load("serve_chaos", os.path.join(REPO, "tools",
                                              "serve_chaos.py")),
            _load("torch_serve_chaos", os.path.join(
                REPO, "tools", "torch_serve_chaos.py")))


def _green_status():
    """JAX's minimal status the validator must accept."""
    def run(kind, **over):
        rec = {
            "run": kind, "ok": True, "submitted": 28, "served": 28,
            "shed": 0, "dropped": 0, "duplicate_deliveries": 0,
            "token_parity": True, "checks": {},
            "restart_records": [
                {"replica": 0, "attempt": 1, "kind": "fault",
                 "recovery_s": 10.0, "spill_rewarm_chains": 3},
            ],
        }
        rec.update(over)
        return rec

    kinds = ["worker_crash", "worker_hang", "conn_drop", "heartbeat_stall"]
    return {
        "bench": "serve_chaos", "kinds": kinds, "exhaustion_run": True,
        "ok": True,
        "runs": [run(k) for k in kinds] + [
            run("exhaustion", restart_records=[]),
        ],
    }


MUTATIONS = [
    ("green", lambda s: None),
    ("run_missing", lambda s: s["runs"].pop(0)),
    ("failed_checks", lambda s: s["runs"][1].update(
        ok=False, checks={"token_parity": False})),
    ("accounting", lambda s: s["runs"][2].update(served=27)),
    ("duplicates", lambda s: s["runs"][3].update(duplicate_deliveries=1)),
    ("parity", lambda s: s["runs"][0].update(token_parity=False)),
    ("no_rewarm", lambda s: s["runs"][0]["restart_records"][0].update(
        spill_rewarm_chains=0)),
    ("exhaustion_missing", lambda s: s["runs"].pop()),
    ("status_not_ok", lambda s: s.update(ok=False)),
]


@pytest.mark.parametrize("name,mutate", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_check_status_flags_what_the_reference_flags(tools, name, mutate):
    jax_tool, port_tool = tools
    fails = []
    for tool in tools:
        status = _green_status()
        mutate(status)
        fails.append(tool.check_status(status))
    assert fails[1] == fails[0]
    assert bool(fails[1]) == (name != "green")


@pytest.mark.parametrize("name", ["green", "parity"])
def test_validate_mode_reads_a_status_file(name, tmp_path):
    """``--validate --out F`` re-checks a status file the tool wrote,
    running nothing, with JAX's ``--check`` verdict line."""
    status = _green_status()
    dict(MUTATIONS)[name](status)
    path = tmp_path / "status.json"
    path.write_text(json.dumps(status))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_serve_chaos.py"),
         "--validate", "--out", str(path)],
        capture_output=True, text=True, timeout=120)
    rec = json.loads(proc.stdout.splitlines()[-1])
    assert (proc.returncode == 0) == (name == "green") == rec["ok"]
    assert rec["check"] == "serve_chaos"
    assert bool(rec["failures"]) == (name != "green")


def test_traces_and_spec_equal_the_reference(tools):
    jax_tool, port_tool = tools
    assert port_tool._shared_prefixes() == jax_tool._shared_prefixes()
    prefixes = port_tool._shared_prefixes()
    for seed, n, base in ((2, 14, 0), (3, 14, 14), (9, 5, 3)):
        assert (port_tool._make_requests(prefixes, seed, n, base)
                == jax_tool._make_requests(prefixes, seed, n, base))
    for fault, restarts in (("worker_crash:18", None),
                            ("worker_hang:18", 0)):
        # The one addition: the port's workers read the pool through the
        # hand-written paged decode kernel.
        want = jax_tool._spec(fault, max_restarts=restarts)
        want["serving"]["attn_kernel"] = "pallas"
        assert port_tool._spec(fault, max_restarts=restarts) == want
    plan = port_tool.Plan()
    assert (plan.wave_a, plan.wave_b, plan.fault_step, plan.timeout_s,
            plan.recovery_s, plan.dwell_s) == (
        jax_tool._WAVE_A, jax_tool._WAVE_B, jax_tool._FAULT_STEP,
        jax_tool._TIMEOUT_S, jax_tool._RECOVERY_S, jax_tool._DWELL_S)
    assert port_tool.KINDS == jax_tool._KINDS
    # The longest prompt fits the largest prompt bucket.
    spec = port_tool._spec("")
    longest = port_tool._PREFIX_LEN + port_tool._SUFFIX_LEN[1] - 1
    assert longest <= max(spec["serving"]["prompt_buckets"])


def test_worker_dwell_and_constrained_pool(tools):
    """A worker process with ``--constrain-pool 4 --dwell-s 0.25``: its
    pool holds what ``constrain_pool(4)`` leaves, and its steps take at
    least the dwell each."""
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.cli import read_worker_ready
    from distributeddeeplearning_tpu_torch.config import ServingConfig
    from distributeddeeplearning_tpu_torch.serving import (
        Request,
        ServingEngine,
        connect_fleet,
    )

    _, port_tool = tools
    spec = port_tool._spec("")
    spec["serving"].pop("fault_injection")
    scfg = ServingConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in spec["serving"].items()})
    engine = ServingEngine(models.get_model("gpt2", **spec["model"][
        "kwargs"]), scfg, device="cpu")
    engine.constrain_pool(4)
    pool = engine.stats()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributeddeeplearning_tpu_torch.serving.worker", "--spec-json",
         json.dumps(spec), "--device", "cpu", "--constrain-pool", "4",
         "--dwell-s", "0.25"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        ready = read_worker_ready(proc.stdout)
        router = connect_fleet(scfg, [(ready["host"], ready["port"])])
        router.submit(Request(prompt=list(range(1, 20)), max_new_tokens=4,
                              request_id=0))
        t0 = time.monotonic()
        while not router.idle and time.monotonic() - t0 < 60:
            router.step()
            time.sleep(0.005)
        wall = time.monotonic() - t0
        (done,) = router.finished()
        router.shutdown_fleet()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert len(done.generated) == 4
    stats = router.replicas[0].goodbye["stats"]

    def blocks(st):  # free, held, and cached for the prefix cache
        return (st["free_blocks"] + st["used_blocks"]
                + st["prefix_cache"]["cached_blocks"])

    assert stats["prefix_cache"]["cached_blocks"] > 0
    assert blocks(stats) == blocks(pool) < stats["num_blocks"]
    # Every step but the last dwells before the result goes out.
    assert stats["steps"] >= 3 and wall >= 0.25 * (stats["steps"] - 1)


def test_spill_store_killed_mid_write_keeps_the_last_file(tmp_path,
                                                         monkeypatch):
    """The periodic spill checkpoint is renamed into place: a worker
    killed while writing (the supervisor SIGKILLs a stalled one) leaves
    the previous file whole, so its restart re-warms from it."""
    from distributeddeeplearning_tpu_torch.serving import scheduler

    pool = scheduler.KVBlockPool(9, 16, prefix_cache=True, spill_blocks=4)
    path = str(tmp_path / "spill.pkl")
    pool.save_host_store(path, {}, meta={"v": 1})
    before = open(path, "rb").read()

    def killed(blob, f):
        f.write(b"\x80\x04 half a pickle")
        raise KeyboardInterrupt  # the process dies here

    monkeypatch.setattr(scheduler.pickle, "dump", killed)
    with pytest.raises(KeyboardInterrupt):
        pool.save_host_store(path, {}, meta={"v": 2})
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert pool.load_host_store(path, expect_meta={"v": 1}) == {}


@pytest.mark.chaos
def test_live_chaos_one_crash(tools, tmp_path, monkeypatch):
    """Real worker processes, one injected crash (JAX's workload, one kind,
    no exhaustion run): exactly once, token parity with the oracle, the
    restart re-warmed, the workers' launch reports consistent."""
    _, port_tool = tools
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers'
    plan = port_tool.Plan(kinds=("worker_crash",), exhaustion=False,
                          device="cpu")
    status = port_tool.run_matrix(plan, log=lambda m: None)
    (run,) = status["runs"]
    assert status["ok"] is True, (status["check_failures"], run["checks"])
    assert run["run"] == "worker_crash"
    assert run["served"] + run["shed"] + run["dropped"] == run["submitted"]
    assert run["duplicate_deliveries"] == 0 and run["token_parity"] is True
    assert any(r["spill_rewarm_chains"] > 0 for r in run["restart_records"])
    # On the CPU the kernel route runs the plain version: no launch.
    assert run["worker_launches"] and all(
        r["launches"] == {"paged_decode": 0, "paged_decode_q8": 0}
        for r in run["worker_launches"])
    assert port_tool.check_status(status) == []
