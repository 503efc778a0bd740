#!/usr/bin/env python
"""Serving chaos harness of the PyTorch port: kill, wedge and mute real
fleet workers (``distributeddeeplearning_tpu_torch.serving.worker``
processes) under load, and hold the self-healing fleet
(``serving/fleet_supervisor.py``) to its promises.

One run per fault class (``serving.fault_injection``, armed on worker 0
through ``$DDL_SERVE_FAULT_WORKER``):

- ``worker_crash:K``: ``os._exit(EXIT_FAULT)`` at engine step K, no drain,
  no goodbye. Detected by the child's exit; the restarted worker re-warms
  from the last periodic spill checkpoint
  (``serving.spill_checkpoint_every_s``).
- ``worker_hang:K``: the loop freezes with the process alive. Detected by
  the router's stale-heartbeat sweep; the supervisor SIGKILLs and
  restarts it.
- ``conn_drop:K``: the worker severs the router socket. Detected as EOF on
  the parent's pump; the orphaned worker drains and exits on its own.
- ``heartbeat_stall:K``: the worker keeps serving but goes silent. The
  router quarantines it and retries its work on the survivor under a
  bumped attempt epoch, so a late result of the stalled attempt is
  discarded, never delivered twice.

Every run drives the same two-wave shared-prefix workload over a fleet of
2 workers (the prefix cache and the spill tier on, the device pool cut
below the prefixes' working set so the spill tier is hot), waits for the
supervisor to detect and restart, then submits wave B so the restarted
worker serves load from its re-warmed cache. Pins per run:

- exactly once: ``served + shed + dropped == submitted`` and
  ``duplicate_deliveries == 0``;
- every served request's greedy tokens equal to an undisturbed oracle's
  (``serving.worker --oracle``, the same spec and seed; computed once per
  matrix, since every run submits the same requests);
- the restarted worker re-warmed: ``spill_rewarm_chains > 0`` in its
  ``worker_ready`` line, and host-tier prefix hits in its goodbye stats;
- recovery (death to replacement serving) within ``recovery_s``;
- every worker process that exits cleanly reports its paged kernel
  launches equal to its decode calls x layers (``worker_launches``), when
  the kernel read path runs on the GPU (none otherwise).

A final ``exhaustion`` run sets ``max_worker_restarts=0``: the crashed
worker is given up (``worker_give_up``) and the fleet degrades to the
survivor, under the same accounting and parity pins.

Usage:

    python tools/torch_serve_chaos.py --size 124m --hbm-budget-mb 64 \\
        --out /tmp/serve_chaos.json
    python tools/torch_serve_chaos.py --device cpu --out /tmp/sc.json
    python tools/torch_serve_chaos.py --validate --out /tmp/sc.json

The workers run on ``--device`` (default: the GPU) and read the pool
through the hand-written paged decode kernel (``attn_kernel='pallas'``;
on the CPU its plain version). Shrink knobs, as the reference's:
``$DDL_CHAOS_KINDS`` (comma list, default all four), ``$DDL_CHAOS_WAVE_A`` /
``$DDL_CHAOS_WAVE_B`` (requests a wave), ``$DDL_CHAOS_FAULT_STEP``,
``$DDL_CHAOS_TIMEOUT`` (wall seconds a run), ``$DDL_CHAOS_RECOVERY_S``,
``$DDL_CHAOS_SKIP_EXHAUSTION=1``, ``$DDL_CHAOS_SEED``, ``$DDL_CHAOS_DWELL``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

KINDS = ("worker_crash", "worker_hang", "conn_drop", "heartbeat_stall")
_FLEET = 2
_FAULT_TARGET = 0
_SEED = 0

# The workload: a shared-prefix trace (7 system prompts x short suffixes),
# the prefix cache and the spill tier on, the device pool cut well below
# the prefixes' working set (7 prefixes x 2 blocks = 14 against 9), so
# publishing one finished prefix evicts another and the periodic spill
# checkpoint holds root-connected chains to re-warm from. The prefix count
# is odd: dispatch is round robin over 2 workers, so each worker sees a
# stride-2 sample of the cycle, which covers every prefix, and wave B
# revisits whichever chains the restarted worker re-warmed. Every prompt
# (at most 32 + 8 tokens) fits the largest prompt bucket.
_MODEL_KW = dict(size="tiny", vocab_size=256, max_len=160)
_PREFIXES = 7
_PREFIX_LEN = 32           # 2 whole blocks: cacheable
_SUFFIX_LEN = (2, 9)
_MAX_NEW = (8, 13)
_CONSTRAIN_BLOCKS = 9
_SERVING_KW = dict(
    slots=4, block_size=16, hbm_budget_mb=8, max_seq_len=96,
    prompt_buckets=[16, 32, 64], prefix_cache=True, suffix_buckets=[8],
    spill_blocks=24, router_policy="round_robin",
    # 5 s, not 1 s: a restarted worker's first steps can be slow, and the
    # single-threaded worker cannot heartbeat mid-step.
    heartbeat_interval_s=0.05, heartbeat_timeout_s=5.0,
    max_worker_restarts=2, restart_backoff_base_s=0.2,
    restart_backoff_max_s=1.0, spill_checkpoint_every_s=0.05,
    request_retry=True, attn_kernel="pallas",
)


@dataclasses.dataclass
class Plan:
    """The knobs of one matrix."""

    kinds: tuple = KINDS
    wave_a: int = 14
    wave_b: int = 14
    # Late enough that the target worker has cycled its lanes (spilled,
    # checkpointed root-connected chains), early enough that wave A work
    # is still in flight for the retry path.
    fault_step: int = 18
    timeout_s: float = 300.0
    recovery_s: float = 120.0
    exhaustion: bool = True
    seed: int = _SEED
    # A short sleep after each engine step, so the fault fires while wave
    # A still has queued and in-flight work on the target.
    dwell_s: float = 0.01
    device: str | None = None
    model_kw: dict | None = None     # replaces _MODEL_KW
    serving: dict | None = None      # updates _SERVING_KW
    # The workers' and the oracle's niceness (0: this process's): beside
    # other load, the router keeps its priority, so its staleness sweep
    # never reads its own starvation as a pause to credit back.
    nice: int = 0


def _shared_prefixes(seed: int = _SEED):
    """The system prompts both waves ride."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        [int(t) for t in rng.integers(1, 256, _PREFIX_LEN)]
        for _ in range(_PREFIXES)
    ]


def _make_requests(prefixes, seed: int, n: int, id_base: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        slen = int(rng.integers(*_SUFFIX_LEN))
        suffix = [int(t) for t in rng.integers(1, 256, slen)]
        reqs.append({
            "request_id": id_base + i,
            "prompt": prefixes[i % _PREFIXES] + suffix,
            "max_new_tokens": int(rng.integers(*_MAX_NEW)),
        })
    return reqs


def _spec(fault: str, *, max_restarts: int | None = None,
          model_kw: dict | None = None, serving: dict | None = None) -> dict:
    kw = dict(_SERVING_KW)
    kw.update(serving or {})
    kw["fault_injection"] = fault
    if max_restarts is not None:
        kw["max_worker_restarts"] = max_restarts
    return {
        "model": {"name": "gpt2",
                  "kwargs": dict(model_kw if model_kw else _MODEL_KW)},
        "serving": kw,
    }


def _waves(plan: Plan):
    prefixes = _shared_prefixes(plan.seed)
    return (_make_requests(prefixes, plan.seed + 2, plan.wave_a, 0),
            _make_requests(prefixes, plan.seed + 3, plan.wave_b,
                           plan.wave_a))


def _worker_cmd(plan: Plan, *args) -> list[str]:
    cmd = (["nice", "-n", str(plan.nice)] if plan.nice else []) + [
        sys.executable, "-m",
        "distributeddeeplearning_tpu_torch.serving.worker", *args,
        "--seed", str(plan.seed)]
    if plan.device is not None:
        cmd += ["--device", plan.device]
    return cmd


def oracle_tokens(plan: Plan, requests) -> dict:
    """The parity reference: the same requests on one undisturbed engine
    in a worker process of the same environment, the fault keys
    stripped."""
    spec = _spec("", model_kw=plan.model_kw, serving=plan.serving)
    spec["serving"].pop("fault_injection")
    out = subprocess.run(
        _worker_cmd(plan, "--oracle", "--spec-json", json.dumps(spec)),
        input=json.dumps({"requests": requests}), capture_output=True,
        text=True, check=True, cwd=_REPO,
    )
    for line in out.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("event") == "oracle_result":
            return {int(k): v for k, v in rec["results"].items()}
    raise RuntimeError("oracle printed no oracle_result")


def _launch_checks(reports, serving: dict) -> bool:
    """Every report's paged launches equal its decode calls x layers on
    the GPU, and none on the CPU (the wrapper's plain version)."""
    if not reports:
        return False
    kernel = ("paged_decode_q8" if serving.get("kv_quant") == "int8"
              else "paged_decode")
    for r in reports:
        want = {"paged_decode": 0, "paged_decode_q8": 0}
        if r["device"].startswith("cuda"):
            want[kernel] = r["calls"]["decode"] * r["layers"]
        if r["launches"] != want:
            return False
    return sum(r["calls"]["decode"] for r in reports) > 0


def _run_one(plan: Plan, kind: str, oracle: dict, *,
             max_restarts: int | None = None,
             label: str | None = None) -> dict:
    from distributeddeeplearning_tpu_torch.cli import read_worker_ready
    from distributeddeeplearning_tpu_torch.config import ServingConfig
    from distributeddeeplearning_tpu_torch.serving import (
        FleetSupervisor,
        Request,
        connect_fleet,
    )
    from distributeddeeplearning_tpu_torch.serving.worker import (
        ATTEMPT_ENV,
        FAULT_WORKER_ENV,
    )

    label = label or kind
    fault = f"{kind}:{plan.fault_step}"
    spec = _spec(fault, max_restarts=max_restarts, model_kw=plan.model_kw,
                 serving=plan.serving)
    scfg = ServingConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in spec["serving"].items()
    })
    spill_dir = tempfile.mkdtemp(prefix=f"serve_chaos_{kind}_")
    wave_a, wave_b = _waves(plan)
    submitted = wave_a + wave_b

    procs = [None] * _FLEET
    spawn_log, reports, readers = [], [], []

    def read_rest(p):
        for line in p.stdout:
            if '"worker_launches"' in line:
                try:
                    reports.append(json.loads(line))
                except ValueError:
                    pass

    def _spawn(index, attempt):
        cmd = _worker_cmd(
            plan, "--spec-json", json.dumps(spec),
            "--replica-index", str(index),
            "--spill-store", os.path.join(spill_dir, f"spill_w{index}.json"),
            "--constrain-pool", str(_CONSTRAIN_BLOCKS),
            "--dwell-s", str(plan.dwell_s))
        env = dict(os.environ)
        env["DDL_PROCESS_INDEX"] = str(index)
        env[ATTEMPT_ENV] = str(attempt)
        env[FAULT_WORKER_ENV] = str(_FAULT_TARGET)
        with open(os.path.join(spill_dir, f"stderr_w{index}_a{attempt}"),
                  "w") as err:
            p = subprocess.Popen(cmd, env=env, cwd=_REPO,
                                 stdout=subprocess.PIPE, stderr=err,
                                 text=True)
        procs[index] = p
        ready = read_worker_ready(p.stdout)
        t = threading.Thread(target=read_rest, args=(p,), daemon=True)
        t.start()
        readers.append((p, t))
        spawn_log.append({
            "replica": index, "attempt": attempt,
            "spill_rewarm_chains": int(ready.get("spill_rewarm_chains", 0)),
        })
        return p, ready

    t_boot = time.monotonic()
    endpoints = []
    for i in range(_FLEET):
        _, ready = _spawn(i, 0)
        endpoints.append((ready["host"], ready["port"]))
    boot_s = time.monotonic() - t_boot
    router = connect_fleet(scfg, endpoints)
    sup = FleetSupervisor(router, list(procs), _spawn, scfg)
    # The budget covers serving, not the initial boot.
    t_run0 = time.monotonic()

    def _drive(until=None) -> bool:
        """Step the router and the supervisor until ``until()`` (or
        completion); False when the run's wall budget ran out."""
        deadline = t_run0 + plan.timeout_s
        grace_s = scfg.heartbeat_timeout_s + 3.0
        t_drained = None
        while time.monotonic() < deadline:
            busy = router.step()
            sup.tick()
            if until is not None and until():
                return True
            if not busy and not sup.pending_recovery and router.idle:
                if until is None:
                    return True
                # Drained with ``until`` still pending: a stalled
                # heartbeat is outed only by the stale sweep, so grant
                # that window before concluding it never fires.
                now = time.monotonic()
                if t_drained is None:
                    t_drained = now
                elif now - t_drained > grace_s:
                    return False
            else:
                t_drained = None
            if not busy:
                time.sleep(0.005)
        return False

    result: dict = {"run": label, "fault": fault, "fleet": _FLEET,
                    "fault_worker": _FAULT_TARGET}
    try:
        for d in wave_a:
            router.submit(Request(prompt=list(d["prompt"]),
                                  max_new_tokens=d["max_new_tokens"],
                                  request_id=d["request_id"]))
        if max_restarts == 0:
            healed = _drive(until=lambda: sup.handles[
                _FAULT_TARGET].gave_up)
        else:
            healed = _drive(until=lambda: sup.restarts >= 1)
        # Wave B lands after the recovery (or the give-up).
        for d in wave_b:
            router.submit(Request(prompt=list(d["prompt"]),
                                  max_new_tokens=d["max_new_tokens"],
                                  request_id=d["request_id"]))
        done = _drive()
        finished = router.finished()
        stats = router.stats()
        goodbye_stats = {}
        sup.shutdown()
        for r in router.replicas:
            gb = getattr(r, "goodbye", None) or {}
            goodbye_stats[r.index] = gb.get("stats") or {}
    finally:
        for p in procs:
            if p is None:
                continue
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for p, t in readers:
            if p.poll() is None:
                p.kill()
                p.wait()
            t.join(timeout=10)
        stderr_tails = {}
        for name in sorted(os.listdir(spill_dir)):
            if name.startswith("stderr_"):
                with open(os.path.join(spill_dir, name)) as f:
                    tail = f.read()[-2000:]
                if tail:
                    stderr_tails[name[len("stderr_"):]] = tail
        shutil.rmtree(spill_dir, ignore_errors=True)

    served_ids = sorted(int(s.request.request_id) for s in finished)
    parity = all(list(s.generated) == oracle[int(s.request.request_id)]
                 for s in finished)
    sup_stats = sup.stats()
    restarted = sup_stats["restart_records"]
    px = (goodbye_stats.get(_FAULT_TARGET) or {}).get("prefix_cache") or {}
    rewarm_hits = int(px.get("hit_tokens_host") or 0)
    rewarm_promotes = int(px.get("promotes") or 0)
    rewarm_chains = max((r["spill_rewarm_chains"] for r in restarted),
                        default=0)
    served = len(finished)
    shed = int(stats.get("shed", 0))
    dropped = int(stats.get("failed", 0))
    exhaustion = max_restarts == 0

    checks = {
        "healed_or_gave_up": bool(healed),
        "completed": bool(done),
        "accounting_exact": served + shed + dropped == len(submitted),
        "no_duplicates": int(stats.get("duplicate_deliveries", 0)) == 0,
        "token_parity": bool(parity),
        "launches_exact": _launch_checks(reports, spec["serving"]),
    }
    if exhaustion:
        checks["gave_up"] = sup_stats["gave_up"] == [_FAULT_TARGET]
        checks["survivor_served_all"] = (dropped == 0
                                         and served == len(submitted))
    else:
        checks["restarted"] = len(restarted) >= 1
        checks["nothing_dropped"] = dropped == 0
        checks["spill_rewarm"] = rewarm_chains > 0
        checks["rewarm_served_warm"] = rewarm_hits > 0 or rewarm_promotes > 0
        checks["recovery_bounded"] = all(r["recovery_s"] <= plan.recovery_s
                                         for r in restarted)
    result.update({
        "submitted": len(submitted),
        "served": served,
        "shed": shed,
        "dropped": dropped,
        "served_ids": served_ids,
        "retried": int(stats.get("retried", 0)),
        "rerouted": int(stats.get("rerouted", 0)),
        "duplicate_deliveries": int(stats.get("duplicate_deliveries", 0)),
        "stale_frames": int(stats.get("stale_frames", 0)),
        "stale_heartbeats": int(stats.get("stale_heartbeats", 0)),
        "token_parity": bool(parity),
        "restart_records": restarted,
        "supervisor": sup_stats,
        "spawns": spawn_log,
        "worker_launches": reports,
        "rewarm_hit_tokens_host": rewarm_hits,
        "rewarm_promotes": rewarm_promotes,
        # Both streams stamp the router's tick counter: what died, what
        # was retried where, and why a replica was quarantined.
        "events": sorted(list(router.events) + list(sup.events),
                         key=lambda e: e.get("step", 0)),
        "boot_s": round(boot_s, 3),
        "wall_s": round(time.monotonic() - t_run0, 3),
        "checks": checks,
        "ok": all(checks.values()),
    })
    if not result["ok"]:
        # What each worker attempt printed on stderr (a failed load, a
        # traceback), by w<replica>_a<attempt>.
        result["worker_stderr"] = stderr_tails
    return result


def check_status(status: dict) -> list[str]:
    """Validate a status record against the pinned claims (``--validate``
    and the post-run gate). Returns failure strings (empty = ok)."""
    fails = []
    runs = {r["run"]: r for r in status.get("runs", [])}
    for kind in status.get("kinds", []):
        r = runs.get(kind)
        if r is None:
            fails.append(f"{kind}: run missing")
            continue
        if not r.get("ok"):
            bad = [k for k, v in (r.get("checks") or {}).items() if not v]
            fails.append(f"{kind}: failed checks {bad}")
        if r.get("served", -1) + r.get("shed", -1) + r.get(
                "dropped", -1) != r.get("submitted", 0):
            fails.append(f"{kind}: accounting broken")
        if r.get("duplicate_deliveries", 1) != 0:
            fails.append(f"{kind}: duplicate deliveries")
        if not r.get("token_parity"):
            fails.append(f"{kind}: token parity broken")
        if kind != "exhaustion":
            if not any(rec.get("spill_rewarm_chains", 0) > 0
                       for rec in r.get("restart_records", [])):
                fails.append(f"{kind}: no spill re-warm")
    if status.get("exhaustion_run") and "exhaustion" not in runs:
        fails.append("exhaustion: run missing")
    if not status.get("ok"):
        fails.append("status.ok is false")
    return fails


def run_matrix(plan: Plan, log=print) -> dict:
    """Every kind of ``plan`` (then the exhaustion run), against one
    oracle; returns the status record, ``check_status`` applied."""
    wave_a, wave_b = _waves(plan)
    t0 = time.monotonic()
    oracle = oracle_tokens(plan, wave_a + wave_b)
    oracle_s = time.monotonic() - t0
    runs = []
    for kind in plan.kinds:
        log(f"[serve-chaos] running {kind} ...")
        runs.append(_run_one(plan, kind, oracle))
        log(json.dumps({k: runs[-1][k] for k in (
            "run", "ok", "served", "dropped", "retried", "wall_s",
            "checks")}))
    if plan.exhaustion:
        log("[serve-chaos] running exhaustion ...")
        runs.append(_run_one(plan, "worker_crash", oracle, max_restarts=0,
                             label="exhaustion"))
        log(json.dumps({k: runs[-1][k] for k in (
            "run", "ok", "served", "dropped", "wall_s", "checks")}))
    spec = _spec("", model_kw=plan.model_kw, serving=plan.serving)
    status = {
        "bench": "torch_serve_chaos",
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "fleet": _FLEET,
        "device": plan.device or "cuda",
        "model": spec["model"],
        "kinds": list(plan.kinds),
        "exhaustion_run": plan.exhaustion,
        "fault_step": plan.fault_step,
        "seed": plan.seed,
        "wave_a": plan.wave_a,
        "wave_b": plan.wave_b,
        "serving": {k: v for k, v in spec["serving"].items()
                    if k != "fault_injection"},
        "constrain_blocks": _CONSTRAIN_BLOCKS,
        "recovery_bound_s": plan.recovery_s,
        "oracle_s": round(oracle_s, 3),
        "runs": runs,
        "ok": all(r["ok"] for r in runs),
    }
    fails = check_status(status)
    status["check_failures"] = fails
    status["ok"] = status["ok"] and not fails
    return status


def plan_from_env(env=None, **kw) -> Plan:
    """A :class:`Plan` from the reference's ``$DDL_CHAOS_*`` knobs."""
    env = os.environ if env is None else env
    kinds = tuple(k for k in env.get("DDL_CHAOS_KINDS", ",".join(KINDS))
                  .split(",") if k.strip())
    return Plan(
        kinds=kinds,
        wave_a=int(env.get("DDL_CHAOS_WAVE_A", "14")),
        wave_b=int(env.get("DDL_CHAOS_WAVE_B", "14")),
        fault_step=int(env.get("DDL_CHAOS_FAULT_STEP", "18")),
        timeout_s=float(env.get("DDL_CHAOS_TIMEOUT", "300")),
        recovery_s=float(env.get("DDL_CHAOS_RECOVERY_S", "120")),
        exhaustion=env.get("DDL_CHAOS_SKIP_EXHAUSTION", "") != "1",
        seed=int(env.get("DDL_CHAOS_SEED", str(_SEED))),
        dwell_s=float(env.get("DDL_CHAOS_DWELL", "0.01")),
        **kw,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="the status file to write (or read under "
                   "--validate)")
    # The reference's tool calls this mode --check, which here names a
    # validator of a committed artifact that tools/check_artifacts.py
    # rosters; the port's status files are never committed.
    p.add_argument("--validate", action="store_true",
                   help="validate an existing status file; run nothing")
    p.add_argument("--device", default=None,
                   help="the workers' --device (default: cuda)")
    p.add_argument("--size", default=_MODEL_KW["size"],
                   help="the GPT-2 size (vocab 256, max_len 160)")
    p.add_argument("--nice", type=int, default=0,
                   help="run the workers and the oracle at this niceness "
                   "(the router keeps this process's)")
    p.add_argument("--hbm-budget-mb", type=int,
                   default=_SERVING_KW["hbm_budget_mb"],
                   help="serving.hbm_budget_mb: the allocated pool must "
                   f"hold the {_CONSTRAIN_BLOCKS} blocks the workers use")
    args = p.parse_args(argv)
    if args.validate:
        with open(args.out) as f:
            status = json.load(f)
        fails = check_status(status)
        for f_ in fails:
            print(f"[serve-chaos-check] FAIL: {f_}")
        print(json.dumps({"check": "serve_chaos", "out": args.out,
                          "ok": not fails, "failures": fails}))
        return 1 if fails else 0
    plan = plan_from_env(
        device=args.device, nice=args.nice,
        model_kw={**_MODEL_KW, "size": args.size},
        serving={"hbm_budget_mb": args.hbm_budget_mb})
    status = run_matrix(plan, log=lambda m: print(m, flush=True))
    with open(args.out, "w") as f:
        json.dump(status, f, indent=1)
        f.write("\n")
    print(json.dumps({"bench": "torch_serve_chaos", "out": args.out,
                      "ok": status["ok"],
                      "runs": {r["run"]: r["ok"] for r in status["runs"]}}))
    return 0 if status["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
