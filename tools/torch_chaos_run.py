#!/usr/bin/env python
"""Chaos harness of the PyTorch port: run supervised training under injected
faults and report whether each run survived unattended.

For each fault spec (default: the matrix ``nan:5 hang:7 corrupt:6``) this
launches ``python -m distributeddeeplearning_tpu_torch.cli supervise`` in a
fresh checkpoint directory, reads the one ordered stream of JSON records
the child and the supervisor share on stdout (each stamped with the
seconds since the launch as it arrives), and writes the status file:

    {"runs": [{"fault": "corrupt:6", "ok": true, "final_step": 8,
               "restarts": 1, "rollbacks": 0, "exit_code": 0, ...}, ...],
     "ok": true}

A run is ok when the supervised process exited 0 and training reached
``--steps``. Each run also carries ``wall_s``, its ``timeline`` (every
JSON record with its arrival second), its other stdout lines (``text``,
stamped the same way) and the tail of its stderr. Usage (on the GPU, or with
``--device cpu``):

    python tools/torch_chaos_run.py --out /tmp/chaos_status.json
    python tools/torch_chaos_run.py --device cpu --fault corrupt:6 \\
        --override model.kwargs.width=8 --out /tmp/chaos.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_FAULTS = ["nan:5", "hang:7", "corrupt:6"]


def build_cmd(args, fault: str, workdir: str) -> list[str]:
    cmd = [
        sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
        "supervise", "--config", args.config,
        "--override", f"train.steps={args.steps}",
        "--override", "train.log_every=1",
        "--override", f"train.save_every={args.save_every}",
        "--override", f"train.checkpoint_dir={workdir}/ckpt",
        "--override", f"train.fault_injection={fault}",
        "--override", "health.enabled=True",
        "--override", f"supervisor.max_restarts={args.max_restarts}",
        "--override", "supervisor.backoff_base_s=0.2",
        "--override", "supervisor.poll_interval_s=0.2",
        "--override", f"supervisor.hang_timeout_s={args.hang_timeout}",
    ]
    for o in args.override:
        cmd += ["--override", o]
    if args.device is not None:
        cmd += ["--device", args.device]
    return cmd


def run_one(args, fault: str, workdir: str, on_record=None, extra=(),
            prefix=()) -> dict:
    """One supervised run with ``fault`` armed in ``workdir`` (an empty
    ``fault`` arms none), with ``extra`` arguments added to its command
    line and ``prefix`` before it (say ``nice -n 10``). ``on_record(proc,
    rec)`` sees every JSON record as it arrives (a caller may signal the
    supervisor from it)."""
    cmd = list(prefix) + build_cmd(args, fault, workdir) + list(extra)
    print(f"[chaos] {fault}: {' '.join(cmd)}", flush=True)
    t0 = time.monotonic()
    # A session of its own: a timeout kills the supervisor and its child.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ), start_new_session=True)
    timeline, text, err = [], [], []
    drain = threading.Thread(target=lambda: err.extend(proc.stderr),
                             daemon=True)
    drain.start()

    def read():
        for line in proc.stdout:
            t = round(time.monotonic() - t0, 3)
            try:
                rec = json.loads(line) if line.startswith("{") else None
            except ValueError:
                rec = None
            if not isinstance(rec, dict):
                text.append([t, line.rstrip("\n")])
                continue
            timeline.append([t, rec])
            if on_record is not None:
                on_record(proc, rec)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        exit_code = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        exit_code, err = -1, err + ["TIMEOUT"]
    reader.join(timeout=10)
    drain.join(timeout=10)
    stderr = "".join(err)

    final_step = 0
    restarts = rollbacks = 0
    events = []
    for _, rec in timeline:
        if "event" in rec:
            events.append(rec["event"])
            if rec["event"] == "supervisor_done":
                restarts = rec.get("restarts", 0)
            elif rec["event"] == "rollback_restart":
                rollbacks += 1
        elif "loss" in rec:
            final_step = max(final_step, int(rec.get("step", 0)))

    ok = exit_code == 0 and final_step >= args.steps
    result = {
        "fault": fault,
        "ok": ok,
        "exit_code": exit_code,
        "final_step": final_step,
        "restarts": restarts,
        "rollbacks": rollbacks,
        "events": sorted(set(events)),
        "wall_s": round(time.monotonic() - t0, 3),
        "timeline": timeline,
        "text": text,
        "stderr_tail": stderr[-2000:],
    }
    print(f"[chaos] {fault}: ok={ok} final_step={final_step} "
          f"restarts={restarts} rollbacks={rollbacks}", flush=True)
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=os.path.join(
        REPO, "distributeddeeplearning_tpu_torch", "configs",
        "resnet18_cifar10.py"))
    p.add_argument("--fault", action="append", default=[],
                   help=f"repeatable fault spec (default: {DEFAULT_FAULTS})")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--save-every", type=int, default=2)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--hang-timeout", type=float, default=120.0,
                   help="must exceed the longest gap between two heartbeats "
                   "of a healthy attempt (its start and first step)")
    p.add_argument("--timeout", type=float, default=540.0,
                   help="wall limit per supervised run")
    p.add_argument("--device", default=None,
                   help="the children's --device (default: cuda)")
    p.add_argument("--override", action="append", default=[],
                   metavar="a.b=v", help="extra config overrides, e.g. the "
                   "small-model kwargs for a CPU run")
    p.add_argument("--out", required=True,
                   help="the status file to write")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    faults = args.fault or list(DEFAULT_FAULTS)
    status: dict = {"config": args.config, "steps": args.steps, "runs": []}
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
        for i, fault in enumerate(faults):
            workdir = os.path.join(tmp, f"run{i}")
            os.makedirs(workdir)
            status["runs"].append(run_one(args, fault, workdir))
    status["ok"] = all(r["ok"] for r in status["runs"])
    with open(args.out, "w") as f:
        json.dump(status, f, indent=2)
        f.write("\n")
    print(f"[chaos] wrote {args.out}: ok={status['ok']}")
    return 0 if status["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
