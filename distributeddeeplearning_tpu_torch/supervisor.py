"""Restart supervisor — unattended recovery for a training child
(``SupervisorConfig``), a copy of the JAX package's ``supervisor.py``.

The serving fleet (``serving/worker.py``, ``serving/fleet_supervisor.py``)
uses its exit-code contract (``EXIT_FAULT``, ``EXIT_PREEMPTED``,
``classify_exit``) and its backoff; ``cli supervise``, which runs
:class:`Supervisor` around ``cli train``, is not wired into the port's CLI
yet (ROADMAP A14).

Production pod training treats preemption, hangs and crashes as routine; the
run must absorb them without a human relaunching it. The supervisor wraps the
``train`` subcommand as a child process and:

- **classifies exits**: clean (0) / preempted (``EXIT_PREEMPTED``: the child
  already force-saved) / injected fault (``EXIT_FAULT``) / crash (anything
  else) / hang (killed by the monitor below);
- **restarts with exponential backoff + jitter** under a bounded
  ``max_restarts`` — resume is the child's ordinary checkpoint-resume path,
  which is exactly why restart-based recovery is sound here;
- **detects hangs** via a heartbeat file the child's step loop touches at
  log boundaries (``train.fit``): no touch for ``hang_timeout_s`` → SIGKILL
  and restart;
- **converts SIGTERM/SIGINT preemption** into a graceful shutdown: the
  signal is forwarded to the child, whose step loop performs a final
  synchronous ``CheckpointManager.save(force=True)+wait()`` before exiting
  ``EXIT_PREEMPTED`` — resume loses zero durable steps.

Each attempt exports ``DDL_SUPERVISOR_ATTEMPT`` (0, 1, ...) to the child;
``cli.cmd_train`` disarms ``train.fault_injection`` on attempts > 0 so every
injected fault is a one-shot, deterministically-recoverable event.

Time, sleep, process spawning and jitter are injectable so the backoff /
hang / preemption state machine unit-tests with a fake clock
(``tests/test_supervisor.py``) — no subprocesses, no wall time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from .config import SupervisorConfig

# Exit-code contract between fit/cmd_train and the supervisor.
EXIT_FAULT = 17  # injected crash (train.fit fault_injection: step/corrupt)
EXIT_PREEMPTED = 21  # SIGTERM/SIGINT: final save completed, do not restart

# Exit classifications.
CLEAN = "clean"
PREEMPTED = "preempted"
FAULT = "fault"
CRASH = "crash"
HANG = "hang"

ATTEMPT_ENV = "DDL_SUPERVISOR_ATTEMPT"
HEARTBEAT_ENV = "DDL_HEARTBEAT_FILE"


def classify_exit(returncode: int) -> str:
    """Map a child's exit code to an exit kind (hang is assigned by the
    monitor, not by code — a SIGKILLed hung child reports -9 like any
    crash)."""
    if returncode == 0:
        return CLEAN
    if returncode == EXIT_PREEMPTED:
        return PREEMPTED
    if returncode == EXIT_FAULT:
        return FAULT
    return CRASH


@dataclasses.dataclass
class AttemptRecord:
    index: int
    kind: str
    returncode: int
    backoff_s: float = 0.0  # delay applied AFTER this attempt (0 = none)


@dataclasses.dataclass
class SupervisorResult:
    exit_code: int  # what the supervise process should exit with
    restarts: int  # restarts performed (attempts - 1)
    attempts: list[AttemptRecord]

    @property
    def final_kind(self) -> str:
        return self.attempts[-1].kind if self.attempts else CLEAN


def touch(path: str | None, *, step: int | None = None,
          attempt: int | None = None, phase: str | None = None) -> None:
    """Create-or-touch a heartbeat file; never raises (a full disk must not
    take the training run down with it).

    With any of ``step``/``attempt``/``phase`` the heartbeat CARRIES
    content — ``{"step": N, "attempt": K, "phase": "..."}`` written
    atomically (tmp + replace, so the monitor never reads a torn line) —
    and the mtime still advances, so the hang detector's change-detection
    contract is unchanged. Bare ``touch(path)`` keeps the legacy
    mtime-only behavior (:func:`read_heartbeat` returns None for it)."""
    if not path:
        return
    try:
        if step is None and attempt is None and phase is None:
            with open(path, "a"):
                os.utime(path, None)
            return
        rec: dict = {}
        if step is not None:
            rec["step"] = int(step)
        if attempt is not None:
            rec["attempt"] = int(attempt)
        if phase is not None:
            rec["phase"] = str(phase)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except OSError:
        pass


def read_heartbeat(path: str | None) -> dict | None:
    """The heartbeat's content, when the child wrote one (``touch`` with
    fields): hang detection can then report WHERE the child hung — the
    last step/attempt/phase it reached — instead of just that it did.
    None for missing/empty/legacy-mtime-only heartbeats; never raises."""
    if not path:
        return None
    try:
        with open(path) as f:
            text = f.read().strip()
        if not text:
            return None
        rec = json.loads(text)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


class Supervisor:
    """Run ``cmd`` under restart-with-backoff supervision.

    ``popen`` / ``clock`` / ``sleep`` / ``jitter_rng`` are injection points
    for tests; production uses subprocess/monotonic/time.sleep and a seeded
    RNG (jitter should differ across workers — seed from the PID).
    """

    def __init__(
        self,
        cmd: list[str],
        cfg: SupervisorConfig,
        *,
        env: dict | None = None,
        cwd: str | None = None,
        popen=subprocess.Popen,
        clock=time.monotonic,
        sleep=time.sleep,
        jitter_rng: random.Random | None = None,
        log_fn=None,
        mtime=os.path.getmtime,
        crash_clear_paths: tuple[str, ...] = (),
        goodput_path: str | None = None,
        flight_dir: str | None = None,
    ):
        self._cmd = list(cmd)
        self._cfg = cfg
        self._env = dict(env if env is not None else os.environ)
        self._cwd = cwd
        self._popen = popen
        self._clock = clock
        self._sleep = sleep
        self._rng = jitter_rng if jitter_rng is not None else random.Random(
            os.getpid()
        )
        self._log = log_fn or (lambda rec: print(json.dumps(rec), flush=True))
        self._mtime = mtime
        self._crash_clear_paths = tuple(p for p in crash_clear_paths if p)
        # Telemetry (telemetry.py; docs/OBSERVABILITY.md), both optional:
        # goodput_path = the shared goodput.jsonl sidecar (the supervisor
        # appends backoff records and emits the exit summary); flight_dir
        # = where hang/crash kills dump a supervisor-side flight record
        # (the SIGKILLed child cannot write its own).
        self._goodput_path = goodput_path
        self._flight_dir = flight_dir
        self._heartbeat = cfg.heartbeat_file or os.path.join(
            tempfile.gettempdir(), f"ddl_heartbeat_{os.getpid()}"
        )
        self._terminate = False
        self._child = None

    # -- pieces (unit-testable in isolation) --------------------------------

    def backoff_s(self, restart_index: int) -> float:
        """Exponential backoff for the ``restart_index``-th restart (0-based)
        with multiplicative uniform jitter, capped at ``backoff_max_s``."""
        cfg = self._cfg
        base = min(
            cfg.backoff_base_s * cfg.backoff_factor**restart_index,
            cfg.backoff_max_s,
        )
        return base * (1.0 + cfg.backoff_jitter * self._rng.random())

    def request_shutdown(self) -> None:
        """Preemption entry point (the SIGTERM/SIGINT handler): forward to
        the child and stop restarting."""
        self._terminate = True
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)
            except (ProcessLookupError, OSError):
                pass

    # -- run loop -----------------------------------------------------------

    def _heartbeat_stale(self, last_change: list) -> bool:
        """Hang check: ``last_change`` is [mtime, clock_at_change]; a new
        mtime resets the clock. Uses the injected clock for the AGE (so fake
        clocks drive it) and mtime only as a change detector."""
        if not self._cfg.hang_timeout_s:
            return False
        try:
            m = self._mtime(self._heartbeat)
        except OSError:
            m = last_change[0]
        if m != last_change[0]:
            last_change[0], last_change[1] = m, self._clock()
            return False
        return self._clock() - last_change[1] > self._cfg.hang_timeout_s

    def _watch_child(self, child) -> tuple[str, int]:
        """Poll until exit / hang-kill / preemption-grace expiry."""
        cfg = self._cfg
        last_change = [0.0, self._clock()]
        try:
            last_change[0] = self._mtime(self._heartbeat)
        except OSError:
            pass
        term_deadline = None
        while True:
            rc = child.poll()
            if rc is not None:
                return classify_exit(rc), rc
            if self._terminate:
                if term_deadline is None:
                    term_deadline = self._clock() + cfg.preempt_grace_s
                elif self._clock() > term_deadline:
                    child.kill()
                    rc = child.wait()
                    return CRASH, rc
            elif self._heartbeat_stale(last_change):
                # Where did it hang? The content-bearing heartbeat (touch
                # with fields) says which step/phase last reported in.
                hb = read_heartbeat(self._heartbeat) or {}
                self._log(
                    {
                        "event": "supervisor_hang_kill",
                        "hang_timeout_s": cfg.hang_timeout_s,
                        "phase": hb.get("phase"),
                        "hb_step": hb.get("step"),
                    }
                )
                child.kill()
                rc = child.wait()
                return HANG, rc
            self._sleep(cfg.poll_interval_s)

    def run(self) -> SupervisorResult:
        cfg = self._cfg
        attempts: list[AttemptRecord] = []
        restarts = 0
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda *_: self.request_shutdown()
                )
            except ValueError:
                pass  # not the main thread (tests)
        try:
            while True:
                touch(self._heartbeat)  # baseline: spawn time counts
                env = dict(self._env)
                env[ATTEMPT_ENV] = str(restarts)
                env[HEARTBEAT_ENV] = self._heartbeat
                self._log(
                    {
                        "event": "supervisor_spawn",
                        "attempt": restarts,
                        "cmd": self._cmd,
                    }
                )
                self._child = self._popen(self._cmd, env=env, cwd=self._cwd)
                if self._terminate:
                    # Preemption raced the spawn: forward immediately.
                    self.request_shutdown()
                kind, rc = self._watch_child(self._child)
                rec = AttemptRecord(index=restarts, kind=kind, returncode=rc)
                attempts.append(rec)
                self._log(
                    {
                        "event": "supervisor_exit",
                        "attempt": restarts,
                        "kind": kind,
                        "returncode": rc,
                    }
                )
                if kind in (CLEAN, PREEMPTED) or self._terminate:
                    return self._done(rc if kind != CLEAN else 0, attempts)
                if restarts >= cfg.max_restarts:
                    self._log(
                        {
                            "event": "supervisor_give_up",
                            "restarts": restarts,
                            "max_restarts": cfg.max_restarts,
                        }
                    )
                    return self._done(rc if rc else 1, attempts)
                hb = read_heartbeat(self._heartbeat) or {}
                if kind in (CRASH, HANG):
                    self._clear_suspect_state(kind)
                    if self._flight_dir:
                        # The killed/crashed child may not have written its
                        # own flight record — preserve what the supervisor
                        # knows (last heartbeat = last reported location).
                        # Fleet-stamped like every other artifact so N
                        # supervisors can share one dir.
                        from .telemetry import (
                            dump_flight,
                            resolve_process_index,
                        )

                        pidx = resolve_process_index()
                        dump_flight(
                            os.path.join(
                                self._flight_dir,
                                f"flight_supervisor_{kind}_p{pidx}_attempt"
                                f"{restarts}.json",
                            ),
                            reason=f"supervisor_{kind}",
                            attempt=restarts,
                            process_index=pidx,
                            returncode=rc,
                            heartbeat=hb or None,
                            phase=hb.get("phase"),
                        )
                delay = self.backoff_s(restarts)
                rec.backoff_s = delay
                self._log(
                    {
                        "event": "supervisor_restart",
                        "attempt": restarts + 1,
                        "after": kind,
                        "backoff_s": round(delay, 3),
                        "phase": hb.get("phase"),
                    }
                )
                if self._goodput_path:
                    # Backoff is pure non-goodput wall time the child never
                    # sees; ledger it from the side that spends it.
                    from .telemetry import record_backoff

                    record_backoff(self._goodput_path, restarts + 1, delay)
                self._sleep(delay)
                restarts += 1
        finally:
            self._child = None
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _clear_suspect_state(self, kind: str) -> None:
        """Cache hygiene before an abnormal-exit restart: a child that
        CRASHed or HANGed may have truncated a persistent-compile-cache
        entry mid-write — or be dying ON a cached program (a deserialized
        program can crash where a fresh build would not; the
        ``corrupt:K`` chaos test catches exactly this). Deleting the cache
        makes the next attempt compile cold: strictly slower, strictly more
        likely to make progress. Clean/preempted/fault exits keep it warm."""
        for path in self._crash_clear_paths:
            if not os.path.isdir(path):
                continue
            shutil.rmtree(path, ignore_errors=True)
            self._log(
                {
                    "event": "supervisor_cache_clear",
                    "after": kind,
                    "path": path,
                }
            )

    def _done(self, exit_code: int, attempts) -> SupervisorResult:
        result = SupervisorResult(
            exit_code=exit_code,
            restarts=max(len(attempts) - 1, 0),
            attempts=attempts,
        )
        if self._goodput_path:
            # The exit goodput summary: every child attempt's ledger
            # records + this supervisor's backoff records folded into one
            # goodput_fraction (docs/OBSERVABILITY.md).
            try:
                from .telemetry import summarize_goodput

                summary = summarize_goodput(self._goodput_path)
            except Exception:
                summary = None
            if summary is not None:
                self._log({"event": "goodput_summary", **summary})
        self._log(
            {
                "event": "supervisor_done",
                "exit_code": result.exit_code,
                "restarts": result.restarts,
                "kinds": [a.kind for a in attempts],
            }
        )
        return result


def supervise_command(
    cmd: list[str], cfg: SupervisorConfig, **kwargs
) -> int:
    """Convenience wrapper used by the CLI: run to completion, return the
    exit code for the supervising process."""
    return Supervisor(cmd, cfg, **kwargs).run().exit_code


if __name__ == "__main__":  # minimal manual harness: supervise ARGV
    cfg = SupervisorConfig(hang_timeout_s=float(os.environ.get("HT", "0")))
    sys.exit(supervise_command(sys.argv[1:], cfg))
