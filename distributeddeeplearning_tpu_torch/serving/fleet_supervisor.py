"""Self-healing supervision for the serving fleet.

Without it, ``cli serve --fleet N`` would spawn N worker processes and
hope: a worker that crashed or wedged would stay quarantined forever —
capacity permanently lost, its in-flight requests dead. This module
carries the training supervisor's discipline (``supervisor.py``) to the
serving tier: the fleet parent becomes a control loop that
detects worker death, classifies it, and restarts the worker with its
KV cache warm — while the router keeps serving on the survivors the
whole time.

**Detection** happens three ways, all folded into one path:

- *child exit*: ``proc.poll()`` returns a code → ``classify_exit``
  (``supervisor.py``'s taxonomy verbatim: 0 clean, ``EXIT_PREEMPTED`` preempted,
  ``EXIT_FAULT`` fault, anything else crash);
- *socket EOF/RST*: the router's pump raises ``ProtocolError`` and
  quarantines the replica — the supervisor sees ``quarantined`` with
  the process still alive and escalates SIGTERM → SIGKILL;
- *stale heartbeat*: the router's ``check_heartbeats`` sweep
  quarantines on ``StaleHeartbeat`` — a wedged process that reads
  nothing and says nothing. The supervisor classifies that HANG and
  SIGKILLs immediately (a hung worker by definition ignores SIGTERM's
  drain contract).

**Restart** follows the training supervisor's schedule: exponential
backoff with jitter (``serving.restart_backoff_base_s`` doubling up to
``restart_backoff_max_s``), at most ``serving.max_worker_restarts``
times per worker. The respawn is NON-BLOCKING — ``respawn_at`` is a
deadline the tick loop checks, so the survivors keep serving through
every backoff window. A restarted worker re-warms its KV spill tier
from the ``--spill-store`` file its predecessor checkpointed
(``ReplicaWorker.checkpoint_spill``: periodic cadence + clean-drain
save), so it rejoins with its prefix cache warm instead of cold. Once
a worker's budget is exhausted the fleet DEGRADES — ``worker_give_up``
event, capacity stays down, the router keeps serving on whoever is
left. A preempted exit (``EXIT_PREEMPTED``) is never restarted: that
is the platform reclaiming the slot, same contract as training.

**Request semantics** across a failure are at-most-once, implemented
router-side (serving/router.py) and merely sequenced from here: the
dead worker's socket is pumped one last time to harvest any result
frames it pushed before dying (completed work is never re-run), then
the quarantine path retries in-flight requests on a survivor under a
bumped attempt epoch and reroutes queued ones. Late frames from a
half-dead worker carry the old epoch and are discarded — never
double-delivered. ``chip_smoke.py`` drives ``worker_crash`` through this
machinery on the card and pins exactly-once accounting and token parity
against an undisturbed run.

Everything is injectable — ``spawn``, ``dial``, ``clock``, ``kill`` —
so tests/test_torch_fleet_supervisor.py runs the whole state machine on a
fake clock over socketpairs, no subprocesses and no wall time.
"""

from __future__ import annotations

import random
import time

from ..metrics import event_record
from ..supervisor import (
    CRASH,
    HANG,
    PREEMPTED,
    classify_exit,
)
from ..telemetry import NULL_TELEMETRY
from .router import StaleHeartbeat, dial_worker

#: Seconds a SIGTERMed worker gets to drain before SIGKILL escalation.
TERM_GRACE_S = 10.0


class WorkerDied(RuntimeError):
    """Supervisor-detected worker death (child exit or escalation kill)
    — the exception handed to the router's quarantine path so the
    replica's error string names what actually happened."""


class WorkerHandle:
    """Supervisor-side state for one fleet worker slot."""

    def __init__(self, index: int, proc=None):
        self.index = int(index)
        self.proc = proc
        #: Respawn attempts performed (== the DDL_WORKER_ATTEMPT the
        #: current process was launched with).
        self.attempt = 0
        self.restarts_done = 0
        #: Non-blocking backoff deadline; None = not waiting to respawn.
        self.respawn_at: float | None = None
        #: Exit kind decided by the monitor before the process died
        #: (HANG from a stale heartbeat, CRASH from a dead socket) —
        #: overrides classify_exit, which would see only the -9.
        self.kind_override: str | None = None
        #: SIGKILL escalation deadline after a SIGTERM (None = not
        #: escalating).
        self.term_deadline: float | None = None
        self.death_s: float | None = None
        self.last_kind: str | None = None
        self.gave_up = False
        self.stopped = False  # expected exit (shutdown/preemption)

    @property
    def supervising(self) -> bool:
        return not (self.gave_up or self.stopped)


class FleetSupervisor:
    """The ``serve --fleet`` parent's control loop body.

    ``router`` is a live :class:`~.router.ReplicaRouter` over socket
    transports; ``procs`` the Popen-like children aligned by replica
    index; ``spawn(index, attempt)`` relaunches one worker and returns
    ``(proc, ready)`` where ``ready`` is its parsed ``worker_ready``
    line; ``dial(index, host, port)`` connects and handshakes a
    replacement transport (defaults to :func:`~.router.dial_worker`).
    Drive it by calling :meth:`tick` after every ``router.step()`` —
    :meth:`run` is the canonical loop.
    """

    def __init__(self, router, procs, spawn, cfg, *,
                 dial=None, clock=time.monotonic,
                 kill=None, emit=None, jitter_rng=None,
                 telemetry=NULL_TELEMETRY,
                 term_grace_s: float = TERM_GRACE_S):
        self.router = router
        self.spawn = spawn
        self.dial = dial if dial is not None else (
            lambda index, host, port: dial_worker(
                index, host, port, clock=clock
            )
        )
        self.clock = clock
        self.kill = kill if kill is not None else self._kill_process
        self.telemetry = telemetry
        self.term_grace_s = float(term_grace_s)
        self.max_restarts = int(getattr(cfg, "max_worker_restarts", 0))
        self.backoff_base_s = float(
            getattr(cfg, "restart_backoff_base_s", 0.5)
        )
        self.backoff_max_s = float(
            getattr(cfg, "restart_backoff_max_s", 15.0)
        )
        self._rng = jitter_rng if jitter_rng is not None else (
            random.Random()
        )
        self.events: list[dict] = []
        self._emit = emit if emit is not None else self.events.append
        self.handles = [
            WorkerHandle(i, proc) for i, proc in enumerate(procs)
        ]
        self.restarts = 0  # fleet-wide total
        #: Per-restart records: replica, kind, backoff, recovery_s
        #: (death detected -> replacement serving) — what the chaos
        #: harness pins its bounded-recovery claim on.
        self.restart_records: list[dict] = []
        self.shutting_down = False

    # -- backoff -----------------------------------------------------------

    def backoff_s(self, restart_index: int) -> float:
        """Training-supervisor schedule: base doubling per restart,
        capped, +0-10% jitter so N workers killed by one event do not
        respawn in lockstep."""
        base = min(
            self.backoff_base_s * (2.0 ** restart_index),
            self.backoff_max_s,
        )
        return base * (1.0 + 0.1 * self._rng.random())

    # -- detection ---------------------------------------------------------

    @staticmethod
    def _kill_process(proc, sig_kind: str) -> None:
        """Default process killer: 'term' → SIGTERM (drain contract),
        'kill' → SIGKILL (hang escalation)."""
        try:
            if sig_kind == "term":
                proc.terminate()
            else:
                proc.kill()
        except OSError:
            pass

    def tick(self) -> None:
        """One supervision pass: detect deaths, escalate kills, fire
        due respawns. Non-blocking — call it between router steps."""
        for h in self.handles:
            if not h.supervising:
                continue
            if h.respawn_at is not None:
                if self.clock() >= h.respawn_at:
                    self._respawn(h)
                continue
            rc = h.proc.poll() if h.proc is not None else None
            if rc is not None:
                self._on_death(h, h.kind_override or classify_exit(rc),
                               rc)
                continue
            replica = self.router.replicas[h.index]
            if replica.quarantined and h.kind_override is None:
                # Router-detected death with the process still alive:
                # stale heartbeat means wedged (SIGTERM's drain contract
                # is exactly what a hung worker cannot honor — SIGKILL
                # now); a protocol fault means the socket died under a
                # live process — SIGTERM first, escalate on the grace
                # deadline.
                if StaleHeartbeat.__name__ in (replica.error or ""):
                    h.kind_override = HANG
                    self.kill(h.proc, "kill")
                else:
                    h.kind_override = CRASH
                    self.kill(h.proc, "term")
                    h.term_deadline = self.clock() + self.term_grace_s
            elif (h.term_deadline is not None
                    and self.clock() >= h.term_deadline):
                self.kill(h.proc, "kill")
                h.term_deadline = None

    # -- death -> backoff -> respawn ---------------------------------------

    def _on_death(self, h: WorkerHandle, kind: str, rc: int) -> None:
        h.last_kind = kind
        h.death_s = self.clock()
        h.term_deadline = None
        # Harvest first: result frames the worker pushed before dying
        # are completed work — fold them in so the quarantine path never
        # retries a request that already resolved. step_replica runs the
        # quarantine itself if the pump hits EOF with work outstanding.
        self.router.step_replica(h.index)
        self.router.quarantine_replica(h.index, WorkerDied(
            f"worker {h.index} died: kind={kind} rc={rc}"
        ))
        self._emit(event_record(
            "worker_exit", self.router.tick_count,
            replica=h.index, kind=kind, rc=rc, attempt=h.attempt,
            role=getattr(
                self.router.replicas[h.index], "role", "unified"
            ),
        ))
        expected = (
            self.shutting_down
            or kind == PREEMPTED
            or self.router.replicas[h.index].draining
        )
        if expected:
            h.stopped = True
            return
        if h.restarts_done >= self.max_restarts:
            h.gave_up = True
            self._emit(event_record(
                "worker_give_up", self.router.tick_count,
                replica=h.index, restarts=h.restarts_done, kind=kind,
            ))
            self.telemetry.count("worker_give_up")
            return
        backoff = self.backoff_s(h.restarts_done)
        h.respawn_at = self.clock() + backoff
        self._emit(event_record(
            "worker_restart_scheduled", self.router.tick_count,
            replica=h.index, kind=kind,
            backoff_s=round(backoff, 6), attempt=h.attempt + 1,
        ))
        self.telemetry.count("worker_deaths")

    def _respawn(self, h: WorkerHandle) -> None:
        h.respawn_at = None
        h.kind_override = None
        next_attempt = h.attempt + 1
        try:
            proc, ready = self.spawn(h.index, next_attempt)
            transport = self.dial(
                h.index, ready["host"], ready["port"]
            )
        except Exception as exc:  # noqa: BLE001 — a failed respawn is
            # one more strike against the budget, not a router crash.
            h.restarts_done += 1
            if h.restarts_done > self.max_restarts:
                h.gave_up = True
                self._emit(event_record(
                    "worker_give_up", self.router.tick_count,
                    replica=h.index, restarts=h.restarts_done,
                    error=f"{type(exc).__name__}: {exc}",
                ))
                self.telemetry.count("worker_give_up")
            else:
                backoff = self.backoff_s(h.restarts_done)
                h.respawn_at = self.clock() + backoff
                self._emit(event_record(
                    "worker_respawn_failed", self.router.tick_count,
                    replica=h.index,
                    error=f"{type(exc).__name__}: {exc}",
                    backoff_s=round(backoff, 6),
                ))
            return
        h.proc = proc
        h.attempt = next_attempt
        h.restarts_done += 1
        self.restarts += 1
        self.router.replace_replica(h.index, transport)
        recovery_s = (
            self.clock() - h.death_s if h.death_s is not None else 0.0
        )
        rec = {
            "replica": h.index,
            "attempt": h.attempt,
            "kind": h.last_kind,
            # The respawn plan is per-index (cli._fleet_plan), so a
            # restarted worker rejoins with its predecessor's ROLE — a
            # dead prefill replica comes back prefill.
            "role": str(ready.get("role", "unified")),
            "recovery_s": round(recovery_s, 6),
            "spill_rewarm_chains": int(
                ready.get("spill_rewarm_chains", 0)
            ),
        }
        self.restart_records.append(rec)
        self._emit(event_record(
            "worker_restarted", self.router.tick_count, **rec,
        ))
        self.telemetry.count("worker_restarts")
        self.telemetry.flight_dump("worker_restart", **rec)

    # -- lifecycle ---------------------------------------------------------

    @property
    def pending_recovery(self) -> bool:
        """True while any worker is between death and rejoin (backoff
        window or kill escalation) — the run loop must keep ticking
        even when the router reads idle, or a respawn due in 2s would
        never fire."""
        return any(
            h.supervising and (h.respawn_at is not None
                               or h.kind_override is not None)
            for h in self.handles
        )

    def run(self, *, max_wall_s: float = 0.0,
            idle_sleep=None) -> list:
        """Drive router + supervision to completion: returns
        ``router.finished()`` once every submitted request resolved and
        no recovery is in flight. ``max_wall_s`` bounds the loop (0 =
        unbounded); ``idle_sleep`` (injectable) runs when nothing moved
        so a backoff wait does not hot-spin."""
        deadline = (
            self.clock() + max_wall_s if max_wall_s > 0 else None
        )
        while True:
            busy = self.router.step()
            self.tick()
            if not busy and not self.pending_recovery \
                    and self.router.idle:
                break
            if deadline is not None and self.clock() > deadline:
                break
            if not busy and idle_sleep is not None:
                idle_sleep()
        return self.router.finished()

    def shutdown(self, *, wait_s: float = 5.0) -> None:
        """Expected-exit teardown: mark every slot stopped-on-purpose
        (so clean exits are not 'recovered'), then run the router's
        polite fleet shutdown."""
        self.shutting_down = True
        self.router.shutdown_fleet(wait_s=wait_s)

    def stats(self) -> dict:
        return {
            "max_worker_restarts": self.max_restarts,
            "restarts": self.restarts,
            "gave_up": [h.index for h in self.handles if h.gave_up],
            "per_worker": [
                {"replica": h.index, "attempt": h.attempt,
                 "role": getattr(
                     self.router.replicas[h.index], "role", "unified"
                 ),
                 "restarts": h.restarts_done,
                 "last_kind": h.last_kind,
                 "gave_up": h.gave_up, "stopped": h.stopped}
                for h in self.handles
            ],
            "restart_records": list(self.restart_records),
        }
