"""The port's self-healing fleet (``serving/fleet_supervisor.py``) and
``supervisor.py`` against the JAX package's, with fake spawns and clocks:
each scripted fault runs the JAX package's ``tests/test_fleet_supervisor.py``
scenario through both packages' whole stack — workers over socketpairs, a
router of socket transports, the supervisor with spawn and dial hooks that
mint fresh workers (``tests/torch_fleet.py``) — and the supervisor's event
sequence, the router's stats, the restart records and the greedy tokens
must be equal. Each scenario runs once per module on each side (``_run``).

Covered: crash -> backoff -> restart with the in-flight work retried token
for token, re-warm from the port's spill store, hang -> kill, socket death
-> SIGTERM then SIGKILL after the grace, a preempted worker not restarted,
the backoff schedule, budget exhaustion degrading to the survivors, a
failed respawn counted against the budget, quarantine mid-drain, a restart
during another worker's drain, old-epoch duplicates discarded, and
``classify_exit`` and the training supervisor's backoff equal to JAX's.
"""

import os
import random

import pytest
import torch

from distributeddeeplearning_tpu import supervisor as jax_supervisor
from distributeddeeplearning_tpu.config import (
    SupervisorConfig as JaxSupervisorConfig,
)
from distributeddeeplearning_tpu_torch import supervisor
from distributeddeeplearning_tpu_torch.config import SupervisorConfig
from distributeddeeplearning_tpu_torch.serving.fleet_supervisor import (
    TERM_GRACE_S,
    WorkerHandle,
)
from distributeddeeplearning_tpu_torch.supervisor import (
    CRASH,
    EXIT_FAULT,
    EXIT_PREEMPTED,
    HANG,
)
from torch_fleet import cell_clock, share_jax_programs, sides, submit_all
from torch_fleet import tokens as tokens_of
from torch_serving import prompts

torch.set_num_threads(2)

_MAX_NEW = 9
_CFG = dict(heartbeat_interval_s=0.5, heartbeat_timeout_s=2.0,
            request_retry=True, max_worker_restarts=2,
            restart_backoff_base_s=0.5, restart_backoff_max_s=4.0)


@pytest.fixture(scope="module")
def both():
    undo = share_jax_programs()
    yield sides()
    undo()


class FakeProc:
    """A Popen stand-in whose exit the test scripts by setting ``rc``;
    terminate()/kill() are recorded, not delivered."""

    def __init__(self):
        self.rc = None
        self.signals = []

    def poll(self):
        return self.rc

    def terminate(self):
        self.signals.append("term")

    def kill(self):
        self.signals.append("kill")


class Fleet:
    """One side's self-healing stack on a fake clock: workers over
    socketpairs, a router of socket transports and a FleetSupervisor whose
    spawn and dial hooks mint fresh worker + transport pairs (re-warming
    the spill store when there is one). The jitter is seeded."""

    def __init__(self, side, n, cfg, *, spill_dir=None):
        self.side, self.cfg = side, cfg
        self.t, self.clock = cell_clock()
        self.spill_dir = spill_dir
        self.workers = {}
        self.procs = [FakeProc() for _ in range(n)]
        transports = [self._mint(i) for i in range(n)]
        self.router = side.transports_router(cfg, self.clock, transports)
        self.sup = side.fleet_mod.FleetSupervisor(
            self.router, self.procs, self._spawn, cfg, dial=self._dial,
            clock=self.clock, jitter_rng=random.Random(22))
        self._pending = None

    def _mint(self, i):
        store = (None if self.spill_dir is None
                 else os.path.join(self.spill_dir, f"spill_w{i}.json"))
        w, transport, self._rewarm = self.side.mint_worker(
            i, self.cfg, self.clock, spill_store=store)
        self.workers[i] = w
        return transport

    def _spawn(self, index, attempt):
        self.procs[index] = FakeProc()
        self._pending = self._mint(index)
        return self.procs[index], {"host": "fake", "port": 0,
                                   "spill_rewarm_chains": self._rewarm}

    def _dial(self, index, host, port):
        transport, self._pending = self._pending, None
        return transport

    def kill_worker(self, i, rc, *, close=True):
        """Script a death: the process 'exits' with ``rc`` and (by
        default) its socket drops."""
        w = self.workers[i]
        w.exit_code = rc if w.exit_code is None else w.exit_code
        if close:
            w.conn.close()
        self.procs[i].rc = rc

    def drive(self, *, dt=0.01, max_iters=5000, until=None):
        for _ in range(max_iters):
            self.t[0] += dt
            for w in list(self.workers.values()):
                if w.exit_code is None:
                    w.pump()
            self.router.step()
            self.sup.tick()
            if until is not None and until():
                return None
            if (until is None and self.router.idle
                    and not self.sup.pending_recovery):
                return self.router.finished()
        raise AssertionError("fleet never converged")

    def submit(self, trace, start=0):
        submit_all(self.router, self.side, trace, _MAX_NEW, start=start)

    def summary(self, done=None):
        st = self.router.stats()
        st.pop("per_replica")
        return {"events": self.sup.events, "sup": self.sup.stats(),
                "stats": st, "routes": dict(self.router.routes),
                "tokens": tokens_of(done if done is not None
                                    else self.router.finished()),
                "signals": [p.signals for p in self.procs]}


def _busy0(fleet):
    return lambda: not fleet.router.replicas[0].engine_idle


def _crash(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    fleet.submit(prompts((5, 9, 3, 12, 7, 4)))
    fleet.drive(until=_busy0(fleet))
    fleet.kill_worker(0, EXIT_FAULT)
    fleet.drive(until=lambda: fleet.sup.restarts >= 1)
    return fleet.summary(fleet.drive())


def _rewarm(side, tmp):
    os.makedirs(tmp)
    cfg = side.cfg(spill_blocks=16, prefix_cache=True, suffix_buckets=(4,),
                   spill_checkpoint_every_s=0.01, **_CFG)
    fleet = Fleet(side, 2, cfg, spill_dir=tmp)
    w0 = fleet.workers[0]
    fleet.submit(prompts((8, 8, 8), seed=3), start=0)
    fleet.drive()
    pool = w0.engine.scheduler.pool
    if not pool.spilled_blocks:  # demote every evictable block
        pool.free(pool.alloc(pool.free_blocks + pool.evictable_blocks))
    w0.checkpoint_spill(force=True)
    stored = os.path.exists(os.path.join(tmp, "spill_w0.json"))
    fleet.kill_worker(0, EXIT_FAULT)
    fleet.drive(until=lambda: fleet.sup.restarts >= 1)
    out = fleet.summary(fleet.drive())
    out["stored"] = stored
    return out


def _hang(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    fleet.router.submit(side.Request(prompt=[1, 2, 3], max_new_tokens=6,
                                     request_id=0))
    fleet.workers[0].hung = fleet.workers[1].hung = True
    for _ in range(6):
        fleet.t[0] += _CFG["heartbeat_timeout_s"] / 4.0
        fleet.router.step()
    quarantined = [r.index for r in fleet.router.replicas if r.quarantined]
    fleet.workers[1].hung = False
    fleet.sup.tick()
    kinds = [fleet.sup.handles[i].kind_override for i in quarantined]
    for i in quarantined:
        fleet.kill_worker(i, -9)
    fleet.sup.tick()
    out = fleet.summary()
    out.update(quarantined=quarantined, kinds=kinds,
               last=[fleet.sup.handles[i].last_kind for i in quarantined],
               respawn=[fleet.sup.handles[i].respawn_at is not None
                        for i in quarantined])
    return out


def _socket_death(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    fleet.router.submit(side.Request(prompt=[1, 2, 3], max_new_tokens=4,
                                     request_id=0))
    fleet.workers[0].conn.close()
    fleet.router.step()
    fleet.sup.tick()
    out = {"kind": fleet.sup.handles[0].kind_override,
           "after_tick": list(fleet.procs[0].signals)}
    fleet.t[0] += TERM_GRACE_S + 0.1
    fleet.sup.tick()
    out.update(fleet.summary())
    return out


def _preempted(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    fleet.kill_worker(0, EXIT_PREEMPTED)
    fleet.sup.tick()
    h = fleet.sup.handles[0]
    out = fleet.summary()
    out["handle"] = (h.stopped, h.respawn_at, h.gave_up)
    return out


def _budget(side):
    fleet = Fleet(side, 2, side.cfg(**{**_CFG, "max_worker_restarts": 0}))
    fleet.submit(prompts((5, 9, 3, 12, 7, 4))[:4])
    fleet.drive(until=_busy0(fleet))
    fleet.kill_worker(0, EXIT_FAULT)
    return fleet.summary(fleet.drive())


def _respawn_fails(side):
    fleet = Fleet(side, 1, side.cfg(**{**_CFG, "max_worker_restarts": 1}))

    def bad_spawn(index, attempt):
        raise OSError("spawn refused")

    fleet.sup.spawn = bad_spawn
    fleet.kill_worker(0, EXIT_FAULT)
    fleet.sup.tick()
    h = fleet.sup.handles[0]
    seen = []
    for _ in range(2):
        fleet.t[0] = h.respawn_at + 0.01
        fleet.sup.tick()
        seen.append((h.restarts_done, h.respawn_at is not None, h.gave_up))
    out = fleet.summary()
    out["seen"] = seen
    return out


def _mid_drain(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    fleet.submit(prompts((5, 9, 3, 12, 7)))
    fleet.drive(until=_busy0(fleet))
    fleet.router.drain(0)
    fleet.drive(until=lambda: True)
    fleet.kill_worker(0, EXIT_FAULT)
    out = fleet.summary(fleet.drive())
    out["stopped"] = fleet.sup.handles[0].stopped
    return out


def _other_drains(side):
    fleet = Fleet(side, 2, side.cfg(**_CFG))
    trace = prompts((5, 9, 3, 12, 7, 4))
    fleet.submit(trace[:4])
    fleet.drive(until=_busy0(fleet))
    fleet.kill_worker(0, EXIT_FAULT)
    fleet.router.drain(1)
    fleet.drive(until=lambda: fleet.sup.restarts >= 1)
    fleet.submit(trace[4:], start=4)
    return fleet.summary(fleet.drive())


def _stale_epoch(side):
    import socket

    t, clock = cell_clock()
    rs, far = socket.socketpair()
    rs.setblocking(False)
    far.setblocking(False)
    hello = {"type": "hello", "replica": 0, "block_size": 4, "slots": 3}
    tr = side.serving.SocketReplica(0, rs, hello, clock=clock)
    req = side.Request(prompt=[1, 2, 3], max_new_tokens=4, request_id=7)
    tr.submit_request(req, clock(), epoch=0)
    sent = side.net.recv_available(far, side.net.FrameDecoder())
    side.net.send_frame(far, {"type": "result", "request_id": 7, "epoch": 0,
                              "state": {"arrival_s": clock(),
                                        "generated": [9, 9, 9]}})
    tr._outstanding[7] = (req, clock(), 1)  # retried: the epoch moved on
    tr.step()
    stale = (7 in tr._results, tr.stale_frames)
    side.net.send_frame(far, {"type": "result", "request_id": 7, "epoch": 1,
                              "state": {"arrival_s": clock(),
                                        "generated": [4, 5]}})
    tr.step()
    # Out-of-order heartbeats are dropped and do not refresh liveness.
    for seq in (5, 3, 6):
        t[0] += 1.0
        side.net.send_frame(far, {"type": "heartbeat", "seq": seq,
                                  "gauges": {}})
        tr.step()
    return {"sent": sent, "stale": stale, "final": tr.stale_frames,
            "generated": tr._results[7].generated, "seq": tr.heartbeat_seq,
            "stale_heartbeats": tr.stale_heartbeats,
            "last_heartbeat_s": tr.last_heartbeat_s}


def _dedupe(side):
    t, clock = cell_clock()
    router = side.router(side.cfg(replicas=2, **{**_CFG,
                                                 "heartbeat_timeout_s": 0.0}),
                         clock)
    st = router.submit(side.Request(prompt=[1, 2, 3], max_new_tokens=3,
                                    request_id=0))
    router.run()
    other = router.replicas[1 - router.routes[0]]
    other.engine.scheduler.finished.append(st)  # a forged duplicate
    done = router.finished()
    return {"done": [s.request.request_id for s in done],
            "dups": router.stats()["duplicate_deliveries"]}


def _one_engine(side, trace):
    t, clock = cell_clock()
    eng = side.engine(side.cfg(**{**_CFG, "heartbeat_timeout_s": 0.0}),
                      clock)
    submit_all(eng, side, trace, _MAX_NEW)
    return tokens_of(eng.run())


_SCENARIOS = {
    "crash": _crash, "hang": _hang, "socket_death": _socket_death,
    "preempted": _preempted, "budget": _budget,
    "respawn_fails": _respawn_fails, "mid_drain": _mid_drain,
    "other_drains": _other_drains, "stale_epoch": _stale_epoch,
    "dedupe": _dedupe,
    "one_engine": lambda s: _one_engine(s, prompts((5, 9, 3, 12, 7, 4))),
}
_CACHE = {}


def _run(both, name):
    if name not in _CACHE:
        _CACHE[name] = tuple(_SCENARIOS[name](side) for side in both)
    return _CACHE[name]


@pytest.mark.parametrize("name", ["crash", "hang", "socket_death",
                                  "preempted", "budget", "respawn_fails",
                                  "mid_drain", "other_drains", "stale_epoch",
                                  "dedupe"])
def test_fleet_supervisor_matches_jax(both, name):
    jx, pt = _run(both, name)
    assert pt == jx


def _equal_one_engine(both, out):
    _, one = _run(both, "one_engine")
    assert out["tokens"] == {k: one[k] for k in out["tokens"]}


def test_crash_restart_retries_inflight_token_identically(both):
    _, pt = _run(both, "crash")
    _equal_one_engine(both, pt)
    assert len(pt["tokens"]) == 6
    st = pt["stats"]
    assert st["duplicate_deliveries"] == 0 and st["failed"] == 0
    assert st["retried"] + st["rerouted"] >= 1
    assert pt["sup"]["restarts"] == 1
    assert pt["sup"]["per_worker"][0]["last_kind"] == "fault"
    assert [e["event"] for e in pt["events"]] == [
        "worker_exit", "worker_restart_scheduled", "worker_restarted"]


def test_restarted_worker_rewarms_from_the_spill_store(both, tmp_path):
    jx, pt = (_rewarm(side, str(tmp_path / side.name)) for side in both)
    assert pt["stored"]
    (rec,) = pt["sup"]["restart_records"]
    assert rec["replica"] == 0 and rec["spill_rewarm_chains"] > 0
    assert rec["recovery_s"] >= 0.0
    assert pt["sup"]["restart_records"] == jx["sup"]["restart_records"]
    assert pt["events"] == jx["events"]
    assert pt["tokens"] == jx["tokens"]


def test_hang_is_killed_and_socket_death_gets_term_then_kill(both):
    _, hang = _run(both, "hang")
    assert hang["quarantined"] and all(k == HANG for k in hang["kinds"])
    assert all(hang["signals"][i] == ["kill"] for i in hang["quarantined"])
    assert hang["last"] == [HANG] * len(hang["quarantined"])
    assert all(hang["respawn"])
    _, death = _run(both, "socket_death")
    assert death["kind"] == CRASH and death["after_tick"] == ["term"]
    assert death["signals"][0] == ["term", "kill"]


def test_preempted_worker_is_not_restarted(both):
    _, pt = _run(both, "preempted")
    assert pt["handle"] == (True, None, False)
    assert [e["event"] for e in pt["events"]] == ["worker_exit"]


def test_budget_exhaustion_degrades_to_the_survivors(both):
    _, pt = _run(both, "budget")
    assert pt["sup"]["gave_up"] == [0] and pt["sup"]["restarts"] == 0
    assert "worker_give_up" in [e["event"] for e in pt["events"]]
    assert len(pt["tokens"]) == 4
    _equal_one_engine(both, pt)


def test_failed_respawns_count_against_the_budget(both):
    _, pt = _run(both, "respawn_fails")
    assert pt["seen"] == [(1, True, False), (2, False, True)]
    names = [e["event"] for e in pt["events"]]
    assert names.count("worker_respawn_failed") == 1
    assert names.count("worker_give_up") == 1


def test_drain_interleavings_complete_exactly_once(both):
    _, mid = _run(both, "mid_drain")
    assert mid["stopped"] and len(mid["tokens"]) == 5
    _equal_one_engine(both, mid)
    _, other = _run(both, "other_drains")
    assert len(other["tokens"]) == 6 and other["sup"]["restarts"] == 1
    assert [other["routes"][j] for j in (4, 5)] == [0, 0]
    _equal_one_engine(both, other)
    for out in (mid, other):
        assert out["stats"]["duplicate_deliveries"] == 0


def test_old_epoch_results_and_late_heartbeats_are_discarded(both):
    _, pt = _run(both, "stale_epoch")
    assert pt["sent"][-1]["op"] == "submit" and pt["sent"][-1]["epoch"] == 0
    assert pt["stale"] == (False, 1) and pt["final"] == 1
    assert pt["generated"] == [4, 5]
    assert pt["seq"] == 6 and pt["stale_heartbeats"] == 1
    _, dedupe = _run(both, "dedupe")
    assert dedupe == {"done": [0], "dups": 1}


def test_backoff_schedule_doubles_and_caps():
    class NoJitter:
        def random(self):
            return 0.0

    jfs = __import__("distributeddeeplearning_tpu.serving.fleet_supervisor",
                     fromlist=["FleetSupervisor"]).FleetSupervisor
    from distributeddeeplearning_tpu_torch.serving.fleet_supervisor import (
        FleetSupervisor,
    )

    class Cfg:
        max_worker_restarts, restart_backoff_base_s = 2, 0.5
        restart_backoff_max_s = 4.0

    class Router:
        replicas = []

    for cls in (FleetSupervisor, jfs):
        sup = cls(Router(), [], None, Cfg(), jitter_rng=NoJitter())
        assert [sup.backoff_s(i) for i in (0, 1, 2, 10)] == pytest.approx(
            [0.5, 1.0, 2.0, 4.0])
    seeded = [cls(Router(), [], None, Cfg(), jitter_rng=random.Random(5))
              for cls in (FleetSupervisor, jfs)]
    assert ([seeded[0].backoff_s(i) for i in range(6)]
            == [seeded[1].backoff_s(i) for i in range(6)])
    h = WorkerHandle(3)
    assert h.supervising and h.attempt == 0 and h.respawn_at is None
    h.gave_up = True
    assert not h.supervising


@pytest.mark.parametrize("rc", [0, 1, -9, 2, 17, 21, 137, 143])
def test_classify_exit_equals_jax(rc):
    assert supervisor.classify_exit(rc) == jax_supervisor.classify_exit(rc)
    assert (supervisor.EXIT_FAULT, supervisor.EXIT_PREEMPTED) == (
        jax_supervisor.EXIT_FAULT, jax_supervisor.EXIT_PREEMPTED)


def test_training_supervisor_backoff_equals_jax():
    kw = dict(backoff_base_s=0.3, backoff_factor=2.0, backoff_max_s=5.0,
              backoff_jitter=0.25)
    ours = supervisor.Supervisor(["true"], SupervisorConfig(**kw),
                                 jitter_rng=random.Random(9))
    theirs = jax_supervisor.Supervisor(["true"], JaxSupervisorConfig(**kw),
                                       jitter_rng=random.Random(9))
    assert ([ours.backoff_s(i) for i in range(8)]
            == [theirs.backoff_s(i) for i in range(8)])
